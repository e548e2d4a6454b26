"""pkg/offline: tracer-only runs driven by stored circulation fields.

Reference: pkg/offline/offline_fields_load.F, offline_get_diffus.F,
offline_readparms.F, offline_reset_parms.F.  Each timestep the
prognostic ocean state (uVel, vVel, wVel, theta, salt) is REPLACED by
the time-interpolation of two stored records (periodic cycle, the
GET_PERIODIC_INTERVAL weights), the convective-adjustment index
IVDConvCount and the GM-Redi tensor components Kwx/Kwy/Kwz are loaded
the same way, and temp/salt/mom stepping are all switched off
(offline_reset_parms.F:23-25) so only passive tracers evolve.

Design: all records of every field are pre-loaded into [nRec, ...]
stacks at experiment construction (the verification decks hold 12
monthly records of a 128x64x15 domain — a few MB); the per-step record
selection is a traced gather + linear blend inside the jitted step, so
the whole offline run compiles to a single XLA program with no host
I/O on the hot path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core.config import Config


_FILE_KEYS = {
    "uvelfile": "uvel", "vvelfile": "vvel", "wvelfile": "wvel",
    "thetfile": "thet", "saltfile": "salt", "convfile": "conv",
    "gmwxfile": "gmwx", "gmwyfile": "gmwy", "gmwzfile": "gmwz",
    "hfluxfile": "hflux", "sfluxfile": "sflux",
    "kpp_diffsfile": "kppdiffs", "kpp_ghatkfile": "kppghat",
}


@dataclass
class OfflineParams:
    """data.off OFFLINE_PARM01/PARM02 (offline_readparms.F)."""
    files: dict = field(default_factory=dict)
    offlineIter0: int = 0
    deltaToffline: float = 0.0       # defaults to deltaTClock
    offlineForcingPeriod: float = 0.0  # defaults to externForcingPeriod
    offlineForcingCycle: float = 0.0   # defaults to externForcingCycle
    offlineTimeOffset: float = 0.0
    offlineLoadPrec: int = 32


def params_from_namelists(cfg: Config, nl1: dict, nl2: dict) -> OfflineParams:
    p = OfflineParams()
    g = {k.lower(): v for k, v in {**nl1, **nl2}.items()}
    for key, name in _FILE_KEYS.items():
        v = str(g.get(key, "")).strip()
        if v:
            p.files[name] = v
    p.offlineIter0 = int(g.get("offlineiter0", 0))
    p.deltaToffline = float(g.get("deltatoffline", cfg.deltaTClock))
    p.offlineForcingPeriod = float(
        g.get("offlineforcingperiod", cfg.externForcingPeriod))
    p.offlineForcingCycle = float(
        g.get("offlineforcingcycle", cfg.externForcingCycle))
    p.offlineTimeOffset = float(g.get("offlinetimeoffset", 0.0))
    p.offlineLoadPrec = int(g.get("offlineloadprec", 32))
    return p


class Offline:
    """Pre-loaded offline record stacks + per-step interpolation."""

    def __init__(self, cfg: Config, p: OfflineParams, run_dir: str,
                 fill3d, fill_uv3d=None, dtype=jnp.float64):
        # fill_uv3d: vector halo exchange for (u,v) pairs — only differs
        # from the scalar fill on multi-face (cubed-sphere) layouts;
        # defaults to the scalar fill (lat-lon offline decks)
        from mitgcm_tpu.io import mds
        self.cfg = cfg
        self.p = p
        nrec = int(round(p.offlineForcingCycle / p.offlineForcingPeriod))
        self.nrec = nrec
        ifprd = int(round(p.offlineForcingPeriod / p.deltaToffline))
        gx = cfg.nx
        gy = cfg.nFaces * cfg.ny
        prec = ">f4" if p.offlineLoadPrec == 32 else ">f8"

        self.missing = set()

        def read_stack(stem):
            # the verification decks commit only the record files their
            # short run actually gathers; absent records load as zeros
            # and are tracked in self.missing (never selected as long
            # as the run stays inside the committed time window)
            recs = []
            for n in range(1, nrec + 1):
                it = n * ifprd + p.offlineIter0
                fn = stem if os.path.isabs(stem) else os.path.join(
                    run_dir, stem)
                path = f"{fn}.{it:010d}"
                found = None
                for cand in (path + ".data", path):
                    if os.path.exists(cand):
                        found = cand
                        break
                if found is None:
                    self.missing.add(n - 1)
                    recs.append(np.zeros((cfg.nr, gy, gx)))
                    continue
                raw = mds.read_raw(found, (cfg.nr, gy, gx), prec)
                recs.append(np.asarray(raw, np.float64))
            return np.stack(recs)              # [nrec, nr, gy, gx]

        if fill_uv3d is None:
            fill_uv3d = lambda a, kind=None: fill3d(a)  # noqa: E731
        self.stacks = {}
        for name, stem in p.files.items():
            st = read_stack(stem)
            if name in ("uvel", "vvel"):
                arr = np.stack([np.asarray(fill_uv3d(st[n],
                                                     kind=name[0]))
                                for n in range(nrec)])
            else:
                arr = np.stack([np.asarray(fill3d(st[n]))
                                for n in range(nrec)])
            self.stacks[name] = jnp.asarray(arr, dtype)

    # ------------------------------------------------------------------
    def weights(self, myTime):
        """GET_PERIODIC_INTERVAL (cyclic branch) record indices/weights:
        0-based recs; locTime = t - offset - period/2 (+2 cycles)."""
        p = self.p
        per = p.offlineForcingPeriod
        cyc = p.offlineForcingCycle
        t = myTime - p.offlineTimeOffset
        locTime = t - per * 0.5 + cyc * (
            2.0 - jnp.round(t / cyc))
        tmpTime = jnp.mod(locTime, cyc)
        rec0 = jnp.floor(tmpTime / per).astype(jnp.int32)      # 0-based
        rec1 = jnp.mod(rec0 + 1, self.nrec)
        aW = (tmpTime - per * rec0) / per
        bW = 1.0 - aW
        return rec0, rec1, bW, aW

    def fields_at(self, myTime):
        """dict of interpolated fields present in this run."""
        rec0, rec1, bW, aW = self.weights(myTime)
        out = {}
        for name, st in self.stacks.items():
            out[name] = (bW * jnp.take(st, rec0, axis=0)
                         + aW * jnp.take(st, rec1, axis=0))
        return out

    def gm_tensor(self, fields, grid):
        """Loaded GM tensor (offline_get_diffus.F:86-103): Kwx/Kwy/Kwz
        from files, constant untapered diagonal (GM_NON_UNITY_DIAGONAL
        undef in the offline decks' GMREDI_OPTIONS.h)."""
        if "gmwx" not in fields:
            return None
        from mitgcm_tpu.model.gmredi import GMTensor
        gm = self.cfg.gmredi
        isoK = gm.resolved_isopycK() if gm is not None else 0.0
        return GMTensor(Kux=jnp.asarray(isoK), Kvy=jnp.asarray(isoK),
                        Kwx=fields["gmwx"], Kwy=fields["gmwy"],
                        Kwz=fields["gmwz"])
