"""Diagnostics manager (reference: pkg/diagnostics).

Parses `data.diagnostics` (DIAGNOSTICS_LIST output streams +
DIAG_STATIS_PARMS statistics streams), computes runtime-registered
diagnostic fields from the model state, accumulates time averages, and
writes MDS files (`<fileName>.<iter10>.data/.meta`) that
MITgcmutils-compatible readers load, plus ASCII per-level statistics
files mirroring diagstats_output.F.

Design: field computation is a plain JAX function over the
state pytree (jit-compiled once per stream), accumulation is a
host-side running sum driven by the python run() loop — diagnostics are
an IO concern and deliberately stay off the lax.scan bench path.

Reference anatomy: diagnostics_readparms.F (namelist), diagnostics_fill.F
(runtime fill calls), diagnostics_out.F / diagstats_output.F (output).
Only a curated subset of the reference's ~500 available diagnostics is
registered; unknown names are reported once and skipped (the reference
prints a warning and drops them too, diagnostics_init_early.F).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from mitgcm_tpu.core import nml
from mitgcm_tpu.io import mds


# ----------------------------------------------------------------------
# field registry: name -> (nlevels 'nr'|1, compute(exp, state) -> array)
# computed on the full halo'd arrays; the manager slices the interior.
# ----------------------------------------------------------------------

def _rho_anom(exp, state):
    from mitgcm_tpu.ops import eos
    rho = eos.find_rho(exp.cfg, exp.grid, state.theta, state.salt,
                       totPhiHyd=state.totPhiHyd)
    return (rho - exp.cfg.rhoConst) * exp.grid.maskC


def _drhodr(exp, state):
    """d(rho)/dr at upper interfaces (diagnostics 'DRHODR')."""
    from mitgcm_tpu.ops import eos
    cfg, grid = exp.cfg, exp.grid
    rho = eos.find_rho(cfg, grid, state.theta, state.salt,
                       totPhiHyd=state.totPhiHyd)
    rho_km1 = jnp.concatenate([rho[:1], rho[:-1]], axis=0)
    m = grid.maskC * jnp.concatenate(
        [jnp.zeros_like(grid.maskC[:1]), grid.maskC[:-1]], axis=0)
    out = (rho - rho_km1) * grid.recip_drC[:exp.cfg.nr, None, None] \
        * cfg.rkSign * m
    return out.at[0].set(0.0)


def _phihyd(exp, state):
    return state.totPhiHyd * exp.grid.maskC


REGISTRY = {
    # 2-D surface fields
    "ETAN": (1, lambda e, s: s.etaN * e.grid.maskInC),
    "ETANSQ": (1, lambda e, s: (s.etaN * s.etaN) * e.grid.maskInC),
    "DETADT2": (1, lambda e, s: (s.dEtaHdt * s.dEtaHdt) * e.grid.maskInC),
    "oceTAUX": (1, lambda e, s: _rec0(e.forcing.fu) * e.grid.maskW[0]),
    "oceTAUY": (1, lambda e, s: _rec0(e.forcing.fv) * e.grid.maskS[0]),
    "TFLUX": (1, lambda e, s: -_rec0(e.forcing.Qnet) * e.grid.maskC[0]),
    "SFLUX": (1, lambda e, s: -_rec0(e.forcing.saltFlux) * e.grid.maskC[0]),
    # 3-D state
    "UVEL": ("nr", lambda e, s: s.uVel * e.grid.maskW),
    "VVEL": ("nr", lambda e, s: s.vVel * e.grid.maskS),
    "WVEL": ("nr", lambda e, s: s.wVel * e.grid.maskC),
    "THETA": ("nr", lambda e, s: s.theta * e.grid.maskC),
    "SALT": ("nr", lambda e, s: s.salt * e.grid.maskC),
    "UVELSQ": ("nr", lambda e, s: (s.uVel * s.uVel) * e.grid.maskW),
    "VVELSQ": ("nr", lambda e, s: (s.vVel * s.vVel) * e.grid.maskS),
    "WVELSQ": ("nr", lambda e, s: (s.wVel * s.wVel) * e.grid.maskC),
    "THETASQ": ("nr", lambda e, s: (s.theta * s.theta) * e.grid.maskC),
    "SALTSQ": ("nr", lambda e, s: (s.salt * s.salt) * e.grid.maskC),
    "UVELMASS": ("nr", lambda e, s: s.uVel * e.grid.hFacW),
    "VVELMASS": ("nr", lambda e, s: s.vVel * e.grid.hFacS),
    "UTHMASS": ("nr", lambda e, s: s.uVel * e.grid.hFacW
                * 0.5 * (s.theta + _shx(s.theta))),
    "VTHMASS": ("nr", lambda e, s: s.vVel * e.grid.hFacS
                * 0.5 * (s.theta + _shy(s.theta))),
    "USLTMASS": ("nr", lambda e, s: s.uVel * e.grid.hFacW
                 * 0.5 * (s.salt + _shx(s.salt))),
    "VSLTMASS": ("nr", lambda e, s: s.vVel * e.grid.hFacS
                 * 0.5 * (s.salt + _shy(s.salt))),
    "PHIHYD": ("nr", _phihyd),
    "RHOAnoma": ("nr", _rho_anom),
    "DRHODR": ("nr", _drhodr),
    # pkg/seaice state diagnostics (seaice_diagnostics_init.F)
    "SIarea": (1, lambda e, s: s.siAREA),
    "SIheff": (1, lambda e, s: s.siHEFF),
    "SIhsnow": (1, lambda e, s: s.siHSNOW),
    "SIhsalt": (1, lambda e, s: s.siHSALT),
    "SIuice": (1, lambda e, s: s.uIce),
    "SIvice": (1, lambda e, s: s.vIce),
}


def _rec0(f):
    return f[0] if f.ndim == 3 else f


def _shx(t):
    from mitgcm_tpu.ops.stencil import shift as sh
    return sh(t, di=-1)


def _shy(t):
    from mitgcm_tpu.ops.stencil import shift as sh
    return sh(t, dj=-1)


# ----------------------------------------------------------------------

@dataclass
class DiagStream:
    fname: str
    fields: List[str]
    freq: float                 # >0 time-average, <0 snapshot
    phase: float = 0.0
    levels: Optional[List[int]] = None   # 1-based model levels


@dataclass
class StatStream:
    fname: str
    fields: List[str]
    freq: float
    phase: float = 0.0


def _collect_indexed(group: dict, base: str) -> Dict[int, object]:
    """Gather 'name(...)' namelist entries: fileName(3), fields(1:7,4)...
    Returns {stream_index: value-or-list}."""
    out: Dict[int, list] = {}
    for key, val in group.items():
        k = key.lower()
        if not k.startswith(base.lower() + "("):
            continue
        inside = k[len(base) + 1:k.rindex(")")]
        parts = inside.split(",")
        idx = int(parts[-1])
        lst = out.setdefault(idx, [])
        if isinstance(val, (list, tuple)):
            lst.extend(val)
        else:
            lst.append(val)
    return out


class Diagnostics:
    """Manager bound to an Experiment; drive via step(myTime, myIter)."""

    def __init__(self, exp, streams: List[DiagStream],
                 stats: List[StatStream], out_dir: str = "."):
        self.exp = exp
        self.out_dir = out_dir
        self.streams = []
        self.stats = []
        self._warned: set = set()
        for st in streams:
            known = [f for f in st.fields if f in REGISTRY]
            for f in st.fields:
                if f not in REGISTRY and f not in self._warned:
                    self._warned.add(f)
            if known and st.freq != 0.0:
                self.streams.append(DiagStream(st.fname, known, st.freq,
                                               st.phase, st.levels))
        for st in stats:
            known = [f for f in st.fields if f in REGISTRY]
            if known and st.freq != 0.0:
                self.stats.append(StatStream(st.fname, known, st.freq,
                                             st.phase))
        # accumulators per time-average stream
        self._acc: Dict[str, Dict[str, np.ndarray]] = {}
        self._cnt: Dict[str, int] = {}
        if self._warned:
            import sys
            print("diagnostics: unregistered fields skipped:",
                  sorted(self._warned), file=sys.stderr)

    # -- parsing -------------------------------------------------------
    @classmethod
    def from_file(cls, exp, path: str, out_dir: str = ".") -> "Diagnostics":
        groups = nml.read_namelist(path)
        dl = groups.get("DIAGNOSTICS_LIST", {})
        fields_by = _collect_indexed(dl, "fields")
        fname_by = _collect_indexed(dl, "fileName")
        freq_by = _collect_indexed(dl, "frequency")
        phase_by = _collect_indexed(dl, "timePhase")
        levels_by = _collect_indexed(dl, "levels")
        streams = []
        for n in sorted(fields_by):
            flds = [str(f).strip() for f in fields_by[n]]
            fname = str(fname_by.get(n, [f"diagout{n:02d}"])[0]).strip()
            freq = float(freq_by.get(n, [0.0])[0])
            phase = float(phase_by.get(n, [0.0])[0])
            levels = levels_by.get(n)
            if levels is not None:
                levels = [int(float(v)) for v in levels]
            streams.append(DiagStream(fname, flds, freq, phase, levels))
        sp = groups.get("DIAG_STATIS_PARMS", {})
        sfields = _collect_indexed(sp, "stat_fields")
        sfname = _collect_indexed(sp, "stat_fName")
        sfreq = _collect_indexed(sp, "stat_freq")
        sphase = _collect_indexed(sp, "stat_phase")
        stats = []
        for n in sorted(sfields):
            stats.append(StatStream(
                str(sfname.get(n, [f"diagSt{n:02d}"])[0]).strip(),
                [str(f).strip() for f in sfields[n]],
                float(sfreq.get(n, [0.0])[0]),
                float(sphase.get(n, [0.0])[0])))
        return cls(exp, streams, stats, out_dir=out_dir)

    # -- field evaluation ---------------------------------------------
    def _interior(self, arr) -> np.ndarray:
        cfg = self.exp.cfg
        a = np.asarray(arr)
        oy, ox = cfg.oly, cfg.olx
        return a[..., oy:a.shape[-2] - oy, ox:a.shape[-1] - ox]

    def _eval(self, name: str) -> np.ndarray:
        nlev, fn = REGISTRY[name]
        out = self._interior(fn(self.exp, self.exp.state))
        if out.ndim == 2:
            out = out[None]
        return out

    # -- stepping ------------------------------------------------------
    def step(self, myTime: float, myIter: int) -> None:
        """Call once per completed model step (end-of-step time myTime)."""
        for st in self.streams:
            if st.freq > 0.0:
                acc = self._acc.setdefault(st.fname, {})
                for f in st.fields:
                    v = self._eval(f)
                    if f in acc:
                        acc[f] = acc[f] + v
                    else:
                        acc[f] = v
                self._cnt[st.fname] = self._cnt.get(st.fname, 0) + 1
            if self._due(st.freq, st.phase, myTime):
                self._write_stream(st, myIter)
        for st in self.stats:
            if self._due(st.freq, st.phase, myTime):
                self._write_stats(st, myIter, myTime)

    def _due(self, freq: float, phase: float, myTime: float) -> bool:
        cfg = self.exp.cfg
        f = abs(freq)
        if f <= 0.0:
            return False
        t = myTime - phase
        dt = cfg.deltaTClock
        return abs(t / f - round(t / f)) * f < 0.5 * dt and t > 0.0

    # -- output --------------------------------------------------------
    def _write_stream(self, st: DiagStream, myIter: int) -> None:
        recs, flds = [], []
        for f in st.fields:
            if st.freq > 0.0:
                cnt = max(self._cnt.get(st.fname, 1), 1)
                v = self._acc[st.fname][f] / cnt
            else:
                v = self._eval(f)
            if st.levels and v.shape[0] > 1:
                v = v[[lv - 1 for lv in st.levels]]
            recs.append(v)
            flds.append(f)
        nlev = max(r.shape[0] for r in recs)
        out = np.stack([
            r if r.shape[0] == nlev
            else np.concatenate(
                [r, np.zeros((nlev - r.shape[0],) + r.shape[1:])], axis=0)
            for r in recs])
        mds.wrmds(os.path.join(self.out_dir, st.fname), out, itr=myIter,
                  dataprec="float32", nrecords=len(recs), fldlist=flds,
                  timestep_number=myIter)
        if st.freq > 0.0:
            self._acc.pop(st.fname, None)
            self._cnt.pop(st.fname, None)

    def _write_stats(self, st: StatStream, myIter: int,
                     myTime: float) -> None:
        """diagstats_output.F-style ASCII per-level statistics."""
        grid = self.exp.grid
        cfg = self.exp.cfg
        oy, ox = cfg.oly, cfg.olx
        w3 = self._interior(grid.hFacC * grid.rA[None]
                            * grid.drF[:, None, None])
        lines = [f"# Diagnostic statistics: iter {myIter} time {myTime}"]
        for f in st.fields:
            v = self._eval(f)
            nlev = v.shape[0]
            lines.append(f" field : {f}")
            for k in range(nlev):
                w = w3[min(k, w3.shape[0] - 1)]
                ws = w.sum()
                if ws <= 0.0:
                    continue
                mean = float((v[k] * w).sum() / ws)
                sd = float(np.sqrt((((v[k] - mean) ** 2) * w).sum() / ws))
                sel = w > 0
                vmin = float(v[k][sel].min()) if sel.any() else 0.0
                vmax = float(v[k][sel].max()) if sel.any() else 0.0
                lines.append(f" k={k + 1:3d} {mean: .10e} {sd: .10e}"
                             f" {vmin: .10e} {vmax: .10e} {float(ws): .6e}")
        path = os.path.join(self.out_dir,
                            f"{st.fname}.{myIter:010d}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
