"""pkg/gchem + pkg/cfc: CFC-11/CFC-12 air-sea exchange for ptracers.

Reference: pkg/cfc/cfc_readparms.F (defaults), cfc_atmos.F (ASCII
atmospheric history table), cfc_fields_load.F (periodic wind/ice
records -> piston velocity), cfc_param.F (Warner & Weiss solubility +
Zheng Schmidt-number coefficients), cfc11_forcing.F / cfc11_surfforcing.F
(OCMIP latitude blend of the N/S atmospheric values, flux =
Kw*(Csat - C) into the surface layer), gchem_calc_tendency.F (the
tendency is computed at the top of FORWARD_STEP, forward_step.F:688,
from the start-of-step tracer + the freshly loaded theta/salt, and is
ADDED to the advection-diffusion tendency inside the normal ptracer
step: GCHEM_ADD2TR_TENDENCY is defined whenever ALLOW_CFC is,
GCHEM_OPTIONS.h:23-25, applied via ptracers_apply_forcing.F:73).

Design: the atmosphere table and all periodic wind/ice records are
baked into device arrays at construction; the per-step work is a pair
of record gathers and an elementwise flux formula fused into the step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core.config import Config

# cfc_param.F constants
SCA_11 = (3501.8, -210.31, 6.1851, -0.075139)
A_11 = (-229.9261, 319.6552, 119.4471, -1.39165)
B_11 = (-0.142382, 0.091459, -0.0157274)
SCA_12 = (3845.4, -228.95, 6.1908, -0.067430)
A_12 = (-218.0971, 298.9702, 113.8049, -1.39165)
B_12 = (-0.143566, 0.091015, -0.0153924)


@dataclass
class CfcParams:
    """data.cfc CFC_FORCING namelist (cfc_readparms.F:24-52)."""
    atmCFC_inpFile: str = "cfc1112.atm"
    atmCFC_recSepTime: float = 360.0 * 86400.0
    atmCFC_timeOffset: float = None
    atmCFC_yNorthBnd: float = 10.0
    atmCFC_ySouthBnd: float = -10.0
    CFC_windFile: str = ""
    CFC_atmospFile: str = ""
    CFC_iceFile: str = ""
    CFC_forcingPeriod: float = 0.0   # default externForcingPeriod
    CFC_forcingCycle: float = 0.0    # default externForcingCycle


def params_from_namelists(cfg: Config, nl: dict) -> CfcParams:
    g = {k.lower(): v for k, v in nl.items()}
    p = CfcParams()
    p.atmCFC_inpFile = str(g.get("atmcfc_inpfile",
                                 p.atmCFC_inpFile)).strip()
    p.atmCFC_recSepTime = float(g.get("atmcfc_recseptime",
                                      p.atmCFC_recSepTime))
    if "atmcfc_timeoffset" in g:
        p.atmCFC_timeOffset = float(g["atmcfc_timeoffset"])
    else:
        # cfc_readparms.F:47-50
        ptr = {k.lower(): v for k, v in (cfg.ptracers or {}).items()}
        iter0 = int(ptr.get("ptracers_iter0", 0))
        p.atmCFC_timeOffset = (p.atmCFC_recSepTime
                               - cfg.deltaTClock * iter0)
    p.atmCFC_yNorthBnd = float(g.get("atmcfc_ynorthbnd", 10.0))
    p.atmCFC_ySouthBnd = float(g.get("atmcfc_ysouthbnd", -10.0))
    p.CFC_windFile = str(g.get("cfc_windfile", "")).strip()
    p.CFC_atmospFile = str(g.get("cfc_atmospfile", "")).strip()
    p.CFC_iceFile = str(g.get("cfc_icefile", "")).strip()
    p.CFC_forcingPeriod = float(g.get("cfc_forcingperiod",
                                      cfg.externForcingPeriod))
    p.CFC_forcingCycle = float(g.get("cfc_forcingcycle",
                                     cfg.externForcingCycle))
    return p


class Cfc:
    def __init__(self, cfg: Config, grid, p: CfcParams, run_dir: str,
                 fill2d, dtype=jnp.float64):
        from mitgcm_tpu.io import mds
        self.cfg = cfg
        self.p = p
        # --- atmospheric history table (cfc_atmos.F: skip 6 header
        # lines, 5 columns: year, cfc11_N, cfc12_N, cfc11_S, cfc12_S)
        path = p.atmCFC_inpFile
        if not os.path.isabs(path):
            path = cfg.find_file(p.atmCFC_inpFile)
        rows = []
        with open(path, errors="replace") as f:
            lines = f.readlines()[6:]
        for ln in lines:
            tok = ln.split()
            if len(tok) >= 5:
                try:
                    rows.append([float(t) for t in tok[:5]])
                except ValueError:
                    continue
        tab = np.asarray(rows, np.float64)
        self.acfc_year = jnp.asarray(tab[:, 0], dtype)
        # [nrec, 2] columns (north, south)
        self.acfc11 = jnp.asarray(tab[:, [1, 3]], dtype)
        self.acfc12 = jnp.asarray(tab[:, [2, 4]], dtype)
        self.nrec_atm = tab.shape[0]

        # --- periodic wind / ice / pressure records ---
        gx = cfg.nx
        gy = cfg.nFaces * cfg.ny
        nrec = int(round(p.CFC_forcingCycle / p.CFC_forcingPeriod)) \
            if p.CFC_forcingCycle > 0.0 else 1
        self.nrec = nrec
        prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"

        def stack2d(fname):
            if not fname:
                return None
            fp = cfg.find_file(fname)
            raw = mds.read_raw(fp, (nrec, gy, gx), prec)
            return jnp.asarray(np.stack(
                [np.asarray(fill2d(np.asarray(raw[n], np.float64)))
                 for n in range(nrec)]), dtype)

        self.wind = stack2d(p.CFC_windFile)
        self.fice = stack2d(p.CFC_iceFile)
        self.atmosp = stack2d(p.CFC_atmospFile)
        ks = cfg.ksurf0
        self.maskC0 = grid.maskC[ks]
        self.yC = grid.yC
        self.recip_drF0 = grid.recip_drF[ks]
        self.recip_hFacC0 = grid.recip_hFacC[ks]

    # ------------------------------------------------------------------
    def _cyclic(self, myTime, per, cyc, nrec):
        locTime = myTime - per * 0.5 + cyc * (
            2.0 - jnp.round(myTime / cyc))
        tmpTime = jnp.mod(locTime, cyc)
        rec0 = jnp.floor(tmpTime / per).astype(jnp.int32)
        rec1 = jnp.mod(rec0 + 1, nrec)
        aW = (tmpTime - per * rec0) / per
        return rec0, rec1, 1.0 - aW, aW

    def surface_fields(self, myTime):
        """cfc_fields_load.F: interpolated wind -> pisVel, fice, AtmosP."""
        p = self.p
        rec0, rec1, bW, aW = self._cyclic(
            myTime, p.CFC_forcingPeriod, p.CFC_forcingCycle, self.nrec)

        def interp(st):
            return (bW * jnp.take(st, rec0, axis=0)
                    + aW * jnp.take(st, rec1, axis=0))

        wind = interp(self.wind) if self.wind is not None \
            else jnp.zeros_like(self.maskC0)
        # piston velocity (cfc_fields_load.F:147)
        pisVel = 0.31 * wind * wind / 3.6e5
        fice = interp(self.fice) if self.fice is not None \
            else jnp.zeros_like(wind)
        atmosp = interp(self.atmosp) if self.atmosp is not None \
            else self.maskC0 * 1.0
        return pisVel, fice, atmosp

    def atmos_cfc(self, myTime):
        """cfc11_forcing.F:39-55 + OCMIP_GRAD latitude blend: 2-D
        atmospheric CFC-11/12 partial pressures [ppt]."""
        p = self.p
        cfcTime = myTime + p.atmCFC_timeOffset
        # GET_PERIODIC_INTERVAL cycleLength=0 branch (1-based recs)
        per = p.atmCFC_recSepTime
        locTime = cfcTime - per * 0.5
        modTime = jnp.mod(locTime, per)
        rec0 = 1 + jnp.round((locTime - modTime) / per).astype(jnp.int32)
        rec1 = rec0 + 1
        aW = modTime / per
        bW = 1.0 - aW
        i0 = jnp.clip(rec0 - 1, 0, self.nrec_atm - 1)
        i1 = jnp.clip(rec1 - 1, 0, self.nrec_atm - 1)

        def blend(tab):
            north = bW * tab[i0, 0] + aW * tab[i1, 0]
            south = bW * tab[i0, 1] + aW * tab[i1, 1]
            w = (self.yC - p.atmCFC_ySouthBnd) / (
                p.atmCFC_yNorthBnd - p.atmCFC_ySouthBnd)
            w = jnp.clip(w, 0.0, 1.0)
            return w * north + (1.0 - w) * south

        return blend(self.acfc11), blend(self.acfc12)

    # ------------------------------------------------------------------
    def tendency(self, myTime, pTr, theta_ks, salt_ks, i1: int):
        """gchem_calc_tendency.F CFC branch: per-tracer interior
        tendencies [same shape as pTr], nonzero in the surface layer
        only.  i1 = index of CFC11 in the ptracer stack (CFC_pTr_i1-1)."""
        pisVel, fice, atmosp = self.surface_fields(myTime)
        atm11, atm12 = self.atmos_cfc(myTime)
        out = {}
        for j, (atm, sca, A, B) in enumerate(
                ((atm11, SCA_11, A_11, B_11), (atm12, SCA_12, A_12, B_12))):
            t = theta_ks
            sc = sca[0] + t * (sca[1] + t * (sca[2] + t * sca[3]))
            tt = (t + 273.16) * 0.01
            tt2 = (B[2] * tt + B[1]) * tt + B[0]
            sol = jnp.exp(A[0] + A[1] / tt + A[2] * jnp.log(tt)
                          + A[3] * tt * tt + salt_ks * tt2)
            sol = sol * 1000.0 * 1.0e-12
            csat = sol * atmosp * atm
            kw = (1.0 - fice) * pisVel / jnp.sqrt(
                jnp.abs(sc) / 660.0)
            flux = jnp.where(self.maskC0 != 0.0,
                             kw * (csat - pTr[i1 + j, self.cfg.ksurf0]),
                             0.0)
            g = jnp.zeros_like(pTr[i1 + j]).at[self.cfg.ksurf0].add(
                flux * self.recip_drF0 * self.recip_hFacC0)
            out[i1 + j] = g
        return out
