"""pkg/thsice: Winton (1999) 3-layer thermodynamic sea ice.

Re-implementation of the reference package (file:line cites into the
reference's pkg/thsice/):
  * thsice_main.F        -- per-step driver (get_ocean -> map_exf ->
                            step_temp -> step_fwd)
  * thsice_get_ocean.F   -- mixed-layer fields from the ocean state
  * thsice_map_exf.F     -- precip/snow/SW + energy of precip from exf
  * thsice_albedo.F      -- snow/ice albedo with snow aging
  * thsice_get_exf.F     -- surface fluxes over ice from the exf
                            atmospheric state (fixed-coefficient branch,
                            useStabilityFct_overIce=F default)
  * thsice_solve4temp.F  -- implicit Winton surface/ice temperatures
  * thsice_calc_thickn.F -- top/bottom growth & melt, sublimation,
                            snow-to-ice flooding, Winton layer reshaping,
                            lateral melt
  * thsice_extend.F      -- freezing of sea water / lateral extension
  * thsice_step_fwd.F    -- snow aging, flux bookkeeping, ocean fluxes

All per-cell branch ladders become jnp.where cascades; the surface
temperature solve is a nitMaxTsf-iteration fori_loop of elementwise
2-D ops with the reference's per-cell Terrmax freeze-out (a cell stops
updating once |dTsrf| < Terrmax, solve4temp:358-362) — embarrassingly
parallel over cells.  THSICE_FRACEN_POWERLAW is compiled
in by default (THSICE_OPTIONS.h:11, powerLawExp2=2 in THSICE_SIZE.h)
so the vertical/lateral energy partition uses the degree-5 power law.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import cyclic_fill_halo, shift as sh


@dataclass
class ThsiceParams:
    # THSICE_CONST (thsice_readparms.F:105-144 defaults)
    rhos: float = 330.0
    rhoi: float = 900.0
    rhosw: float = 0.0            # = rhoConst
    rhofw: float = 0.0            # = rhoConstFresh
    cpIce: float = 2106.0
    cpWater: float = 0.0          # = HeatCapacity_Cp
    kIce: float = 2.03
    kSnow: float = 0.30
    bMeltCoef: float = 0.006
    Lfresh: float = 3.34e5
    qsnow: float = 3.34e5
    albColdSnow: float = 0.85
    albWarmSnow: float = 0.70
    tempSnowAlb: float = -10.0
    albOldSnow: float = 0.55
    albIceMax: float = 0.65
    albIceMin: float = 0.20
    hAlbIce: float = 0.50
    hAlbSnow: float = 0.30
    hNewSnowAge: float = 2.0e-3
    snowAgTime: float = 50.0 * 86400.0
    i0swFrac: float = 0.3
    ksolar: float = 1.5
    dhSnowLin: float = 0.0
    saltIce: float = 4.0
    S_winton: float = 1.0
    mu_Tf: float = 0.054
    Tf0kel: float = 273.15
    Terrmax: float = 0.5
    nitMaxTsf: int = 20
    hIceMin: float = 1.0e-2
    hiMax: float = 10.0
    hsMax: float = 10.0
    iceMaskMax: float = 1.0
    iceMaskMin: float = 0.1
    fracEnMelt: float = 0.4
    fracEnFreez: float = 0.0
    hThinIce: float = 0.2
    hThickIce: float = 2.5
    hNewIceMax: float = -1.0      # UNSET -> hiMax
    floodFac: float = 0.0         # derived: (rhosw-rhoi)/rhos
    # THSICE_PARM01
    startIceModel: int = 0
    thSIce_skipThermo: bool = False
    thSIce_calc_albNIR: bool = False
    thSIce_deltaT: float = 0.0    # = dTtracerLev(1)
    thSIce_dtTemp: float = 0.0    # = thSIce_deltaT
    ocean_deltaT: float = 0.0     # = dTtracerLev(1)
    hMxL_default: float = 50.0
    sMxL_default: float = 35.0
    vMxL_default: float = 5.0e-2
    thSIce_diffK: float = 0.0
    thSIceAdvScheme: int = 0
    stressReduction: float = 1.0  # 0 when useSEAICE
    thSIceBalanceAtmFW: int = 0
    fract_file: str = ""
    thick_file: str = ""
    snowh_file: str = ""
    snowa_file: str = ""
    enthp_file: str = ""
    tsurf_file: str = ""

    @property
    def Tmlt1(self) -> float:
        """Melting temp of the upper (brine-pocket) layer, -mu_Tf*S_winton
        (THSICE_PARAMS.h)."""
        return -self.mu_Tf * self.S_winton


_CONST_KEYS = {
    "rhos": "rhos", "rhoi": "rhoi", "cpice": "cpIce", "kice": "kIce",
    "ksnow": "kSnow", "bmeltcoef": "bMeltCoef", "lfresh": "Lfresh",
    "qsnow": "qsnow", "albcoldsnow": "albColdSnow",
    "albwarmsnow": "albWarmSnow", "tempsnowalb": "tempSnowAlb",
    "alboldsnow": "albOldSnow", "albicemax": "albIceMax",
    "albicemin": "albIceMin", "halbice": "hAlbIce", "halbsnow": "hAlbSnow",
    "hnewsnowage": "hNewSnowAge", "snowagtime": "snowAgTime",
    "i0swfrac": "i0swFrac", "ksolar": "ksolar", "dhsnowlin": "dhSnowLin",
    "saltice": "saltIce", "s_winton": "S_winton", "mu_tf": "mu_Tf",
    "tf0kel": "Tf0kel", "terrmax": "Terrmax", "nitmaxtsf": "nitMaxTsf",
    "hicemin": "hIceMin", "himax": "hiMax", "hsmax": "hsMax",
    "icemaskmax": "iceMaskMax", "icemaskmin": "iceMaskMin",
    "fracenmelt": "fracEnMelt", "fracenfreez": "fracEnFreez",
    "hthinice": "hThinIce", "hthickice": "hThickIce",
    "hnewicemax": "hNewIceMax",
}
_PARM01_KEYS = {
    "starticemodel": "startIceModel",
    "thsice_skipthermo": "thSIce_skipThermo",
    "thsice_calc_albnir": "thSIce_calc_albNIR",
    "thsice_deltat": "thSIce_deltaT", "thsice_dttemp": "thSIce_dtTemp",
    "ocean_deltat": "ocean_deltaT", "hmxl_default": "hMxL_default",
    "smxl_default": "sMxL_default", "vmxl_default": "vMxL_default",
    "thsice_diffk": "thSIce_diffK", "thsiceadvscheme": "thSIceAdvScheme",
    "stressreduction": "stressReduction",
    "thsicebalanceatmfw": "thSIceBalanceAtmFW",
    "thsicefract_initfile": "fract_file",
    "thsicethick_initfile": "thick_file",
    "thsicesnowh_initfile": "snowh_file",
    "thsicesnowa_initfile": "snowa_file",
    "thsiceenthp_initfile": "enthp_file",
    "thsicetsurf_initfile": "tsurf_file",
    # IO cadence (no effect on the solution)
    "thsice_monfreq": None, "thsice_diagfreq": None,
    "thsice_tavefreq": None,
}


def params_from_namelists(cfg: Config, const: dict, parm01: dict
                          ) -> ThsiceParams:
    p = ThsiceParams()
    p.rhosw = cfg.rhoConst
    p.rhofw = cfg.rhoConstFresh or cfg.rhoConst
    p.cpWater = cfg.HeatCapacity_Cp
    p.Tf0kel = cfg.celsius2K
    for src, table in ((const, _CONST_KEYS), (parm01, _PARM01_KEYS)):
        for k, v in src.items():
            kk = k.lower()
            if kk not in table:
                raise NotImplementedError(f"data.ice key {k}")
            tgt = table[kk]
            if tgt is None:
                continue
            cur = getattr(p, tgt)
            if isinstance(cur, bool):
                setattr(p, tgt, bool(v))
            elif isinstance(cur, int) and not isinstance(cur, bool):
                setattr(p, tgt, int(v))
            elif isinstance(cur, str):
                setattr(p, tgt, str(v).strip())
            else:
                setattr(p, tgt, float(v))
    if p.thSIce_deltaT == 0.0:
        p.thSIce_deltaT = cfg.deltaTTracer or cfg.deltaTClock
    if p.thSIce_dtTemp == 0.0:
        p.thSIce_dtTemp = p.thSIce_deltaT
    if p.ocean_deltaT == 0.0:
        p.ocean_deltaT = cfg.deltaTTracer or cfg.deltaTClock
    if p.hNewIceMax < 0.0:
        p.hNewIceMax = p.hiMax
    if cfg.useSEAICE and "stressreduction" not in {k.lower()
                                                  for k in parm01}:
        p.stressReduction = 0.0
    p.floodFac = (p.rhosw - p.rhoi) / p.rhos
    return p


class ThSIce:
    def __init__(self, cfg: Config, grid: Grid, p: ThsiceParams,
                 fills=None):
        self.cfg, self.grid, self.p = cfg, grid, p
        if fills is not None:
            self.fill = fills.fill
        else:
            self.fill = lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)
        ks = cfg.ksurf0
        self.maskC0 = grid.maskC[ks]
        if p.thSIceAdvScheme > 0:
            raise NotImplementedError(
                "thSIceAdvScheme > 0 (thsice_advection) not implemented "
                "yet; decks with thSIceAdvScheme=0 run")
        if p.thSIce_calc_albNIR:
            raise NotImplementedError("thSIce_calc_albNIR")
        if p.thSIce_skipThermo:
            raise NotImplementedError("thSIce_skipThermo")
        if p.thSIceBalanceAtmFW:
            raise NotImplementedError("thSIceBalanceAtmFW")

    # ------------------------------------------------------------------
    def init_state(self, load_2d, dtype=jnp.float64):
        """thsice_ini_vars.F fresh start: files or zero state; returns a
        dict of State th* fields."""
        p = self.p
        cfg = self.cfg
        nyp = cfg.nFaces * (cfg.ny + 2 * cfg.oly)
        nxp = cfg.nx + 2 * cfg.olx
        z2 = jnp.zeros((nyp, nxp), dtype)

        def rd(fname, rec=0):
            a = load_2d(fname)
            if a is None:
                return None
            return a[rec] if a.ndim == 3 else a

        iceMask = rd(p.fract_file) if p.fract_file else None
        iceH = rd(p.thick_file) if p.thick_file else None
        snowH = rd(p.snowh_file) if p.snowh_file else None
        snowA = rd(p.snowa_file) if p.snowa_file else None
        tsrf = rd(p.tsurf_file) if p.tsurf_file else None
        iceMask = (z2 if iceMask is None else iceMask) * self.maskC0
        iceH = z2 if iceH is None else iceH * self.maskC0
        snowH = z2 if snowH is None else snowH * self.maskC0
        snowA = z2 if snowA is None else snowA
        tsrf = z2 if tsrf is None else tsrf
        if p.enthp_file:
            q1 = rd(p.enthp_file, 0)
            q2 = rd(p.enthp_file, 1)
        else:
            # enthalpy of new ice at Tf=-1.70C (thsice_ini_vars.F:149-162)
            Tf = -1.70
            q1v = (-p.cpWater * p.Tmlt1 + p.cpIce * (p.Tmlt1 - Tf)
                   + p.Lfresh * (1.0 - p.Tmlt1 / Tf))
            q2v = -p.cpIce * Tf + p.Lfresh
            q1 = jnp.where(iceMask != 0.0, q1v, 0.0)
            q2 = jnp.where(iceMask != 0.0, q2v, 0.0)
        return {"thIceMask": self.fill(iceMask),
                "thIceH": self.fill(iceH),
                "thSnowH": self.fill(snowH),
                "thSnowAge": self.fill(snowA),
                "thTsrf": self.fill(tsrf),
                "thTice1": z2, "thTice2": z2,
                "thQice1": self.fill(q1), "thQice2": self.fill(q2)}

    # ------------------------------------------------------------------
    def albedo(self, iceMask, hIce, hSnow, tSrf, snowAge):
        """thsice_albedo.F"""
        p = self.p
        albice = p.albIceMax + (p.albIceMin - p.albIceMax) \
            * jnp.exp(-hIce / p.hAlbIce)
        if p.tempSnowAlb < 0.0:
            albNewSnow = p.albColdSnow + (
                p.albWarmSnow - p.albColdSnow) * jnp.clip(
                    1.0 - tSrf / p.tempSnowAlb, 0.0, 1.0)
        else:
            albNewSnow = jnp.full_like(tSrf, p.albColdSnow)
        albsno = p.albOldSnow + (albNewSnow - p.albOldSnow) \
            * jnp.exp(-0.2 * snowAge / 86400.0)
        albedo = albsno + (albice - albsno) * jnp.exp(-hSnow / p.hAlbSnow)
        return jnp.where(iceMask > 0.0, albedo, 0.0)

    # ------------------------------------------------------------------
    def get_exf(self, forc, icFlag, hSnow, tsfCel):
        """thsice_get_exf.F fixed-coefficient branch
        (useStabilityFct_overIce=F, exf_readparms.F:320): surface fluxes
        over ice at surface temperature tsfCel [oC].

        Returns (flxExcSw, dFlxdT, evapLoc, dEvdT); fluxes +=down, evap
        +=up [kg/m2/s]."""
        from mitgcm_tpu.model.exf import BULK as B
        p = self.p
        lath = B["flamb"] + B["flami"]
        emiss = jnp.where(hSnow > 0.3, B.get("snow_emissivity", 0.95),
                          B.get("ice_emissivity", 0.95))
        Tsf = tsfCel + B["cen2kel"]
        Ts2 = Tsf * Tsf
        ssq = B["cvapor_fac_ice"] * jnp.exp(-B["cvapor_exp_ice"] / Tsf) \
            / B["atmrho"]
        deltap = forc.atemp + B["gamma_blk"] * B["ht"] - Tsf
        delq = forc.aqh - ssq
        dEvdT0 = ssq * B["cvapor_exp_ice"] / Ts2
        flwup = emiss * B["stefanBoltzmann"] * Ts2 * Ts2
        dflwupdT = 4.0 * emiss * B["stefanBoltzmann"] * Ts2 * Tsf
        flwNet_dwn = emiss * forc.lwdown - flwup
        wsm = forc.wspeed
        tau = B["atmrho"] * B.get("exf_iceCe", 1.63e-3) * wsm
        evapLoc = -tau * delq
        hl = -lath * evapLoc
        hs = B["atmcp"] * B["atmrho"] * B.get("exf_iceCh", 1.63e-3) \
            * wsm * deltap
        dEvdT = tau * dEvdT0
        dflhdT = -lath * dEvdT
        dfshdT = -B["atmcp"] * B["atmrho"] * B.get("exf_iceCh", 1.63e-3) \
            * wsm
        flxExcSw = flwNet_dwn + hs + hl
        dFlxdT = -dflwupdT + dfshdT + dflhdT
        # atemp==0 guard (thsice_get_exf.F:488-500)
        ok = jnp.logical_and(icFlag > 0.0, forc.atemp > 0.0)
        z = jnp.zeros_like(flxExcSw)
        return (jnp.where(ok, flxExcSw, z), jnp.where(ok, dFlxdT, z),
                jnp.where(ok, evapLoc, z), jnp.where(ok, dEvdT, z))

    # ------------------------------------------------------------------
    def solve4temp(self, forc, icMask, hIce, hSnow, tFrz, flxSW, tSrf,
                   qIc1, qIc2):
        """thsice_solve4temp.F: implicit surface/ice temperature solve.

        Returns (flxSW_out [below-ice SW to ocean], tSrf, qIc1, qIc2,
        tIc1, tIc2, sHeat, flxCnB, flxAtm, evpAtm)."""
        p = self.p
        dt = p.thSIce_dtTemp
        on = icMask > 0.0
        # use a safe hIce where ice-free to avoid 1/0 (results masked)
        hIceS = jnp.where(on, jnp.maximum(hIce, p.hIceMin), 1.0)
        recip_dhSnowLin = 1.0 / p.dhSnowLin if p.dhSnowLin > 0.0 else 0.0
        # fractional snow cover (solve4temp:258-266)
        icm = jnp.where(on, icMask, 1.0)
        frsnow_r = hSnow * recip_dhSnowLin / icm
        frsnow = jnp.where(
            hSnow > icm * p.dhSnowLin, 1.0,
            jnp.sqrt(jnp.maximum(frsnow_r, 0.0)))
        # SW partition
        fswpen = flxSW * (1.0 - frsnow) * p.i0swFrac
        fswocn = fswpen * jnp.exp(-p.ksolar * hIceS)
        fswint = fswpen - fswocn
        fswdn = flxSW - fswpen
        flxAtm = jnp.where(on, flxSW, 0.0)
        flxSW_out = jnp.where(on, fswocn, flxSW)
        sHeat = fswdn
        # conductivities
        k12 = 4.0 * p.kIce * p.kSnow / (p.kSnow * hIceS
                                        + 4.0 * p.kIce * hSnow)
        k32 = 2.0 * p.kIce / hIceS
        # ice temperatures from enthalpies (solve4temp:291-296)
        a1 = p.cpIce
        b1 = qIc1 + (p.cpWater - p.cpIce) * p.Tmlt1 - p.Lfresh
        c1 = p.Lfresh * p.Tmlt1
        disc = jnp.sqrt(jnp.maximum(b1 * b1 - 4.0 * a1 * c1, 0.0))
        tIc1 = jnp.where(on, 0.5 * (-b1 - disc) / a1, 0.0)
        tIc2 = jnp.where(on, (p.Lfresh - qIc2) / p.cpIce, 0.0)
        tIc1s = jnp.where(on, jnp.minimum(tIc1, -1.0e-10), -1.0)
        # quadratic coefficients (solve4temp:312-326)
        rci = p.rhoi * p.cpIce
        a10 = (rci * hIceS / (2.0 * dt)
               + k32 * (4.0 * dt * k32 + rci * hIceS)
               / (6.0 * dt * k32 + rci * hIceS))
        b10 = (-hIceS * (rci * tIc1 + p.rhoi * p.Lfresh * p.Tmlt1 / tIc1s)
               / (2.0 * dt)
               - k32 * (4.0 * dt * k32 * tFrz + rci * hIceS * tIc2)
               / (6.0 * dt * k32 + rci * hIceS)
               - fswint)
        c10 = p.rhoi * p.Lfresh * hIceS * p.Tmlt1 / (2.0 * dt)
        # fluxes over melting surface Ts=0
        flx0, _d0, evap_0, _de0 = self.get_exf(
            forc, jnp.where(on, 1.0, 0.0), hSnow, jnp.zeros_like(tSrf))

        # --- fixed-iteration implicit solve (solve4temp:363-545) ---
        def it_body(_k, carry):
            tSrf_c, tIc1_c, dTsrf_c, flxT_c, evapT_c, dFdT_c, dEdT_c, \
                active = carry
            flxT, dFdT, evapT, dEdT = self.get_exf(
                forc, jnp.where(on, 1.0, 0.0), hSnow, tSrf_c)
            # only update where still iterating
            flxT = jnp.where(active, flxT, flxT_c)
            dFdT = jnp.where(active, dFdT, dFdT_c)
            evapT = jnp.where(active, evapT, evapT_c)
            dEdT = jnp.where(active, dEdT, dEdT_c)
            flxNet = sHeat + flxT
            den = k12 - dFdT
            a1i = a10 - k12 * dFdT / den
            b1i = b10 - k12 * (flxNet - dFdT * tSrf_c) / den
            disc_i = jnp.sqrt(jnp.maximum(b1i * b1i - 4.0 * a1i * c10,
                                          0.0))
            t1 = -(b1i + disc_i) / (2.0 * a1i)
            dTs = (flxNet + k12 * (t1 - tSrf_c)) / den
            TsfTmp = tSrf_c + dTs
            # melting-surface branch (Tsf > 0 -> fix at 0)
            a1m = a10 + k12
            disc_m = jnp.sqrt(jnp.maximum(b10 * b10 - 4.0 * a1m * c10,
                                          0.0))
            t1m = (-b10 - disc_m) / (2.0 * a1m)
            melt = TsfTmp > 0.0
            t1_new = jnp.where(melt, t1m, t1)
            ts_new = jnp.where(melt, 0.0, TsfTmp)
            flxT_new = jnp.where(melt, flx0, flxT)
            evapT_new = jnp.where(melt, evap_0, evapT)
            dTs_new = jnp.where(melt, 0.0, dTs)
            # apply only where active & iced
            upd = jnp.logical_and(active, on)
            tSrf_n = jnp.where(upd, ts_new, tSrf_c)
            tIc1_n = jnp.where(upd, t1_new, tIc1_c)
            dTsrf_n = jnp.where(upd, dTs_new, dTsrf_c)
            flxT_n = jnp.where(upd, flxT_new, flxT_c)
            evapT_n = jnp.where(upd, evapT_new, evapT_c)
            active_n = jnp.logical_and(
                on, jnp.abs(dTsrf_n) >= p.Terrmax)
            return (tSrf_n, tIc1_n, dTsrf_n, flxT_n, evapT_n,
                    dFdT, dEdT, active_n)

        z = jnp.zeros_like(tSrf)
        carry0 = (tSrf, tIc1, jnp.full_like(tSrf, p.Terrmax), z, z, z, z,
                  on)
        (tSrf, tIc1, dTsrf, flxTexSW, evapT, dFlxdT, dEvdT,
         _act) = jax.lax.fori_loop(0, p.nitMaxTsf, it_body, carry0)

        # new bottom-layer temperature (solve4temp:566-573)
        tIc2 = jnp.where(on, (2.0 * dt * k32 * (tIc1 + 2.0 * tFrz)
                              + rci * hIceS * tIc2)
                         / (6.0 * dt * k32 + rci * hIceS), tIc2)
        # final fluxes (solve4temp:580-600)
        fct = k12 * (tSrf - tIc1)
        flxCnB = jnp.where(on, 4.0 * p.kIce * (tIc2 - tFrz) / hIceS, 0.0)
        flxNet = sHeat + flxTexSW + dFlxdT * dTsrf
        evpAtm = jnp.where(on, evapT + dEvdT * dTsrf, 0.0)
        flxAtm = jnp.where(on, flxAtm + flxTexSW + dFlxdT * dTsrf
                           + evpAtm * p.Lfresh, 0.0)
        sHeat = jnp.where(on, flxNet - fct, 0.0)
        # new enthalpies (solve4temp:607-610)
        tIc1s2 = jnp.where(on, jnp.minimum(tIc1, -1.0e-10), -1.0)
        qIc1 = jnp.where(on, -p.cpWater * p.Tmlt1
                         + p.cpIce * (p.Tmlt1 - tIc1)
                         + p.Lfresh * (1.0 - p.Tmlt1 / tIc1s2), qIc1)
        qIc2 = jnp.where(on, -p.cpIce * tIc2 + p.Lfresh, qIc2)
        dTsrf = jnp.where(on, dTsrf, 0.0)
        return (flxSW_out, tSrf, qIc1, qIc2, tIc1, tIc2, sHeat, flxCnB,
                flxAtm, evpAtm)

    # ------------------------------------------------------------------
    def calc_thickn(self, iceMask, tFrz, tOce, v2oc, snowP, prcAtm,
                    sHeat, flxCnB, icFrac, hIce, hSnow, tSrf, qIc1, qIc2,
                    frwAtm, fzMlOc, flx2oc):
        """thsice_calc_thickn.F: top/bottom growth & melt, sublimation,
        flooding, Winton layer reshaping, lateral melt, and the ocean
        fluxes.  THSICE_FRACEN_POWERLAW is defined by default
        (THSICE_OPTIONS.h:11) with compile-time powerLawExp2=2
        (THSICE_SIZE.h:14) so the vertical/lateral energy partition is
        the smooth degree-5 power law (calc_thickn:253-269,317-340).

        Returns (icFrac, hIce, hSnow, tSrf, qIc1, qIc2, frwAtm, fzMlOc,
        flx2oc, frw2oc, fsalt, frzSeaWat)."""
        p = self.p
        dt = p.thSIce_deltaT
        on = iceMask > 0.0
        cpchr = p.cpWater * p.rhosw * p.bMeltCoef
        lowIcFrac1 = p.iceMaskMin * 1.01
        lowIcFrac2 = p.iceMaskMin * 1.10
        z = jnp.zeros_like(hIce)

        def safe(x, cond=None):
            c = (x != 0.0) if cond is None else cond
            return jnp.where(c, x, 1.0)

        q1, q2 = qIc1, qIc2
        evapLoc = jnp.where(on, frwAtm, z)
        # --- powerlaw vertical/lateral energy-partition coefficients
        # (calc_thickn:253-269 with powerLaw = 1+2**powerLawExp2 = 5)
        powerLaw = 5
        rec_pLaw = 1.0 / powerLaw
        c1Mlt = p.fracEnMelt ** rec_pLaw
        c2Mlt = (1.0 - p.fracEnMelt) ** rec_pLaw
        aMlt = (c1Mlt + c2Mlt) / (p.hThickIce - p.hThinIce)
        hMlt = p.hThinIce + c2Mlt / aMlt
        c1Frz = p.fracEnFreez ** rec_pLaw
        c2Frz = (1.0 - p.fracEnFreez) ** rec_pLaw
        aFrz = (c1Frz + c2Frz) / (p.hThickIce - p.hThinIce)
        hFrz = p.hThinIce + c2Frz / aFrz
        # enFrc* = clip(fracEn* - [a*(hi-h*)]^powerLaw, 0, 1)
        # (calc_thickn:317-340)
        xxMlt = (aMlt * (hIce - hMlt)) ** powerLaw
        xxFrz = (aFrz * (hIce - hFrz)) ** powerLaw
        enFrcMlt = jnp.clip(p.fracEnMelt - xxMlt, 0.0, 1.0)
        enFrcFrz = jnp.clip(p.fracEnFreez - xxFrz, 0.0, 1.0)
        # --- Fbot: ocean heat flux to the ice base (calc_thickn:343-409)
        frz = fzMlOc >= 0.0
        fb_frz = jnp.where(icFrac < p.iceMaskMax, enFrcFrz * fzMlOc,
                           fzMlOc)
        ustar = jnp.maximum(5.0e-3, jnp.sqrt(0.00536 * v2oc))
        fb_mlt = jnp.minimum(jnp.maximum(cpchr * (tFrz - tOce) * ustar,
                                         fzMlOc), 0.0)
        Fbot = jnp.where(on, jnp.where(frz, fb_frz, fb_mlt), z)
        mwater0 = p.rhos * hSnow + p.rhoi * hIce
        msalt0 = p.rhoi * hIce * p.saltIce

        # --- lateral-melt energy fraction (calc_thickn:436-442 powerlaw)
        if p.fracEnMelt == 0.0:
            frace = z
        else:
            frace = (icFrac - lowIcFrac1) / (lowIcFrac2 - p.iceMaskMin)
            frace = jnp.minimum(enFrcMlt, jnp.maximum(0.0, frace))
        pos = sHeat > 0.0
        etop = jnp.where(on & pos, (1.0 - frace) * sHeat * dt, z)
        etope = jnp.where(on & pos, frace * sHeat * dt, z)
        esurp = jnp.where(on & ~pos, sHeat * dt, z)
        ebot = jnp.where(on, (flxCnB - Fbot) * dt, z)
        ebote = jnp.where(ebot > 0.0, frace * ebot, z)
        ebot = ebot - ebote

        # --- layers + top melt (snow -> l1 -> l2), calc_thickn:498-576
        h1 = hIce * 0.5
        h2 = hIce * 0.5
        c = on & (etop > 0.0) & (hSnow > 0.0)
        rq = p.rhos * p.qsnow
        rqh = rq * hSnow
        less = etop < rqh
        hSnow = jnp.where(c, jnp.where(less, hSnow - etop / rq, 0.0),
                          hSnow)
        etop = jnp.where(c, jnp.where(less, 0.0, etop - rqh), etop)

        def melt_top(h, q, etop):
            c = on & (etop > 0.0)
            rq = p.rhoi * safe(q, q > 0.0)
            rqh = rq * h
            less = etop < rqh
            h_new = jnp.where(c, jnp.where(less, h - etop / rq, 0.0), h)
            # reference zeroes etop where it was <= 0 inside the loop
            etop_new = jnp.where(c, jnp.where(less, 0.0, etop - rqh),
                                 jnp.where(on, 0.0, etop))
            return h_new, etop_new

        h1, etop = melt_top(h1, q1, etop)
        h2, etop = melt_top(h2, q2, etop)

        # --- bottom growth (calc_thickn:595-612)
        grow = on & (ebot < 0.0)
        qbot = -p.cpIce * tFrz + p.Lfresh
        dhi = jnp.where(grow, -ebot / (qbot * p.rhoi), z)
        q2 = jnp.where(grow, (h2 * q2 + dhi * qbot) / safe(h2 + dhi,
                                                           (h2 + dhi) > 0.0),
                       q2)
        h2 = jnp.where(grow, h2 + dhi, h2)
        frzSeaWat = jnp.where(grow, p.rhoi * dhi / dt, z)
        ebot = jnp.where(grow, 0.0, ebot)

        # --- bottom melt (l2 -> l1 -> snow), calc_thickn:622-684
        def melt_bot(h, q, ebot):
            c = on & (ebot > 0.0) & (h > 0.0)
            rq = p.rhoi * safe(q, q > 0.0)
            rqh = rq * h
            less = ebot < rqh
            h_new = jnp.where(c, jnp.where(less, h - ebot / rq, 0.0), h)
            ebot_new = jnp.where(c, jnp.where(less, 0.0, ebot - rqh),
                                 ebot)
            return h_new, ebot_new

        h2, ebot = melt_bot(h2, q2, ebot)
        h1, ebot = melt_bot(h1, q1, ebot)
        c = on & (ebot > 0.0) & (hSnow > 0.0)
        rq = p.rhos * p.qsnow
        rqh = rq * hSnow
        less = ebot < rqh
        hSnow = jnp.where(c, jnp.where(less, hSnow - ebot / rq, 0.0),
                          hSnow)
        ebot = jnp.where(c, jnp.where(less, 0.0, ebot - rqh), ebot)

        # --- total thickness; melt all if < hIceMin (calc_thickn:686-707)
        hIce = jnp.where(on, h1 + h2, hIce)
        tiny = on & (hIce < p.hIceMin) & ((hIce + hSnow) > 0.0)
        esurp = jnp.where(tiny, esurp - p.rhos * p.qsnow * hSnow
                          - p.rhoi * q1 * h1 - p.rhoi * q2 * h2, esurp)
        hIce = jnp.where(tiny, 0.0, hIce)
        h1 = jnp.where(tiny, 0.0, h1)
        h2 = jnp.where(tiny, 0.0, h2)
        hSnow = jnp.where(tiny, 0.0, hSnow)
        tSrf = jnp.where(tiny, 0.0, tSrf)
        icFrac = jnp.where(tiny, 0.0, icFrac)
        q1 = jnp.where(tiny, 0.0, q1)
        q2 = jnp.where(tiny, 0.0, q2)

        # --- mass budget -> frw2oc; return snow if ice gone (714-731)
        frw2oc = jnp.where(on, (mwater0 - (p.rhos * hSnow
                                           + p.rhoi * hIce)) / dt, z)
        gone = on & (hIce <= 0.0)
        frw2oc = jnp.where(gone, frw2oc + snowP, frw2oc)
        flx2oc = jnp.where(gone, flx2oc - snowP * p.Lfresh, flx2oc)

        # --- snow fall + snow sublimation (736-758)
        has_ice = on & (hIce > 0.0)
        hSnow = jnp.where(has_ice, hSnow + dt * snowP / p.rhos, hSnow)
        c = has_ice & (hSnow > 0.0)
        subl_all = evapLoc / p.rhos * dt > hSnow
        hSnow_new = jnp.where(subl_all, 0.0,
                              hSnow - evapLoc / p.rhos * dt)
        evap_new = jnp.where(subl_all, evapLoc - hSnow * p.rhos / dt,
                             0.0)
        hSnow = jnp.where(c, hSnow_new, hSnow)
        evapLoc = jnp.where(c, evap_new, evapLoc)

        # --- ice sublimation, enthalpy-aware (calc_thickn:762-815)
        def subl(h, q, evapLoc, esurp):
            c = on & (hIce > 0.0) & (evapLoc > 0.0)
            dhi = evapLoc / p.rhoi * dt
            all_ = dhi >= h
            esurp_new = jnp.where(c & all_, esurp - h * p.rhoi
                                  * (q - p.Lfresh), esurp)
            evap_n = jnp.where(all_, evapLoc - h * p.rhoi / dt, 0.0)
            hq = h * q - dhi * p.Lfresh
            h_n = jnp.where(all_, 0.0, h - dhi)
            q_n = jnp.where(all_, q, hq / safe(h_n, h_n > 0.0))
            return (jnp.where(c, h_n, h), jnp.where(c, q_n, q),
                    jnp.where(c, evap_n, evapLoc), esurp_new)

        h1, q1, evapLoc, esurp = subl(h1, q1, evapLoc, esurp)
        h2, q2, evapLoc, esurp = subl(h2, q2, evapLoc, esurp)

        # --- recompute thickness; hIceMin check again (820-846)
        was_ice = on & (hIce > 0.0)
        hIce = jnp.where(was_ice, h1 + h2, hIce)
        tiny2 = was_ice & (hIce > 0.0) & (hIce < p.hIceMin)
        frw2oc = jnp.where(tiny2, frw2oc + (p.rhos * hSnow
                                            + p.rhoi * hIce) / dt,
                           frw2oc)
        esurp = jnp.where(tiny2, esurp - p.rhos * p.qsnow * hSnow
                          - p.rhoi * q1 * h1 - p.rhoi * q2 * h2, esurp)
        hIce = jnp.where(tiny2, 0.0, hIce)
        h1 = jnp.where(tiny2, 0.0, h1)
        h2 = jnp.where(tiny2, 0.0, h2)
        hSnow = jnp.where(tiny2, 0.0, hSnow)
        tSrf = jnp.where(tiny2, 0.0, tSrf)
        icFrac = jnp.where(tiny2, 0.0, icFrac)
        q1 = jnp.where(tiny2, 0.0, q1)
        q2 = jnp.where(tiny2, 0.0, q2)

        # --- snow-to-ice flooding (calc_thickn:856-886)
        alive = on & (hIce > 0.0)
        flood = alive & jnp.logical_or(hSnow > hIce * p.floodFac,
                                       hSnow > p.hsMax)
        dhs = (hSnow - hIce * p.floodFac) * p.rhoi / p.rhosw
        dhs = jnp.maximum(hSnow - p.hsMax, dhs)
        dhi = dhs * p.rhos / p.rhoi
        rqh = p.rhoi * q1 * h1 + p.rhos * p.qsnow * dhs
        h1f = h1 + dhi
        q1 = jnp.where(flood, rqh / (p.rhoi * safe(h1f, h1f > 0.0)), q1)
        h1 = jnp.where(flood, h1f, h1)
        hIce = jnp.where(flood, hIce + dhi, hIce)
        hSnow = jnp.where(flood, hSnow - dhs, hSnow)

        # --- hiMax cap (calc_thickn:920-934)
        cap = alive & (hIce > p.hiMax)
        chi = hIce - p.hiMax
        h1 = jnp.where(cap, h1 - chi * 0.5, h1)
        h2 = jnp.where(cap, h2 - chi * 0.5, h2)
        frw2oc = jnp.where(cap, frw2oc + chi * p.rhoi / dt, frw2oc)
        hIce = jnp.where(alive, h1 + h2, hIce)

        # --- Winton layer reshaping (inlined THSICE_RESHAPE_LAYERS)
        hlyr = hIce * 0.5
        hl_s = safe(hlyr, hlyr > 0.0)
        give12 = h1 > h2
        f1a = (h1 - hlyr) / hl_s
        q2tmp = f1a * q1 + (1.0 - f1a) * q2
        qh2 = hlyr * q2
        qhtot = h1 * q1 + h2 * q2
        q1_keep = (qhtot - qh2) / hl_s
        q2_a = jnp.where(q2tmp > p.Lfresh, q2tmp, q2)
        q1_a = jnp.where(q2tmp > p.Lfresh, q1, q1_keep)
        f1b = h1 / hl_s
        q1_b = f1b * q1 + (1.0 - f1b) * q2
        resh = alive & (hIce > 0.0)
        q1 = jnp.where(resh, jnp.where(give12, q1_a, q1_b), q1)
        q2 = jnp.where(resh, jnp.where(give12, q2_a, q2), q2)

        # --- final fluxes (calc_thickn:1003-1052)
        icFrac = jnp.where(on & (hIce <= 0.0), 0.0, icFrac)
        flx2oc = jnp.where(on, flx2oc + Fbot
                           + (esurp + etop + ebot) / dt, flx2oc)
        frw2oc = jnp.where(on, frw2oc - evapLoc, frw2oc)
        flx2oc = jnp.where(on, flx2oc + evapLoc * p.Lfresh, flx2oc)
        fsalt = jnp.where(on, (msalt0 - p.rhoi * hIce * p.saltIce) / dt,
                          z)
        frw2oc = jnp.where(on, frw2oc + (prcAtm - snowP), frw2oc)

        # --- lateral melting (calc_thickn:1058-1095)
        extend = etope + ebote
        lat = on & (icFrac > 0.0) & (extend > 0.0)
        rq = p.rhoi * 0.5 * (q1 + q2)
        rs = p.rhos * p.qsnow
        rqh = rq * hIce + rs * hSnow
        rqh_s = safe(rqh, rqh > 0.0)
        freshe = (p.rhos * hSnow + p.rhoi * hIce) / dt
        salte = (p.rhoi * hIce * p.saltIce) / dt
        partial = extend < rqh
        icFrac_m = (1.0 - extend / rqh_s) * icFrac
        keep = partial & (icFrac_m >= p.iceMaskMin)
        frw2oc = jnp.where(lat, jnp.where(keep,
                                          frw2oc + extend / rqh_s * freshe,
                                          frw2oc + freshe), frw2oc)
        fsalt = jnp.where(lat, jnp.where(keep,
                                         fsalt + extend / rqh_s * salte,
                                         fsalt + salte), fsalt)
        flx2oc = jnp.where(lat & ~keep, flx2oc + (extend - rqh) / dt,
                           flx2oc)
        icFrac = jnp.where(lat, jnp.where(keep, icFrac_m, 0.0), icFrac)
        hIce = jnp.where(lat & ~keep, 0.0, hIce)
        hSnow = jnp.where(lat & ~keep, 0.0, hSnow)
        # extend > 0 on non-fraction cells goes straight to the ocean
        lat0 = on & (icFrac <= 0.0) & ~lat & (extend > 0.0)
        flx2oc = jnp.where(lat0, flx2oc + extend / dt, flx2oc)

        # --- outputs (calc_thickn:1098-1121)
        frwAtm = jnp.where(on, frwAtm - prcAtm, frwAtm)
        fzMlOc = jnp.where(on, fzMlOc - Fbot * iceMask, fzMlOc)
        return (icFrac, hIce, hSnow, tSrf, q1, q2, frwAtm, fzMlOc,
                flx2oc, frw2oc, fsalt, frzSeaWat)

    # ------------------------------------------------------------------
    def extend(self, fzMlOc, tFrz, tOce, icFrac, hIce, hSnow, tSrf,
               tIc1, tIc2, qIc1, qIc2):
        """thsice_extend.F: freeze sea water, make/extend ice.

        Returns (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, qIc1, qIc2,
        flx2oc, frw2oc, fsalt)."""
        p = self.p
        dt = p.thSIce_deltaT
        act = fzMlOc > 0.0
        z = jnp.zeros_like(hIce)
        # enthalpy of (possibly new) ice
        no_ice = icFrac <= 0.0
        q1n = (-p.cpWater * p.Tmlt1 + p.cpIce * (p.Tmlt1 - tFrz)
               + p.Lfresh * (1.0 - p.Tmlt1
                             / jnp.where(tFrz < 0.0, tFrz, -1.0e-10)))
        q2n = -p.cpIce * tFrz + p.Lfresh
        q1 = jnp.where(act & no_ice, q1n, qIc1)
        q2 = jnp.where(act & no_ice, q2n, qIc2)
        qicAv = p.rhoi * (q1 + q2) * 0.5
        newIce = jnp.where(act, fzMlOc * dt
                           / jnp.where(qicAv > 0.0, qicAv, 1.0), 0.0)
        iceVol = icFrac * hIce
        # branch 1: no ice yet, enough new ice
        mk = act & no_ice & (newIce > p.hIceMin * p.iceMaskMin)
        th1 = jnp.minimum(p.hThinIce, newIce / p.iceMaskMin)
        th1 = jnp.maximum(th1, newIce / p.iceMaskMax)
        fr1 = newIce / jnp.where(th1 > 0.0, th1, 1.0)
        formed1 = newIce
        # branch 2: existing ice below hiMax*maskMax
        mk2 = act & ~no_ice & (iceVol < p.hiMax * p.iceMaskMax)
        hNewIce = jnp.minimum(jnp.where(hIce > 0.0, hIce, p.hNewIceMax),
                              p.hNewIceMax)
        fr2 = jnp.minimum(icFrac + newIce
                          / jnp.where(hNewIce > 0.0, hNewIce, 1.0),
                          p.iceMaskMax)
        th2 = jnp.minimum(p.hiMax, (iceVol + newIce)
                          / jnp.where(fr2 > 0.0, fr2, 1.0))
        formed2 = th2 * fr2 - iceVol
        hSnow2 = hSnow * icFrac / jnp.where(fr2 > 0.0, fr2, 1.0)

        newFrac = jnp.where(mk, fr1, jnp.where(mk2, fr2, icFrac))
        newThick = jnp.where(mk, th1, jnp.where(mk2, th2, hIce))
        formed = jnp.where(mk, formed1, jnp.where(mk2, formed2, 0.0))
        hSnow = jnp.where(mk2, hSnow2, hSnow)
        flx2oc = jnp.where(act, qicAv * formed / dt, z)
        frw2oc = jnp.where(act, -p.rhoi * formed / dt, z)
        fsalt = jnp.where(act, -(p.rhoi * p.saltIce) * formed / dt, z)
        # new-ice state where ice appears on an ice-free cell
        fresh = act & (newFrac > 0.0) & no_ice
        tSrf = jnp.where(fresh, tFrz, tSrf)
        tIc1 = jnp.where(fresh, tFrz, tIc1)
        tIc2 = jnp.where(fresh, tFrz, tIc2)
        qIc1 = jnp.where(act, q1, qIc1)
        qIc2 = jnp.where(act, q2, qIc2)
        icFrac = jnp.where(act, newFrac, icFrac)
        hIce = jnp.where(act, newThick, hIce)
        return (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, qIc1, qIc2,
                flx2oc, frw2oc, fsalt)

    # ------------------------------------------------------------------
    def step(self, th, forc, theta_ks, salt_ks, uVel_ks, vVel_ks,
             hFacC_ks, Qnet, Qsw, EmPmR, saltFlux, uIce=None, vIce=None):
        """One thsice step (thsice_main.F sequence: get_ocean -> map_exf
        -> step_temp -> step_fwd).

        th: dict with thIceMask/thIceH/thSnowH/thSnowAge/thTsrf/thTice1/
        thTice2/thQice1/thQice2.  Returns (th', flux updates dict with
        the overwritten Qnet/Qsw/EmPmR/saltFlux + sIceLoad + frwAtm).
        """
        p = self.p
        cfg = self.cfg
        grid = self.grid
        iceMask = th["thIceMask"]
        hIce = th["thIceH"]
        hSnow = th["thSnowH"]
        snowAge = th["thSnowAge"]
        tSrf = th["thTsrf"]
        q1, q2 = th["thQice1"], th["thQice2"]

        # --- THSICE_GET_OCEAN (thsice_get_ocean.F) ---
        ks = cfg.ksurf0
        hOceMxL = grid.drF[ks] * hFacC_ks
        tOceMxL = theta_ks
        sOceMxL = salt_ks
        if uIce is None:
            u2 = uVel_ks * uVel_ks + sh(uVel_ks, di=1) * sh(uVel_ks, di=1)
            v2 = vVel_ks * vVel_ks + sh(vVel_ks, dj=1) * sh(vVel_ks, dj=1)
        else:
            du = uVel_ks - uIce
            dv = vVel_ks - vIce
            u2 = du * du + sh(du, di=1) * sh(du, di=1)
            v2 = dv * dv + sh(dv, dj=1) * sh(dv, dj=1)
        v2ocMxL = (u2 + v2) * 0.5

        # --- THSICE_MAP_EXF (thsice_map_exf.F) ---
        rhofw_cfg = cfg.rhoConstFresh or cfg.rhoConst
        totPrc = (forc.precip + forc.runoff) * rhofw_cfg
        flxSW0 = forc.swdown
        snowPrc = jnp.where(
            jnp.logical_and(iceMask > 0.0,
                            forc.atemp <= cfg.celsius2K),
            forc.precip * rhofw_cfg, 0.0)
        qPrcRnO = jnp.zeros_like(totPrc)
        if cfg.temp_EvPrRn is not None:
            qPrcRnO = (cfg.HeatCapacity_Cp
                       * (forc.atemp - cfg.celsius2K - cfg.temp_EvPrRn)
                       * (forc.precip * rhofw_cfg - snowPrc)
                       + cfg.HeatCapacity_Cp
                       * (tOceMxL - cfg.temp_EvPrRn)
                       * forc.runoff * rhofw_cfg)

        # --- THSICE_STEP_TEMP (thsice_step_temp.F) ---
        on = iceMask > 0.0
        alb = self.albedo(iceMask, hIce, hSnow, tSrf, snowAge)
        icFlxSW = jnp.where(on, flxSW0 * (1.0 - alb), flxSW0)
        tFrzOce = jnp.where(on, -p.mu_Tf * sOceMxL, 0.0)
        (icFlxSW, tSrf, q1, q2, tIc1, tIc2, sHeating, flxCndBt,
         icFlxAtm, icFrwAtm) = self.solve4temp(
            forc, iceMask, hIce, hSnow, tFrzOce, icFlxSW, tSrf, q1, q2)
        icFrac0 = iceMask
        opFrac0 = 1.0 - icFrac0
        Qsw = jnp.where(on, opFrac0 * Qsw - icFrac0 * icFlxSW, Qsw)

        # --- THSICE_STEP_FWD (thsice_step_fwd.F) ---
        dt = p.thSIce_deltaT
        ageFac = 1.0 - dt / p.snowAgTime
        snowFac = dt / (p.rhos * p.hNewSnowAge)
        snowAge = jnp.where(on, dt + snowAge * ageFac, snowAge)
        snowAge = jnp.where(jnp.logical_and(on, snowPrc > 0.0),
                            snowAge * jnp.exp(-snowFac * snowPrc),
                            snowAge)
        icFlxAtm = jnp.where(on, icFlxAtm - p.Lfresh * snowPrc + qPrcRnO,
                             icFlxAtm)

        # step_fwd part 2 recomputes tFrz UNMASKED (thsice_step_fwd.F:197:
        # tFrzOce = -mu_Tf*sOceMxL for every cell) so frzmlt is 0 on
        # open water at the freezing point -- the step_temp-masked
        # version above is only for solve4temp
        tFrzAll = -p.mu_Tf * sOceMxL
        cphm = p.cpWater * p.rhosw * hOceMxL
        frzmltMxL = (tFrzAll - tOceMxL) * cphm / p.ocean_deltaT
        icFrac = iceMask
        flx2oc = icFlxSW + qPrcRnO

        (icFrac, hIce, hSnow, tSrf, q1, q2, icFrwAtm, frzmltMxL, flx2oc,
         frw2oc, fsalt, frzSeaWat) = self.calc_thickn(
            iceMask, tFrzAll, tOceMxL, v2ocMxL, snowPrc, totPrc,
            sHeating, flxCndBt, icFrac, hIce, hSnow, tSrf, q1, q2,
            icFrwAtm, frzmltMxL, flx2oc)

        # net fluxes (step_fwd:263-306)
        icFlxAtm = jnp.where(on, icFrac0 * icFlxAtm - opFrac0 * Qnet,
                             jnp.where(hOceMxL > 0.0, -Qnet, 0.0))
        icFrwAtm = jnp.where(on, icFrac0 * icFrwAtm + opFrac0 * EmPmR,
                             jnp.where(hOceMxL > 0.0, EmPmR, 0.0))
        Qnet = jnp.where(on, -icFrac0 * flx2oc + opFrac0 * Qnet, Qnet)
        EmPmR = jnp.where(on, -icFrac0 * frw2oc + opFrac0 * EmPmR, EmPmR)
        saltFlux = jnp.where(on, -icFrac0 * fsalt,
                             jnp.zeros_like(saltFlux))

        # --- THSICE_EXTEND (freeze open water) ---
        (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, q1, q2, flx2oc_e,
         frw2oc_e, fsalt_e) = self.extend(
            frzmltMxL, tFrzAll, tOceMxL, icFrac, hIce, hSnow, tSrf,
            tIc1, tIc2, q1, q2)
        Qnet = Qnet - flx2oc_e
        EmPmR = EmPmR - frw2oc_e
        saltFlux = saltFlux - fsalt_e

        # final state bookkeeping (step_fwd:380-401)
        has = icFrac > 0.0
        iceMask = jnp.where(has, icFrac, 0.0)
        snowAge = jnp.where(has & (hSnow == 0.0), 0.0, snowAge)
        hIce = jnp.where(has, hIce, 0.0)
        hSnow = jnp.where(has, hSnow, 0.0)
        snowAge = jnp.where(has, snowAge, 0.0)
        tSrf = jnp.where(has, tSrf, tOceMxL)
        tIc1 = jnp.where(has, tIc1, 0.0)
        tIc2 = jnp.where(has, tIc2, 0.0)
        q1 = jnp.where(has, q1, p.Lfresh)
        q2 = jnp.where(has, q2, p.Lfresh)

        sIceLoad = (hSnow * p.rhos + hIce * p.rhoi) * iceMask

        fl = self.fill
        th_out = {"thIceMask": fl(iceMask), "thIceH": fl(hIce),
                  "thSnowH": fl(hSnow), "thSnowAge": fl(snowAge),
                  "thTsrf": fl(tSrf), "thTice1": fl(tIc1),
                  "thTice2": fl(tIc2), "thQice1": fl(q1),
                  "thQice2": fl(q2)}
        upd = {"Qnet": fl(Qnet), "Qsw": fl(Qsw), "EmPmR": fl(EmPmR),
               "saltFlux": fl(saltFlux), "sIceLoad": sIceLoad}
        return th_out, upd

    # ------------------------------------------------------------------
    def monitor(self, th, area_fn=None):
        """thsice_monitor.F %MON thSI_* statistics.

        Stats use MON_STATS_LATBND_RL (mon_stats_latbnd_rl.F:98-143):
        volume weight rA*maskInC*iceMask (continuous fraction), latitude
        bands split at yC>0 (NLATBND: band N iff yLoc > 0), min/max
        unweighted over mask!=0 interior cells.  Tic1/2 use the weight
        iceMask*iceHeight (thsice_monitor.F:193).  TotEnerg_G =
        -rhos*Lfresh*Sum(w*hSnow) - rhoi/2*Sum(w*hIce*(Q1+Q2))
        (thsice_monitor.F:155,251-257)."""
        g = self.grid
        cfg = self.cfg
        p = self.p
        oly, olx = cfg.oly, cfg.olx
        nyp = cfg.ny + 2 * oly
        it = jnp.zeros_like(g.rA)
        for f in range(cfg.nFaces):
            it = it.at[f * nyp + oly:f * nyp + oly + cfg.ny,
                       olx:olx + cfg.nx].set(1.0)
        base = g.rA * self.maskC0 * it
        north = jnp.where(g.yC > 0.0, 1.0, 0.0)
        south = 1.0 - north
        m = th["thIceMask"]

        def bands(fld, wmask):
            """(min_S, min_N, max_S, max_N, mean_G, mean_S, mean_N,
            vol_S, vol_N) with vol weight base*wmask."""
            w = base * wmask
            volS = jnp.sum(w * south)
            volN = jnp.sum(w * north)
            sumS = jnp.sum(w * fld * south)
            sumN = jnp.sum(w * fld * north)
            meanS = jnp.where(volS > 0.0, sumS / jnp.where(volS > 0, volS,
                                                           1.0), 0.0)
            meanN = jnp.where(volN > 0.0, sumN / jnp.where(volN > 0, volN,
                                                           1.0), 0.0)
            volG = volS + volN
            meanG = jnp.where(volG > 0.0, (sumS + sumN)
                              / jnp.where(volG > 0, volG, 1.0), 0.0)
            sel = (wmask != 0.0) & (it != 0.0)
            big = jnp.asarray(1e38, fld.dtype)

            def mnmx(selh, volh):
                has = jnp.any(selh)
                mn = jnp.min(jnp.where(selh, fld, big))
                mx = jnp.max(jnp.where(selh, fld, -big))
                mn = jnp.where(has & (volh > 0.0), mn, 0.0)
                mx = jnp.where(has & (volh > 0.0), mx, 0.0)
                return mn, mx
            mnS, mxS = mnmx(sel & (south != 0.0), volS)
            mnN, mxN = mnmx(sel & (north != 0.0), volN)
            return (mnS, mnN, mxS, mxN, meanG, meanS, meanN, volS, volN)

        out = {}
        (_, _, mxS, mxN, meanG, meanS, meanN, volS, volN) = bands(
            th["thIceH"], m)
        out["thSI_Ice_Area_G"] = volS + volN
        out["thSI_Ice_Area_S"] = volS
        out["thSI_Ice_Area_N"] = volN
        out["thSI_IceH_ave_G"] = meanG
        out["thSI_IceH_ave_S"] = meanS
        out["thSI_IceH_ave_N"] = meanN
        out["thSI_IceH_max_S"] = mxS
        out["thSI_IceH_max_N"] = mxN

        (_, _, mxS, mxN, meanG, meanS, meanN, volS, volN) = bands(
            th["thSnowH"], m)
        snow_sum = meanG * (volS + volN)
        out["thSI_SnwH_ave_G"] = meanG
        out["thSI_SnwH_ave_S"] = meanS
        out["thSI_SnwH_ave_N"] = meanN
        out["thSI_SnwH_max_S"] = mxS
        out["thSI_SnwH_max_N"] = mxN

        (mnS, mnN, mxS, mxN, meanG, meanS, meanN, _, _) = bands(
            th["thTsrf"], m)
        out["thSI_Tsrf_ave_G"] = meanG
        out["thSI_Tsrf_ave_S"] = meanS
        out["thSI_Tsrf_ave_N"] = meanN
        out["thSI_Tsrf_min_S"] = mnS
        out["thSI_Tsrf_min_N"] = mnN
        out["thSI_Tsrf_max_S"] = mxS
        out["thSI_Tsrf_max_N"] = mxN

        mh = m * th["thIceH"]
        for lev, (tnm, qfld) in enumerate(
                ((("Tic1"), th["thTice1"]), (("Tic2"), th["thTice2"]))):
            (mnS, mnN, mxS, mxN, meanG, meanS, meanN, _, _) = bands(
                qfld, mh)
            out[f"thSI_{tnm}_ave_G"] = meanG
            out[f"thSI_{tnm}_ave_S"] = meanS
            out[f"thSI_{tnm}_ave_N"] = meanN
            out[f"thSI_{tnm}_min_S"] = mnS
            out[f"thSI_{tnm}_min_N"] = mnN
            out[f"thSI_{tnm}_max_S"] = mxS
            out[f"thSI_{tnm}_max_N"] = mxN

        wmh = base * mh
        out["thSI_TotEnerg_G"] = (
            -p.rhos * p.Lfresh * snow_sum
            - p.rhoi * 0.5 * jnp.sum(wmh * (th["thQice1"] + th["thQice2"])))
        return out
