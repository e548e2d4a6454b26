"""pkg/seaice: dynamic-thermodynamic sea ice (C-grid, VP/LSR).

Reference call sequence (pkg/seaice/seaice_model.F, lab_sea build:
SEAICE_CGRID + SEAICE_EXTERNAL_FLUXES + ALLOW_SITRACER + SEAICE_LSR_ZEBRA):

  SEAICE_DYNSOLVER   seaice_dynsolver.F:9
    SEAICE_GET_DYNFORCING (wind stress on ice)   seaice_get_dynforcing.F
    ice strength PRESS0, masses, tilt force
    SEAICE_LSR (Picard + zebra line-SOR)          seaice_lsr.F:24
    SEAICE_OCEAN_STRESS (ice-ocean -> fu/fv)      seaice_ocean_stress.F
  SEAICE_ADVDIFF (multidim OS7MP on HEFF/AREA/HSNOW/SItr) seaice_advdiff.F
  SEAICE_REG_RIDGE (regularize/ridge)             seaice_reg_ridge.F
  SEAICE_GROWTH (0-layer thermo, multDim categories) seaice_growth.F:15
    SEAICE_BUDGET_OCEAN (open water: exf fluxes)  seaice_budget_ocean.F
    SEAICE_SOLVE4TEMP (ice surface temperature)   seaice_solve4temp.F:13
  SEAICE_TRACER_PHYS (SItracer sources)           seaice_tracer_phys.F

All 2-D fields are [nyp, nxp] in the model halo layout; interior is
[ol:ol+ny, ol:ol+nx].  Every reference i-1/j-1 neighbour access maps to
sh(a, di=-1)/sh(a, dj=-1) on the cyclic-halo arrays.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import cyclic_fill_halo, shift as sh


# ----------------------------------------------------------------------
# parameters (defaults = seaice_readparms.F as echoed by the reference
# lab_sea run, results/output.txt "Seaice configuration" block)
# ----------------------------------------------------------------------

@dataclass
class SeaiceParams:
    deltaTtherm: float = 0.0       # set from deltaTClock
    deltaTdyn: float = 0.0
    useDYNAMICS: bool = True
    updateOceanStress: bool = True
    rhoIce: float = 910.0
    rhoSnow: float = 330.0
    rhoAir: float = 1.2
    OCEAN_drag: float = 1.0e-3
    drag: float = 1.0e-3
    drag_south: float = 1.0e-3
    waterDrag: float = 5.5404e-3 * 0.0 + 5.5404e-3  # overridden by nml
    waterDrag_south: float = 5.5404e-3
    dWatMin: float = 0.25
    basalDragK2: float = 0.0
    useTilt: bool = True
    strength: float = 2.75e4
    cStar: float = 20.0
    pressReplFac: float = 1.0
    tensilFac: float = 0.0
    etaZmethod: int = 3            # seaice_readparms.F:318 default
    zetaMaxFac: float = 2.5e8
    zetaMin: float = 0.0
    eccen: float = 2.0
    stressFactor: float = 1.0
    airTurnAngle: float = 0.0
    waterTurnAngle: float = 0.0
    useMetricTerms: bool = True
    no_slip: bool = False
    scaleSurfStress: bool = True   # seaice_readparms.F:262 default
    maskRHS: bool = False
    addSnowMass: bool = True
    LSRrelaxU: float = 0.95
    LSRrelaxV: float = 0.95
    LSR_ERROR: float = 1.0e-12     # readparms default; lab_sea sets 1e-4
    SOLV_NCHECK: int = 2
    nonLinIterMax: int = 2
    linearIterMax: int = 1500
    advHeff: bool = True
    advArea: bool = True
    advSnow: bool = True
    advScheme: int = 77
    # per-field schemes/diffusivities default UNSET (-1) and resolve via
    # the seaice_readparms.F:995-1019 cascade in params_from_namelists
    advSchArea: int = -1
    advSchHeff: int = -1
    advSchSnow: int = -1
    advSchSalt: int = -1
    diffKhArea: float = -1.0
    diffKhHeff: float = -1.0
    diffKhSnow: float = -1.0
    diffKhSalt: float = -1.0
    useFreeDrift: bool = False     # SEAICEuseFREEDRIFT (seaice_freedrift.F)
    restoreUnderIce: bool = False  # SEAICErestoreUnderIce
    LSR_mixIniGuess: int = -1      # LSR initial-guess mode (seaice_lsr.F)
    saltFrac: float = 0.0          # SEAICE_saltFrac (HSALT init/growth)
    # --- EVP (seaice_evp.F + readparms derivation :748-820) ---
    useEVP: bool = False           # derived from the three triggers
    deltaTevp: float = -1.0        # SEAICE_deltaTevp (UNSET=-1)
    evpAlpha: float = -1.0         # SEAICE_evpAlpha
    evpBeta: float = -1.0          # SEAICE_evpBeta
    elasticParm: float = 1.0 / 3.0  # SEAICE_elasticParm
    evpTauRelax: float = -1.0      # SEAICE_evpTauRelax
    nEVPstarSteps: int = -1        # SEAICEnEVPstarSteps
    useEVPstar: bool = True        # SEAICEuseEVPstar (readparms:254)
    useEVPrev: bool = True         # SEAICEuseEVPrev (readparms:255)
    aEVPcoeff: float = -1.0        # SEAICEaEVPcoeff (UNSET=-1 -> no aEVP)
    aEVPcStar: float = 4.0         # SEAICEaEVPcStar
    aEVPalphaMin: float = 5.0      # SEAICEaEVPalphaMin
    useHB87stressCoupling: bool = False
    # initial-condition files (seaice_init_varia.F:285-367)
    AreaFile: str = ""
    HeffFile: str = ""
    HsnowFile: str = ""
    uIceFile: str = ""
    vIceFile: str = ""
    useFluxForm: bool = True       # SEAICEuseFluxForm (advect.F / diffus.F)
    DIFF1: float = 0.0             # legacy harmonic+biharmonic diffusion
    lhEvap: float = 2.5e6
    lhFusion: float = 3.34e5
    mcPheePiston: float = 0.0      # derived: STANTON*USTAR if unset
    mcPheeTaper: float = 0.0
    mcPheeStepFunc: bool = False
    frazilFrac: float = 1.0
    tempFrz0: float = 0.0901
    dTempFrz_dS: float = -0.0575
    growMeltByConv: bool = False
    doOpenWaterGrowth: bool = True
    doOpenWaterMelt: bool = False
    useStrImpCpl: bool = False     # SEAICEuseStrImpCpl (LSR implicit cpl)
    clipVelocities: bool = False   # SEAICE_clipVelocities (cap at 0.4m/s)
    areaGainFormula: int = 1
    areaLossFormula: int = 1
    HO: float = 0.5
    HO_south: float = 0.5
    area_max: float = 1.0
    salt0: float = 0.0
    useFlooding: bool = True
    heatConsFix: bool = False
    multDim: int = 1
    useMultDimSnow: bool = False
    IMAX_TICE: int = 10
    postSolvTempIter: int = 2
    dryIceAlb: float = 0.75
    wetIceAlb: float = 0.66
    drySnowAlb: float = 0.84
    wetSnowAlb: float = 0.70
    dryIceAlb_south: float = 0.75
    wetIceAlb_south: float = 0.66
    drySnowAlb_south: float = 0.84
    wetSnowAlb_south: float = 0.70
    wetAlbTemp: float = -1.0e-3
    snow_emiss: float = 0.95
    ice_emiss: float = 0.95
    boltzmann: float = 5.67e-8
    cpAir: float = 1005.0
    dalton: float = 1.75e-3
    iceConduct: float = 2.1656
    snowConduct: float = 0.31
    snowThick: float = 0.15
    shortwave: float = 0.30
    useMaykutSatVapPoly: bool = False
    MIN_ATEMP: float = -50.0
    MIN_LWDOWN: float = 60.0
    MIN_TICE: float = -50.0
    deltaMin: float = 1.0e-10      # lab_sea echo (SEAICE_deltaMin)
    EPS: float = 1.0e-10
    area_reg: float = 1.0e-5
    hice_reg: float = 0.05
    area_floor: float = 1.0e-5
    SItrNumInUse: int = 0
    SItrName: tuple = ()
    SItrMate: tuple = ()
    SItrFromOcean0: tuple = ()
    SItrFromFlood0: tuple = ()
    SItrExpand0: tuple = ()
    # PDF over thickness categories
    pdf: tuple = ()

    @property
    def EPS_SQ(self):
        return self.EPS * self.EPS


_NML_MAP = {
    "seaice_no_slip": "no_slip", "seaice_salt0": "salt0",
    "seaiceadvscheme": "advScheme", "seaice_multdim": "multDim",
    "seaice_wetalbtemp": "wetAlbTemp", "seaice_mcpheetaper": "mcPheeTaper",
    "seaicescalesurfstress": "scaleSurfStress",
    "seaiceaddsnowmass": "addSnowMass",
    "seaice_usemultdimsnow": "useMultDimSnow",
    "seaiceetazmethod": "etaZmethod",
    "seaice_waterdrag": "waterDrag", "lsr_error": "LSR_ERROR",
    "seaice_strength": "strength", "seaice_drag": "drag",
    "ocean_drag": "OCEAN_drag", "seaice_deltamin": "deltaMin",
    "seaice_deltattherm": "deltaTtherm", "seaice_deltatdyn": "deltaTdyn",
    "seaice_rhoice": "rhoIce", "seaice_rhosnow": "rhoSnow",
    "seaicepressreplfac": "pressReplFac",
    "seaice_mcpheepiston": "mcPheePiston",
    "seaice_dryicealb": "dryIceAlb", "seaice_weticealb": "wetIceAlb",
    "seaice_drysnowalb": "drySnowAlb", "seaice_wetsnowalb": "wetSnowAlb",
    "seaice_tempfrz0": "tempFrz0", "seaice_dtempfrz_ds": "dTempFrz_dS",
    "seaice_area_max": "area_max", "seaice_area_reg": "area_reg",
    "seaice_hice_reg": "hice_reg", "seaicewritestate": None,
    "seaice_olx": None, "seaice_oly": None,
    "seaice_monfreq": None, "seaice_waterturnangle": "waterTurnAngle",
    "seaice_airturnangle": "airTurnAngle",
    "seaice_arealossformula": "areaLossFormula",
    "seaice_areagainformula": "areaGainFormula",
    "seaiceusestrimpcpl": "useStrImpCpl",
    "seaice_clipvelocities": "clipVelocities",
    "seaiceheatconsfix": "heatConsFix",
    "seaicedoopenwatergrowth": "doOpenWaterGrowth",
    "seaicedoopenwatermelt": "doOpenWaterMelt",
    "seaice_tempfrz_ds": "dTempFrz_dS",
    "seaiceusefreedrift": "useFreeDrift",
    "seaiceadvscharea": "advSchArea", "seaiceadvschheff": "advSchHeff",
    "seaiceadvschsnow": "advSchSnow", "seaiceadvschsalt": "advSchSalt",
    "seaicediffkharea": "diffKhArea", "seaicediffkhheff": "diffKhHeff",
    "seaicediffkhsnow": "diffKhSnow", "seaicediffkhsalt": "diffKhSalt",
    "seaice_frazilfrac": "frazilFrac",
    "seaice_deltatevp": "deltaTevp", "seaice_evpalpha": "evpAlpha",
    "seaice_evpbeta": "evpBeta", "seaice_elasticparm": "elasticParm",
    "seaice_evptaurelax": "evpTauRelax",
    "seaicenevpstarsteps": "nEVPstarSteps",
    "seaiceuseevpstar": "useEVPstar", "seaiceuseevprev": "useEVPrev",
    "seaiceaevpcoeff": "aEVPcoeff", "seaiceaevpcstar": "aEVPcStar",
    "seaiceaevpalphamin": "aEVPalphaMin",
    "usehb87stresscoupling": "useHB87stressCoupling",
    "seaiceusefluxform": "useFluxForm", "diff1": "DIFF1",
    "seaiceusedynamics": "useDYNAMICS",
    "seaicerestoreunderice": "restoreUnderIce",
    "seaicelinearitermax": "linearIterMax",
    "lsr_mixiniguess": "LSR_mixIniGuess",
    "seaice_area_floor": "area_floor",
    "seaice_saltfrac": "saltFrac",
    "areafile": "AreaFile", "hefffile": "HeffFile",
    "hsnowfile": "HsnowFile", "hsaltfile": None,
    "uicefile": "uIceFile", "vicefile": "vIceFile",
}


def params_from_namelists(cfg: Config, nml01: dict, nml03: dict
                          ) -> SeaiceParams:
    """data.seaice SEAICE_PARM01 + SEAICE_PARM03 -> SeaiceParams,
    with the derived defaults of seaice_readparms.F / seaice_check.F."""
    p = SeaiceParams()
    for k, v in nml01.items():
        kk = k.lower()
        if kk in _NML_MAP:
            tgt = _NML_MAP[kk]
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
        # silently keep unknowns out: seaice_check.F validates; the
        # config-check slice will make this loud
    # advection-scheme / diffusivity cascade (seaice_readparms.F:995-1019)
    if p.advSchArea < 0:
        p.advSchArea = p.advSchHeff
    if p.advSchArea < 0:
        p.advSchArea = p.advScheme
    p.advScheme = p.advSchArea
    if p.advSchHeff < 0:
        p.advSchHeff = p.advSchArea
    if p.advSchSnow < 0:
        p.advSchSnow = p.advSchHeff
    if p.advSchSalt < 0:
        p.advSchSalt = p.advSchHeff
    if p.diffKhArea < 0:
        p.diffKhArea = p.diffKhHeff
    if p.diffKhArea < 0:
        p.diffKhArea = 0.0
    if p.diffKhHeff < 0:
        p.diffKhHeff = p.diffKhArea
    if p.diffKhSnow < 0:
        p.diffKhSnow = p.diffKhHeff
    if p.diffKhSalt < 0:
        p.diffKhSalt = p.diffKhHeff
    if p.deltaTtherm == 0.0:
        p.deltaTtherm = cfg.deltaTClock
    if p.deltaTdyn == 0.0:
        p.deltaTdyn = p.deltaTtherm
    if p.waterDrag_south == SeaiceParams.waterDrag_south:
        p.waterDrag_south = p.waterDrag
    if p.drag_south == SeaiceParams.drag_south:
        p.drag_south = p.drag
    # EVP triggers + derived parameters (seaice_readparms.F:748-820)
    p.useEVP = (p.deltaTevp > 0.0 or p.evpAlpha > 0.0 or p.evpBeta > 0.0
                or p.aEVPcoeff > 0.0)
    if p.useEVP:
        if p.evpTauRelax <= 0.0:
            p.evpTauRelax = p.deltaTdyn * p.elasticParm
        if p.nEVPstarSteps < 0:
            if p.deltaTevp <= 0.0:
                raise ValueError("SEAICEnEVPstarSteps or SEAICE_deltaTevp "
                                 "must be set for EVP")
            p.nEVPstarSteps = int(p.deltaTdyn / p.deltaTevp)
        if p.evpAlpha > 0.0 and p.evpBeta <= 0.0:
            p.evpBeta = p.evpAlpha
        if p.evpBeta > 0.0 and p.evpAlpha <= 0.0:
            p.evpAlpha = p.evpBeta
        if p.evpBeta <= 0.0:
            p.evpBeta = p.deltaTdyn / p.deltaTevp
        else:
            p.deltaTevp = p.deltaTdyn / p.evpBeta
        if p.evpAlpha <= 0.0:
            p.evpAlpha = 2.0 * p.evpTauRelax / p.deltaTevp
        else:
            p.evpTauRelax = 0.5 * p.evpAlpha * p.deltaTevp
        if p.aEVPcoeff > 0.0:
            # adaptive EVP: alpha/beta computed per-cell each subcycle
            p.evpAlpha = -1.0
            p.evpBeta = -1.0
    if p.useFreeDrift:
        p.useEVP = False
    if p.mcPheePiston == 0.0:
        # seaice_init_fixed.F:92-104: MCPHEE_TAPER_FAC*STANTON*USTAR
        # capped by dzSurf/deltaTtherm; dzSurf in meters (p-coords:
        # drF(kSrf)/(rhoConst*g), seaice_init_fixed.F:93-95)
        if cfg.usingPCoords:
            dzSurf = cfg.delR[cfg.nr - 1] / (cfg.rhoConst * cfg.gravity)
        else:
            dzSurf = cfg.delR[0]
        p.mcPheePiston = min(12.5 * 0.0056 * 0.0125,
                             dzSurf / p.deltaTtherm)
    if not p.pdf:
        p.pdf = tuple([1.0 / p.multDim] * p.multDim)
    # SEAICE_PARM03 tracers
    n = int(nml03.get("sitrnuminuse", 0))
    p.SItrNumInUse = n
    names, mates = [], []
    fo0, ff0, ex0 = [], [], []
    for i in range(1, n + 1):
        names.append(str(nml03.get(f"sitrname({i})", "")).strip())
        mates.append(str(nml03.get(f"sitrmate({i})", "HEFF")).strip()
                     or "HEFF")
        fo0.append(float(nml03.get(f"sitrfromocean0({i})", 0.0)))
        ff0.append(float(nml03.get(f"sitrfromflood0({i})", 0.0)))
        ex0.append(float(nml03.get(f"sitrexpand0({i})", 0.0)))
    p.SItrName, p.SItrMate = tuple(names), tuple(mates)
    # seaice_init_fixed.F:116-124: the 'one' tracer sources are 1
    for i, nm in enumerate(names):
        if nm == "one":
            fo0[i] = 1.0
            ff0[i] = 1.0
            ex0[i] = 1.0
    p.SItrFromOcean0, p.SItrFromFlood0 = tuple(fo0), tuple(ff0)
    p.SItrExpand0 = tuple(ex0)
    return p


class IceState(NamedTuple):
    """Prognostic sea-ice state (SEAICE.h common blocks)."""
    uIce: jnp.ndarray
    vIce: jnp.ndarray
    AREA: jnp.ndarray
    HEFF: jnp.ndarray
    HSNOW: jnp.ndarray
    HSALT: jnp.ndarray
    TICES: jnp.ndarray      # [multDim, nyp, nxp]
    SItracer: jnp.ndarray   # [nTr, nyp, nxp]
    # EVP internal stresses seaice_sigma1/2/12 (SEAICE.h), stacked [3,...];
    # persistent across model steps (and in EVP pickups upstream)
    sigma: jnp.ndarray = None


# ----------------------------------------------------------------------
# OS7MP flux kernel: shared with the ocean tracers — the canonical
# implementation lives in gad.py (gad_os7mp_adv_x/y.F)
# ----------------------------------------------------------------------

from mitgcm_tpu.model.gad import (  # noqa: E402
    os7mp_psi as _os7mp_flux, os7mp_flux_x, os7mp_flux_y)


# ----------------------------------------------------------------------
# the package
# ----------------------------------------------------------------------

class SeaIce:
    def __init__(self, cfg: Config, grid: Grid, p: SeaiceParams,
                 fills=None):
        self.cfg = cfg
        self.grid = grid
        self.p = p
        ol, ny, nx = cfg.olx, cfg.ny, cfg.nx
        self.ol, self.ny, self.nx = ol, ny, nx
        self.cs = cfg.onCubeFace
        self._fills = fills
        # masks (seaice_init_fixed.F:266 + init_varia.F:190) at the
        # SURFACE level (kSurface = Nr under p-coords)
        ks = cfg.ksurf0
        self.HEFFM = grid.maskC[ks]
        self.SIMaskU = grid.maskW[ks]
        self.SIMaskV = grid.maskS[ks]
        hm = self.HEFFM
        self.seaiceMaskU = jnp.where(hm + sh(hm, di=-1) > 1.5, 1.0, 0.0)
        self.seaiceMaskV = jnp.where(hm + sh(hm, dj=-1) > 1.5, 1.0, 0.0)
        # metric factors k1/k2 (seaice_init_fixed.F:292-330)
        z = jnp.zeros_like(grid.rA)
        if cfg.usingSphericalPolarGrid and p.useMetricTerms:
            rr = 1.0 / cfg.rSphere
            self.k1AtC, self.k1AtZ = z, z
            self.k2AtC = -grid.tanPhiAtU * rr
            self.k2AtZ = -grid.tanPhiAtV * rr
        elif cfg.usingCurvilinearGrid and p.useMetricTerms:
            self.k1AtC = (grid.recip_dyF * (sh(grid.dyG, di=1) - grid.dyG)
                          * grid.recip_dxF)
            self.k1AtZ = (grid.recip_dyU * (grid.dyC - sh(grid.dyC, di=-1))
                          * grid.recip_dxV)
            self.k2AtC = (grid.recip_dxF * (sh(grid.dxG, dj=1) - grid.dxG)
                          * grid.recip_dyF)
            self.k2AtZ = (grid.recip_dxV * (grid.dxC - sh(grid.dxC, dj=-1))
                          * grid.recip_dyU)
        else:
            self.k1AtC = self.k1AtZ = self.k2AtC = self.k2AtZ = z
        # OS7MP / gad flux write bands (kernel i/j loop limits);
        # per face-block on the cubed sphere (stacked-face layout)
        nxp = nx + 2 * ol
        nypf = ny + 2 * ol
        bx = np.zeros((1, nxp)); bx[0, 4:nxp - 3] = 1.0
        by = np.zeros((cfg.nFaces, nypf, 1))
        by[:, 4:nypf - 3, :] = 1.0
        self.band7x = jnp.asarray(bx)
        self.band7y = jnp.asarray(by.reshape(cfg.nFaces * nypf, 1))
        it = np.zeros((cfg.nFaces, nypf, nxp))
        it[:, ol:ol + ny, ol:ol + nx] = 1.0
        self.interior = jnp.asarray(it.reshape(cfg.nFaces * nypf, nxp))
        if fills is not None:
            # cubed sphere: scalar exchange + C-grid vector pair with
            # signs (EXCH_UV_XY_RL(.TRUE.), seaice_lsr.F:656)
            self.fill = fills.fill
            self.fill_uv = lambda u, v: fills.fill_uv(u, v, True)
        else:
            self.fill = lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)
            self.fill_uv = lambda u, v: (self.fill(u), self.fill(v))
        # SEAICE_SWFrac (seaice_init_fixed.F:71-87 + model/src/swfrac.F
        # jwtype=2): shortwave fraction below the surface layer; under
        # p-coords the layer bottom depth is -rF(Nr)/(rhoConst*g) [m]
        rfac, a1, a2 = 0.62, 0.6, 20.0
        if cfg.usingZCoords:
            z2 = float(np.asarray(grid.rF)[1])
        else:
            z2 = -float(np.asarray(grid.rF)[cfg.nr - 1]) \
                / (cfg.rhoConst * cfg.gravity)
        self.SWFrac = (rfac * math.exp(z2 / a1)
                       + (1.0 - rfac) * math.exp(z2 / a2))
        # maskInC with halos filled the way the reference's exchanged
        # maskInC looks (halo = neighbour interior = 1)
        self.maskInCx = self.fill(grid.maskInC)

    # ------------------------------------------------------------------
    def init_state(self, dtype=jnp.float64) -> IceState:
        cfg = self.cfg
        nyp = cfg.nFaces * (cfg.ny + 2 * cfg.oly)
        nxp = cfg.nx + 2 * cfg.olx
        z2 = jnp.zeros((nyp, nxp), dtype)
        tice = jnp.full((self.p.multDim, nyp, nxp), 273.0, dtype)
        ntr = max(self.p.SItrNumInUse, 0)
        sitr = jnp.zeros((ntr, nyp, nxp), dtype)
        for i, nm in enumerate(self.p.SItrName):
            if nm == "one":
                sitr = sitr.at[i].set(1.0)
        sig = jnp.zeros((3, nyp, nxp), dtype) if self.p.useEVP else \
            jnp.zeros((0, nyp, nxp), dtype)
        return IceState(uIce=z2, vIce=z2, AREA=z2, HEFF=z2, HSNOW=z2,
                        HSALT=z2, TICES=tice, SItracer=sitr, sigma=sig)

    # ------------------------------------------------------------------
    # dynamics
    # ------------------------------------------------------------------
    def get_dynforcing(self, ice: IceState, forc):
        """seaice_get_dynforcing.F (EXTERNAL_FLUXES): surface wind
        stress over ice (C-grid).  With useEXF+useAtmWind the quadratic
        ice-drag law applies to the wind; otherwise (stress read
        directly, seaice_get_dynforcing.F:223-237) the ocean stress is
        rescaled by SEAICE_drag/OCEAN_drag."""
        p = self.p
        g = self.grid
        if not (self.cfg.useEXF and self.cfg.exf_useAtmWind):
            cdair = jnp.where(g.yC < 0.0, p.drag_south / p.OCEAN_drag,
                              p.drag / p.OCEAN_drag)
            taux = cdair * forc.fu * self.SIMaskU
            tauy = cdair * forc.fv * self.SIMaskV
            return taux, tauy
        sinw = math.sin(math.radians(p.airTurnAngle))
        cosw = math.cos(math.radians(p.airTurnAngle))
        u, v = forc.uwind, forc.vwind
        aaa = u * u + v * v
        aaa = jnp.where(aaa <= p.EPS_SQ, p.EPS, jnp.sqrt(aaa))
        cdair = jnp.where(g.yC < 0.0, p.rhoAir * p.drag_south * aaa,
                          p.rhoAir * p.drag * aaa)
        sgn = jnp.sign(g.fCori)
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)
        tx = cdair * (cosw * u - sgn * sinw * v)
        ty = cdair * (sgn * sinw * u + cosw * v)
        taux = 0.5 * (tx + sh(tx, di=-1)) * self.SIMaskU
        tauy = 0.5 * (ty + sh(ty, dj=-1)) * self.SIMaskV
        return taux, tauy

    def strainrates(self, uFld, vFld):
        """seaice_calc_strainrates.F (C-grid, noSlip optional)."""
        g = self.grid
        p = self.p
        dudx = g.recip_dxF * (sh(uFld, di=1) - uFld)
        uavC = 0.5 * (uFld + sh(uFld, di=1))
        dvdy = g.recip_dyF * (sh(vFld, dj=1) - vFld)
        vavC = 0.5 * (vFld + sh(vFld, dj=1))
        # OBCS_UVICE_OLD build (no pkg/obcs): no maskInC factor
        e11 = dudx + vavC * self.k2AtC
        e22 = dvdy + uavC * self.k1AtC
        dudy = (uFld - sh(uFld, dj=-1)) * g.recip_dyU
        uavZ = 0.5 * (uFld + sh(uFld, dj=-1))
        dvdx = (vFld - sh(vFld, di=-1)) * g.recip_dxV
        vavZ = 0.5 * (vFld + sh(vFld, di=-1))
        hm = self.HEFFM
        hm4 = (hm * sh(hm, di=-1) * sh(hm, dj=-1)
               * sh(sh(hm, di=-1), dj=-1))
        noslip = 1.0 if p.no_slip else 0.0
        hFacU = self.SIMaskU - sh(self.SIMaskU, dj=-1)
        hFacV = self.SIMaskV - sh(self.SIMaskV, di=-1)
        e12 = (0.5 * (dudy + dvdx - self.k1AtZ * vavZ - self.k2AtZ * uavZ)
               * hm4
               + noslip * (2.0 * uavZ * g.recip_dyU * hFacU
                           + 2.0 * vavZ * g.recip_dxV * hFacV))
        return e11, e22, e12

    def viscosities(self, e11, e22, e12, press0, zMax, zMin):
        """seaice_calc_viscosities.F (elliptical yield curve)."""
        p = self.p
        g = self.grid
        recip_e2 = 1.0 / (p.eccen * p.eccen)
        # eccfr unset -> normal flow rule: recip_efr2=1/e^2, efr4=e^2/e^4
        recip_efr2 = recip_e2
        recip_efr4 = recip_e2
        if p.etaZmethod == 3:
            # default method (seaice_calc_viscosities.F:126-136):
            # area-weighted mean of e12^2 over the 4 surrounding Z points
            e12Csq = 0.25 * g.recip_rA * (
                g.rAz * e12 ** 2
                + sh(g.rAz * e12 ** 2, di=1)
                + sh(g.rAz * e12 ** 2, dj=1)
                + sh(sh(g.rAz * e12 ** 2, di=1), dj=1))
        else:
            e12sum = (e12 + sh(e12, di=1) + sh(e12, dj=1)
                      + sh(sh(e12, di=1), dj=1))
            e12Csq = (0.25 * e12sum) ** 2
        ep = e11 + e22
        em = e11 - e22
        shearDefSq = em * em + 4.0 * e12Csq
        deltaCsq = ep * ep + recip_efr4 * shearDefSq
        deltaC = jnp.sqrt(deltaCsq)
        deltaCreg = jnp.maximum(deltaC, p.deltaMin)
        tns = 0.0   # tensilFac = 0
        zeta = 0.5 * press0 * (1.0 + tns) / deltaCreg
        zeta = jnp.minimum(zMax, zeta)
        zeta = jnp.maximum(zMin, zeta)
        zeta = zeta * self.HEFFM
        press = (press0 * (1.0 - p.pressReplFac)
                 + 2.0 * zeta * deltaC * p.pressReplFac / (1.0 + tns)
                 ) * (1.0 - tns)
        eta = zeta * recip_efr2
        hm = self.HEFFM
        sumNorm = (hm + sh(hm, di=-1) + sh(hm, dj=-1)
                   + sh(sh(hm, di=-1), dj=-1))
        sumNorm = jnp.where(sumNorm > 0.0, 1.0 / jnp.where(
            sumNorm > 0.0, sumNorm, 1.0), 0.0)
        etaZ = sumNorm * (eta + sh(eta, di=-1) + sh(eta, dj=-1)
                          + sh(sh(eta, di=-1), dj=-1))
        zetaZ = sumNorm * (zeta + sh(zeta, di=-1) + sh(zeta, dj=-1)
                           + sh(sh(zeta, di=-1), dj=-1))
        if not p.no_slip:
            # free slip = no lateral stress: mask eta/zeta at Z points
            # next to any dry cell (seaice_calc_viscosities.F:467-476)
            maskZ = (hm * sh(hm, di=-1) * sh(hm, dj=-1)
                     * sh(sh(hm, di=-1), dj=-1))
            etaZ = etaZ * maskZ
            zetaZ = zetaZ * maskZ
        return eta, etaZ, zeta, zetaZ, press, deltaC

    def oceandrag(self, uIceC, vIceC, uVel0, vVel0):
        """seaice_oceandrag_coeffs.F: quadratic ice-ocean drag DWATN."""
        p = self.p
        g = self.grid
        cfgrho = self.cfg.rhoConst
        du = (uIceC - uVel0) * g.maskInW
        dv = (vIceC - vVel0) * g.maskInS
        tempVar = 0.25 * ((du + sh(du, di=1)) ** 2
                          + (dv + sh(dv, dj=1)) ** 2)
        dragCoeff = jnp.where(g.yC < 0.0, p.waterDrag_south * cfgrho,
                              p.waterDrag * cfgrho)
        tempMin = p.dWatMin * p.dWatMin
        cw = jnp.where(dragCoeff * dragCoeff * tempVar > tempMin,
                       dragCoeff * jnp.sqrt(tempVar), p.dWatMin)
        return cw * self.HEFFM

    def _lsr_rhs_u(self, zme, epz, etaZ, zetaZ, press, uC, vC):
        """SEAICE_LSR_RHSU (seaice_lsr.F:1586): div of sigma(vIceC)."""
        g = self.grid
        hm = self.HEFFM
        sig11 = (zme * (sh(vC, dj=1) - vC) * g.recip_dyF
                 + epz * self.k2AtC * 0.5 * (sh(vC, dj=1) + vC)
                 - 0.5 * press)
        hm4 = (hm * sh(hm, di=-1) * sh(hm, dj=-1)
               * sh(sh(hm, di=-1), dj=-1))
        hFacM = self.seaiceMaskV - sh(self.seaiceMaskV, di=-1)
        sig12 = (etaZ * ((vC - sh(vC, di=-1)) * g.recip_dxV
                         - self.k1AtZ * 0.5 * (vC + sh(vC, di=-1))) * hm4
                 + etaZ * g.recip_dxV * (vC + sh(vC, di=-1))
                 * hFacM * 2.0)
        if self.p.useStrImpCpl:
            # explicit -zetaZ*dv/dx counterpart of the implicit coupling
            # term (seaice_lsr.F:1795-1820; metric terms cancel)
            sig12 = sig12 - zetaZ * ((vC - sh(vC, di=-1))
                                     * g.recip_dxV) * hm4 \
                - zetaZ * g.recip_dxV * (vC + sh(vC, di=-1)) * hFacM * 2.0
        return (g.recip_rAw * self.seaiceMaskU *
                (g.dyF * sig11 - sh(g.dyF * sig11, di=-1)
                 + sh(g.dxV * sig12, dj=1) - g.dxV * sig12))

    def _lsr_rhs_v(self, zme, epz, etaZ, zetaZ, press, uC, vC):
        g = self.grid
        hm = self.HEFFM
        sig22 = (zme * (sh(uC, di=1) - uC) * g.recip_dxF
                 + epz * self.k1AtC * 0.5 * (sh(uC, di=1) + uC)
                 - 0.5 * press)
        hm4 = (hm * sh(hm, di=-1) * sh(hm, dj=-1)
               * sh(sh(hm, di=-1), dj=-1))
        hFacM = self.seaiceMaskU - sh(self.seaiceMaskU, dj=-1)
        sig12 = (etaZ * ((uC - sh(uC, dj=-1)) * g.recip_dyU
                         - self.k2AtZ * 0.5 * (uC + sh(uC, dj=-1))) * hm4
                 + etaZ * g.recip_dyU * (uC + sh(uC, dj=-1))
                 * hFacM * 2.0)
        if self.p.useStrImpCpl:
            sig12 = sig12 - zetaZ * ((uC - sh(uC, dj=-1))
                                     * g.recip_dyU) * hm4 \
                - zetaZ * g.recip_dyU * (uC + sh(uC, dj=-1)) * hFacM * 2.0
        return (g.recip_rAs * self.seaiceMaskV *
                (sh(g.dyU * sig12, di=1) - g.dyU * sig12
                 + g.dxF * sig22 - sh(g.dxF * sig22, dj=-1)))

    def _lsr_coeffs(self, epz, zme, etaZ, zetaZ, dragSym, massU, massV,
                    areaW, areaS):
        """SEAICE_LSR_CALC_COEFFS (seaice_lsr.F:1265)."""
        g = self.grid
        p = self.p
        recip_dt = 1.0 / p.deltaTdyn
        UXX = g.dyF * epz * g.recip_dxF
        UXM = g.dyF * zme * self.k1AtC * 0.5
        sicFac = 1.0 if p.useStrImpCpl else 0.0
        UYY = g.dxV * (etaZ + sicFac * zetaZ) * g.recip_dyU
        UYM = g.dxV * etaZ * self.k2AtZ * 0.5
        VXX = g.dyU * (etaZ + sicFac * zetaZ) * g.recip_dxV
        VXM = g.dyU * etaZ * self.k1AtZ * 0.5
        VYY = g.dxF * epz * g.recip_dyF
        VYM = g.dxF * zme * self.k2AtC * 0.5
        mU, mV = self.seaiceMaskU, self.seaiceMaskV
        AU = (-sh(UXX, di=-1) + sh(UXM, di=-1)) * mU
        CU = (-UXX - UXM) * mU
        BU = (1.0 - mU) + (sh(UXX, di=-1) + UXX + sh(UYY, dj=1) + UYY
                           + sh(UXM, di=-1) - UXM + sh(UYM, dj=1) - UYM
                           ) * mU
        uRt1 = UYY + UYM
        uRt2 = sh(UYY, dj=1) - sh(UYM, dj=1)
        hFacMu = sh(mU, dj=-1)
        hFacPu = sh(mU, dj=1)
        BU = BU + mU * ((1.0 - hFacMu) * (UYY + UYM)
                        + (1.0 - hFacPu) * (sh(UYY, dj=1) - sh(UYM, dj=1)))
        uRt1 = uRt1 * hFacMu
        uRt2 = uRt2 * hFacPu
        AU = AU * g.recip_rAw
        CU = CU * g.recip_rAw
        BU = (BU * g.recip_rAw
              + mU * (recip_dt * massU
                      + 0.5 * (dragSym + sh(dragSym, di=-1)) * areaW))
        uRt1 = uRt1 * g.recip_rAw
        uRt2 = uRt2 * g.recip_rAw

        AV = (-sh(VYY, dj=-1) + sh(VYM, dj=-1)) * mV
        CV = (-VYY - VYM) * mV
        BV = (1.0 - mV) + (VXX + sh(VXX, di=1) + VYY + sh(VYY, dj=-1)
                           - VXM + sh(VXM, di=1) - VYM + sh(VYM, dj=-1)
                           ) * mV
        vRt1 = VXX + VXM
        vRt2 = sh(VXX, di=1) - sh(VXM, di=1)
        hFacMv = sh(mV, di=-1)
        hFacPv = sh(mV, di=1)
        BV = BV + mV * ((1.0 - hFacMv) * (VXX + VXM)
                        + (1.0 - hFacPv) * (sh(VXX, di=1) - sh(VXM, di=1)))
        vRt1 = vRt1 * hFacMv
        vRt2 = vRt2 * hFacPv
        AV = AV * g.recip_rAs
        CV = CV * g.recip_rAs
        BV = (BV * g.recip_rAs
              + mV * (recip_dt * massV
                      + 0.5 * (dragSym + sh(dragSym, dj=-1)) * areaS))
        vRt1 = vRt1 * g.recip_rAs
        vRt2 = vRt2 * g.recip_rAs
        return AU, BU, CU, AV, BV, CV, uRt1, uRt2, vRt1, vRt2

    def _tridiag_rows(self, A, B, C, rhs):
        """Batched Thomas solve along the last axis.

        A,B,C,rhs: [nrows, nx] (interior columns only); returns x."""
        nx = rhs.shape[-1]

        def fwd(carry, inp):
            cuu_m, urt_m = carry
            a, b, c, r = inp
            bet = b - a * cuu_m
            cuu = c / bet
            urt = (r - a * urt_m) / bet
            return (cuu, urt), (cuu, urt)

        cuu0 = C[..., 0] / B[..., 0]
        urt0 = rhs[..., 0] / B[..., 0]
        (_, _), (cuus, urts) = jax.lax.scan(
            fwd, (cuu0, urt0),
            (A[..., 1:].T, B[..., 1:].T, C[..., 1:].T, rhs[..., 1:].T))
        cuus = jnp.concatenate([cuu0[None], cuus], axis=0)   # [nx, rows]
        urts = jnp.concatenate([urt0[None], urts], axis=0)

        def bwd(x_p, inp):
            cuu, urt = inp
            x = urt - cuu * x_p
            return x, x

        _, xs = jax.lax.scan(bwd, urts[-1],
                             (cuus[:-1][::-1], urts[:-1][::-1]))
        xs = jnp.concatenate([xs[::-1], urts[-1:]], axis=0)  # [nx, rows]
        return xs.T

    def _tiles(self, a):
        """Split a filled global padded array into per-tile padded views
        [nTiles, sNy+2ol, sNx+2ol].  On the cubed sphere each face block
        is tiled independently (cs32x15: 12 tiles of 32x16, SIZE.h).
        Tile (tx,ty) covers padded rows
        [ty*sNy : ty*sNy+sNy+2ol) — the inter-tile halo equals the
        neighbour interior from the LAST exchange, exactly the
        reference's per-tile overlap state."""
        cfg = self.cfg
        ol = self.ol
        tiles = []
        if self.cs:
            nypf = self.ny + 2 * ol
            ntY = max(1, self.ny // cfg.sNy)
            ntX = max(1, self.nx // cfg.sNx)
            for f in range(cfg.nFaces):
                base = f * nypf
                for ty in range(ntY):
                    for tx in range(ntX):
                        tiles.append(
                            a[base + ty * cfg.sNy:
                              base + ty * cfg.sNy + cfg.sNy + 2 * ol,
                              tx * cfg.sNx:
                              tx * cfg.sNx + cfg.sNx + 2 * ol])
            return jnp.stack(tiles)
        for ty in range(cfg.nSy):
            for tx in range(cfg.nSx):
                tiles.append(a[ty * cfg.sNy:ty * cfg.sNy + cfg.sNy
                               + 2 * ol,
                               tx * cfg.sNx:tx * cfg.sNx + cfg.sNx
                               + 2 * ol])
        return jnp.stack(tiles)

    def _untile_interior(self, tiles, a):
        """Write tile interiors back into the global padded array."""
        cfg = self.cfg
        ol = self.ol
        t = 0
        if self.cs:
            nypf = self.ny + 2 * ol
            ntY = max(1, self.ny // cfg.sNy)
            ntX = max(1, self.nx // cfg.sNx)
            for f in range(cfg.nFaces):
                base = f * nypf
                for ty in range(ntY):
                    for tx in range(ntX):
                        a = a.at[base + ol + ty * cfg.sNy:
                                 base + ol + (ty + 1) * cfg.sNy,
                                 ol + tx * cfg.sNx:
                                 ol + (tx + 1) * cfg.sNx].set(
                            tiles[t, ol:ol + cfg.sNy, ol:ol + cfg.sNx])
                        t += 1
            return a
        for ty in range(cfg.nSy):
            for tx in range(cfg.nSx):
                a = a.at[ol + ty * cfg.sNy:ol + (ty + 1) * cfg.sNy,
                         ol + tx * cfg.sNx:ol + (tx + 1) * cfg.sNx].set(
                    tiles[t, ol:ol + cfg.sNy, ol:ol + cfg.sNx])
                t += 1
        return a

    def _tridiagU(self, AU, BU, CU, uRt1, uRt2, rhsU, uTmp, WFAU, uIce):
        """SEAICE_LSR_TRIDIAGU (seaice_lsr.F:1845): per-tile tridiagonal
        sweeps along x, zebra (alternate local rows) ordering.  The
        solve is tile-local — tile halos stay at their last-exchange
        values, reproducing the reference's 2-D tile decomposition."""
        cfg = self.cfg
        ol, sNy, sNx = self.ol, cfg.sNy, cfg.sNx
        ii = slice(ol, ol + sNx)
        uT = self._tiles(uIce)          # [nt, sNy+2ol, sNx+2ol]
        uTmpT = self._tiles(uTmp)
        AT, BT, CT = self._tiles(AU), self._tiles(BU), self._tiles(CU)
        r1T, r2T = self._tiles(uRt1), self._tiles(uRt2)
        rT = self._tiles(rhsU)
        mT = self._tiles(self.seaiceMaskU)
        for k in (0, 1):
            rows = slice(ol + k, ol + sNy, 2)
            jm1 = slice(rows.start - 1, ol + sNy - 1, 2)
            jp1 = slice(rows.start + 1, ol + sNy + 1, 2)
            urt = (rT[:, rows, ii]
                   + r1T[:, rows, ii] * uT[:, jm1, ii]
                   + r2T[:, rows, ii] * uT[:, jp1, ii])
            # tile-edge closure (AA3) from the tile-halo values
            urt = urt.at[:, :, 0].add(-AT[:, rows, ol]
                                      * uT[:, rows, ol - 1])
            urt = urt.at[:, :, -1].add(-CT[:, rows, ol + sNx - 1]
                                       * uT[:, rows, ol + sNx])
            urt = urt * mT[:, rows, ii]
            nt, nrow = urt.shape[0], urt.shape[1]
            x = self._tridiag_rows(
                AT[:, rows, ii].reshape(nt * nrow, sNx),
                BT[:, rows, ii].reshape(nt * nrow, sNx),
                CT[:, rows, ii].reshape(nt * nrow, sNx),
                urt.reshape(nt * nrow, sNx)).reshape(nt, nrow, sNx)
            new = uTmpT[:, rows, ii] + WFAU * (x - uTmpT[:, rows, ii])
            uT = uT.at[:, rows, ii].set(new)
        return self._untile_interior(uT, uIce)

    def _tridiagV(self, AV, BV, CV, vRt1, vRt2, rhsV, vTmp, WFAV, vIce):
        cfg = self.cfg
        ol, sNy, sNx = self.ol, cfg.sNy, cfg.sNx
        jj = slice(ol, ol + sNy)
        vT = self._tiles(vIce)
        vTmpT = self._tiles(vTmp)
        AT, BT, CT = self._tiles(AV), self._tiles(BV), self._tiles(CV)
        r1T, r2T = self._tiles(vRt1), self._tiles(vRt2)
        rT = self._tiles(rhsV)
        mT = self._tiles(self.seaiceMaskV)
        for k in (0, 1):
            cols = slice(ol + k, ol + sNx, 2)
            im1 = slice(cols.start - 1, ol + sNx - 1, 2)
            ip1 = slice(cols.start + 1, ol + sNx + 1, 2)
            vrt = (rT[:, jj, cols]
                   + r1T[:, jj, cols] * vT[:, jj, im1]
                   + r2T[:, jj, cols] * vT[:, jj, ip1])
            vrt = vrt.at[:, 0, :].add(-AT[:, ol, cols]
                                      * vT[:, ol - 1, cols])
            vrt = vrt.at[:, -1, :].add(-CT[:, ol + sNy - 1, cols]
                                       * vT[:, ol + sNy, cols])
            vrt = vrt * mT[:, jj, cols]
            nt, ncol = vrt.shape[0], vrt.shape[2]
            x = self._tridiag_rows(
                AT[:, jj, cols].transpose(0, 2, 1).reshape(nt * ncol, sNy),
                BT[:, jj, cols].transpose(0, 2, 1).reshape(nt * ncol, sNy),
                CT[:, jj, cols].transpose(0, 2, 1).reshape(nt * ncol, sNy),
                vrt.transpose(0, 2, 1).reshape(nt * ncol, sNy)
            ).reshape(nt, ncol, sNy).transpose(0, 2, 1)
            new = vTmpT[:, jj, cols] + WFAV * (x - vTmpT[:, jj, cols])
            vT = vT.at[:, jj, cols].set(new)
        return self._untile_interior(vT, vIce)

    def lsr(self, ice: IceState, forc, uVel0, vVel0, etaN, press0, zMax,
            zMin, massC, massU, massV, forcex0, forcey0):
        """SEAICE_LSR (seaice_lsr.F:24): Picard outer loop + zebra
        line-SOR inner iterations."""
        p = self.p
        g = self.grid
        recip_dt = 1.0 / p.deltaTdyn
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        uIce, vIce = ice.uIce, ice.vIce
        uNm1, vNm1 = uIce, vIce
        fxTmp = forcex0 + massU * recip_dt * uNm1
        fyTmp = forcey0 + massV * recip_dt * vNm1
        if p.scaleSurfStress:
            # seaice_lsr.F:232-242: ice-ocean stress also scaled by the
            # concentration fraction
            areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            areaW = jnp.ones_like(uIce)
            areaS = jnp.ones_like(uIce)
        mIn = g.maskInC
        sgn = jnp.sign(g.fCori)
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)

        uIceC, vIceC = uIce, vIce
        for ipass in range(1, p.nonLinIterMax + 1):
            if ipass == 1:
                uIceC, vIceC = uIce, vIce
            elif ipass == 2 and p.nonLinIterMax <= 2:
                uIce = 0.5 * (uIce + uNm1)
                vIce = 0.5 * (vIce + vNm1)
                uIceC, vIceC = uIce, vIce
            else:
                uIceC = 0.5 * (uIce + uIceC)
                vIceC = 0.5 * (vIce + vIceC)
            e11, e22, e12 = self.strainrates(uIceC, vIceC)
            eta, etaZ, zeta, zetaZ, press, _dC = self.viscosities(
                e11, e22, e12, press0, zMax, zMin)
            dwatn = self.oceandrag(uIceC, vIceC, uVel0, vVel0)
            epz = eta + zeta
            zme = zeta - eta
            dragSym = dwatn * coswat   # basal drag = 0
            # FORCEX/Y (seaice_lsr.F:300-355)
            dvC = vVel0 - vIceC
            frcU = (fxTmp
                    + (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * uVel0
                       - sgn * sinwat * 0.5
                       * (dwatn * 0.5 * (dvC + sh(dvC, dj=1))
                          + sh(dwatn, di=-1) * 0.5
                          * (sh(dvC, di=-1) + sh(sh(dvC, dj=1), di=-1)))
                       ) * areaW)
            duC = uVel0 - uIceC
            frcV = (fyTmp
                    + (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * vVel0
                       + sgn * sinwat * 0.5
                       * (dwatn * 0.5 * (duC + sh(duC, di=1))
                          + sh(dwatn, dj=-1) * 0.5
                          * (sh(duC, dj=-1) + sh(sh(duC, di=1), dj=-1)))
                       ) * areaS)
            vCc = 0.5 * (vIceC + sh(vIceC, dj=1))
            frcU = frcU + 0.5 * (massC * g.fCori * vCc
                                 + sh(massC * g.fCori * vCc, di=-1))
            uCc = 0.5 * (uIceC + sh(uIceC, di=1))
            frcV = frcV - 0.5 * (massC * g.fCori * uCc
                                 + sh(massC * g.fCori * uCc, dj=-1))
            frcU = frcU * self.seaiceMaskU
            frcV = frcV * self.seaiceMaskV
            rhsU = frcU + self._lsr_rhs_u(zme, epz, etaZ, zetaZ, press,
                                          uIceC, vIceC)
            rhsV = frcV + self._lsr_rhs_v(zme, epz, etaZ, zetaZ, press,
                                          uIceC, vIceC)
            (AU, BU, CU, AV, BV, CV, uRt1, uRt2, vRt1,
             vRt2) = self._lsr_coeffs(epz, zme, etaZ, zetaZ, dragSym,
                                      massU, massV, areaW, areaS)
            # open-boundary/land closure (seaice_lsr.F:409-432)
            badU = mIn * sh(mIn, di=-1) == 0.0
            AU = jnp.where(badU, 0.0, AU)
            BU = jnp.where(badU, 1.0, BU)
            CU = jnp.where(badU, 0.0, CU)
            uRt1 = jnp.where(badU, 0.0, uRt1)
            uRt2 = jnp.where(badU, 0.0, uRt2)
            rhsU = jnp.where(badU, uIce, rhsU)
            badV = mIn * sh(mIn, dj=-1) == 0.0
            AV = jnp.where(badV, 0.0, AV)
            BV = jnp.where(badV, 1.0, BV)
            CV = jnp.where(badV, 0.0, CV)
            vRt1 = jnp.where(badV, 0.0, vRt1)
            vRt2 = jnp.where(badV, 0.0, vRt2)
            rhsV = jnp.where(badV, vIce, rhsV)
            if self.cs or p.scaleSurfStress:
                # seaice_lsr.F:1558-1572 zero-diagonal guard (face-edge
                # halo rows where the coefficients were never assembled;
                # with scaleSurfStress, open-water cells with no ice
                # mass have an all-zero momentum row)
                BU = jnp.where(BU == 0.0, 1.0, BU)
                BV = jnp.where(BV == 0.0, 1.0, BV)

            uIce, vIce = self._lsr_iterate(
                AU, BU, CU, AV, BV, CV, uRt1, uRt2, vRt1, vRt2,
                rhsU, rhsV, uIce, vIce)
            if getattr(self, "debug", False):
                self.last_lsr = getattr(self, "last_lsr", [])
                self.last_lsr.append(self._lsr_diag)

        uIce = uIce * self.seaiceMaskU
        vIce = vIce * self.seaiceMaskV
        if p.clipVelocities:
            # seaice_dynsolver.F:387-405 (SEAICE_ALLOW_CLIPVELS): cap at
            # 0.40 m/s against CFL violations of thin drifting ice
            uIce = jnp.clip(uIce, -0.40, 0.40)
            vIce = jnp.clip(vIce, -0.40, 0.40)
        uIce, vIce = self.fill_uv(uIce, vIce)
        return uIce, vIce, dwatn

    def _lsr_iterate(self, AU, BU, CU, AV, BV, CV, uRt1, uRt2, vRt1,
                     vRt2, rhsU, rhsV, uIce, vIce):
        """The linear m-loop (seaice_lsr.F:583-780) as a while_loop."""
        p = self.p
        ol, ny, nx = self.ol, self.ny, self.nx
        jj, ii = slice(ol, ol + ny), slice(ol, ol + nx)
        mU, mV = self.seaiceMaskU, self.seaiceMaskV

        def cond(st):
            (u, v, wfau, wfav, s1a, s2a, it4u, it4v, m, ic1, ic2) = st
            return jnp.logical_and(m < p.linearIterMax,
                                   jnp.logical_or(it4u, it4v))

        cs = self.cs

        def body(st):
            (u, v, wfau, wfav, s1a, s2a, it4u, it4v, m, ic1, ic2) = st
            uTmp, vTmp = u, v
            # on the cubed sphere both components keep iterating until
            # BOTH converge (the vector exchange couples them across
            # rotated face edges, seaice_lsr.F:769-772)
            upd_u = jnp.logical_or(it4u, cs)
            upd_v = jnp.logical_or(it4v, cs)
            u_new = self._tridiagU(AU, BU, CU, uRt1, uRt2, rhsU, uTmp,
                                   wfau, u)
            u = jnp.where(upd_u, u_new, u)
            v_new = self._tridiagV(AV, BV, CV, vRt1, vRt2, rhsV, vTmp,
                                   wfav, v)
            v = jnp.where(upd_v, v_new, v)
            m = m + 1
            do_chk = (m % p.SOLV_NCHECK) == 0
            # global max over the interior of ALL tiles/faces
            # (seaice_lsr.F:909-921 + _GLOBAL_MAX_RL) — a partial-face
            # slice here silently stops the iteration when that one
            # face happens to be ice-free
            s1 = jnp.max(jnp.abs((u - uTmp) * mU) * self.interior)
            s2 = jnp.max(jnp.abs((v - vTmp) * mV) * self.interior)
            chku = jnp.logical_and(do_chk, it4u)
            chkv = jnp.logical_and(do_chk, it4v)
            # WFAU2=0: freeze relaxation if the update grows (legacy)
            wfau = jnp.where(jnp.logical_and(chku, jnp.logical_and(
                m > 1, s1 > s1a)), 0.0, wfau)
            wfav = jnp.where(jnp.logical_and(chkv, jnp.logical_and(
                m > 1, s2 > s2a)), 0.0, wfav)
            s1a = jnp.where(chku, s1, s1a)
            s2a = jnp.where(chkv, s2, s2a)
            stopu = jnp.logical_and(chku, s1 < p.LSR_ERROR)
            stopv = jnp.logical_and(chkv, s2 < p.LSR_ERROR)
            ic1 = jnp.where(stopu, m, ic1)
            ic2 = jnp.where(stopv, m, ic2)
            it4u = jnp.where(stopu, False, it4u)
            it4v = jnp.where(stopv, False, it4v)
            u, v = self.fill_uv(u, v)
            return (u, v, wfau, wfav, s1a, s2a, it4u, it4v, m, ic1, ic2)

        st0 = (uIce, vIce,
               jnp.asarray(p.LSRrelaxU, uIce.dtype),
               jnp.asarray(p.LSRrelaxV, uIce.dtype),
               jnp.asarray(0.8, uIce.dtype), jnp.asarray(0.8, uIce.dtype),
               jnp.asarray(True), jnp.asarray(True), jnp.asarray(0),
               jnp.asarray(p.linearIterMax), jnp.asarray(p.linearIterMax))
        out = jax.lax.while_loop(cond, body, st0)
        # (ICOUNT1, ICOUNT2, S1A, S2A) — matches the reference's
        # "SEAICE_LSR (ipass=..) iters,dU" diagnostic (seaice_lsr.F:1601)
        self._lsr_diag = (out[9], out[10], out[4], out[5])
        return out[0], out[1]

    # ------------------------------------------------------------------
    def evp(self, ice: IceState, forc, uVel0, vVel0, press0,
            massC, massU, massV, forcex0, forcey0):
        """SEAICE_EVP (seaice_evp.F): (adaptive) elastic-viscous-plastic
        explicit subcycling — nEVPstarSteps stencil-only iterations in a
        lax.fori_loop (a VP solver with no tridiagonals and no
        convergence branches).

        Implements the EVP* / revised-EVP time discretization (Bouillon
        et al. 2013; seaice_evp.F:218-235) and adaptive alpha/beta
        (Kimmritz, Danilov & Losch 2015; seaice_evp.F:417-436) on the
        C grid.  Build assumptions match the lab_sea code dir: CLIPZETA,
        TEM, SMOOTHREG, MOM_ADVECTION and EVP_ELIMINATE_UNDERFLOWS all
        undefined; bottom drag compiled but SEAICEbasalDragK2=0.

        Returns (uIce, vIce, dwatn, sigma, stressDivX, stressDivY)."""
        p = self.p
        g = self.grid
        dtype = ice.uIce.dtype
        recip_dt = 1.0 / p.deltaTdyn
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        adaptive = p.aEVPcoeff > 0.0
        ecc2 = p.eccen * p.eccen
        recip_ecc2 = 1.0 / ecc2
        if p.useEVPrev:
            evpRevFac, evpStarFac = 1.0, 1.0
            recip_evpRevFac = recip_ecc2
        else:
            evpRevFac = 0.0
            recip_evpRevFac = 1.0
            evpStarFac = 1.0 if p.useEVPstar else 0.0
        EVPcFac = (p.deltaTdyn * p.aEVPcStar
                   * (p.aEVPcoeff * math.pi) ** 2 if adaptive else 0.0)
        hm = self.HEFFM
        sumNorm = (hm + sh(hm, di=-1) + sh(hm, dj=-1)
                   + sh(sh(hm, di=-1), dj=-1))
        sumNorm = jnp.where(sumNorm > 0.0,
                            1.0 / jnp.where(sumNorm > 0.0, sumNorm, 1.0),
                            0.0)
        if p.scaleSurfStress:
            areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            areaW = jnp.ones_like(ice.uIce)
            areaS = jnp.ones_like(ice.uIce)
        sgn = jnp.sign(g.fCori)
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)
        locMaskU = jnp.where(massU != 0.0, 1.0, 0.0)
        locMaskV = jnp.where(massV != 0.0, 1.0, 0.0)
        uNm1, vNm1 = ice.uIce, ice.vIce
        if not adaptive:
            alphaC0 = jnp.full_like(press0, p.evpAlpha)
            betaU0 = jnp.full_like(press0, p.evpBeta)
            betaV0 = betaU0

        def subcycle(_it, carry):
            u, v, s1, s2, s12, _dw = carry
            e11, e22, e12 = self.strainrates(u, v)
            ep = e11 + e22
            em = e11 - e22
            if p.etaZmethod == 3:
                # area-weighted mean of e12^2 (Bouillon et al 2013 eq 11,
                # seaice_evp.F:379-391)
                rze = g.rAz * e12 * e12
                e12Csq = 0.25 * g.recip_rA * (
                    rze + sh(rze, di=1) + sh(rze, dj=1)
                    + sh(sh(rze, di=1), dj=1))
            else:
                e12sum = (e12 + sh(e12, di=1) + sh(e12, dj=1)
                          + sh(sh(e12, di=1), dj=1))
                e12Csq = (0.25 * e12sum) ** 2
            deltaSq = ep * ep + recip_ecc2 * (em * em + 4.0 * e12Csq)
            deltaC = jnp.sqrt(deltaSq)
            deltaCreg = jnp.maximum(deltaC, p.deltaMin)
            zetaC = 0.5 * press0 / deltaCreg
            if adaptive:
                alphaC = jnp.sqrt(
                    zetaC * EVPcFac / jnp.maximum(massC, 1.0e-4)
                    * g.recip_rA) * hm
                alphaC = jnp.maximum(alphaC, p.aEVPalphaMin)
            else:
                alphaC = alphaC0
            # zetaZ/deltaZ by simple HEFFM-normalized averaging
            # (seaice_evp.F:437-451)
            zetaZ = sumNorm * (zetaC + sh(zetaC, di=-1) + sh(zetaC, dj=-1)
                               + sh(sh(zetaC, di=-1), dj=-1))
            pressC = (press0 * (1.0 - p.pressReplFac)
                      + 2.0 * zetaC * deltaC * p.pressReplFac)
            seaice_div = (2.0 * zetaC * ep - pressC) * hm
            seaice_tension = 2.0 * zetaC * em * hm
            seaice_shear = 2.0 * zetaZ * e12
            # stress equations (seaice_evp.F:590-649)
            s1 = ((s1 * (alphaC - evpRevFac) + seaice_div)
                  / alphaC * hm) if p.useEVPrev or adaptive else \
                ((s1 * (alphaC - evpRevFac) + seaice_div)
                 / (alphaC + 1.0) * hm)
            den2C = alphaC if (p.useEVPrev or adaptive) else alphaC + ecc2
            s2 = (s2 * (alphaC - evpRevFac)
                  + seaice_tension * recip_evpRevFac) / den2C * hm
            sig11 = 0.5 * (s1 + s2)
            sig22 = 0.5 * (s1 - s2)
            alphaZ = 0.25 * (alphaC + sh(alphaC, di=-1)
                             + sh(alphaC, dj=-1)
                             + sh(sh(alphaC, di=-1), dj=-1))
            den12 = alphaZ if (p.useEVPrev or adaptive) else alphaZ + ecc2
            s12 = (s12 * (alphaZ - evpRevFac)
                   + seaice_shear * recip_evpRevFac) / den12
            # divergence of the stress tensor (seaice_evp.F:653-668)
            t11 = sig11 * g.dyF
            t12x = s12 * g.dxV
            divX = (t11 - sh(t11, di=-1)
                    + sh(t12x, dj=1) - t12x) * g.recip_rAw
            t22 = sig22 * g.dxF
            t12y = s12 * g.dyU
            divY = (t22 - sh(t22, dj=-1)
                    + sh(t12y, di=1) - t12y) * g.recip_rAs
            # momentum rhs (seaice_evp.F:757-818)
            dwatn = self.oceandrag(u, v, uVel0, vVel0)
            dwU = 0.5 * (dwatn + sh(dwatn, di=-1))
            dwV = 0.5 * (dwatn + sh(dwatn, dj=-1))
            dv = vVel0 - v
            frcU = forcex0 + (
                dwU * coswat * uVel0
                - sgn * sinwat * 0.5
                * (dwatn * 0.5 * (dv + sh(dv, dj=1))
                   + sh(dwatn, di=-1) * 0.5
                   * (sh(dv, di=-1) + sh(sh(dv, dj=1), di=-1)))
                * locMaskU) * areaW
            du = uVel0 - u
            frcV = forcey0 + (
                dwV * coswat * vVel0
                + sgn * sinwat * 0.5
                * (dwatn * 0.5 * (du + sh(du, di=1))
                   + sh(dwatn, dj=-1) * 0.5
                   * (sh(du, dj=-1) + sh(sh(du, di=1), dj=-1)))
                * locMaskV) * areaS
            mfv = massC * g.fCori * 0.5 * (v + sh(v, dj=1))
            frcU = frcU + 0.5 * (mfv + sh(mfv, di=-1))
            mfu = massC * g.fCori * 0.5 * (u + sh(u, di=1))
            frcV = frcV - 0.5 * (mfu + sh(mfu, dj=-1))
            # implicit ice-ocean-drag velocity update (seaice_evp.F:866-906)
            if adaptive:
                betaU = 0.5 * (alphaC + sh(alphaC, di=-1))
                betaV = 0.5 * (alphaC + sh(alphaC, dj=-1))
            else:
                betaU, betaV = betaU0, betaV0
            betaFacU = betaU * recip_dt
            betaFacV = betaV * recip_dt
            betaFacP1U = betaFacU + evpStarFac * recip_dt
            betaFacP1V = betaFacV + evpStarFac * recip_dt
            denomU = massU * betaFacP1U + dwU * coswat * areaW
            denomV = massV * betaFacP1V + dwV * coswat * areaS
            denomU = jnp.where(denomU == 0.0, 1.0, denomU)
            denomV = jnp.where(denomV == 0.0, 1.0, denomV)
            u_new = self.seaiceMaskU * (
                massU * betaFacU * u
                + massU * recip_dt * evpStarFac * uNm1
                + frcU + divX) / denomU
            v_new = self.seaiceMaskV * (
                massV * betaFacV * v
                + massV * recip_dt * evpStarFac * vNm1
                + frcV + divY) / denomV
            u_new, v_new = self.fill_uv(u_new, v_new)
            return (u_new, v_new, s1, s2, s12, dwatn)

        sig = ice.sigma
        if sig is None or sig.shape[0] != 3:
            sig = jnp.zeros((3,) + ice.uIce.shape, dtype)
        u, v, s1, s2, s12, dwatn = jax.lax.fori_loop(
            0, p.nEVPstarSteps, subcycle,
            (ice.uIce, ice.vIce, sig[0], sig[1], sig[2],
             jnp.zeros_like(ice.uIce)))
        # NOTE: no masking/clipping here — the reference clips AFTER
        # SEAICE_OCEAN_STRESS (seaice_dynsolver.F:387-405), handled by
        # the caller
        uIce, vIce = u, v
        sig11 = 0.5 * (s1 + s2)
        sig22 = 0.5 * (s1 - s2)
        t11 = sig11 * g.dyF
        t12x = s12 * g.dxV
        divX = (t11 - sh(t11, di=-1) + sh(t12x, dj=1) - t12x) * g.recip_rAw
        t22 = sig22 * g.dxF
        t12y = s12 * g.dyU
        divY = (t22 - sh(t22, dj=-1) + sh(t12y, di=1) - t12y) * g.recip_rAs
        return uIce, vIce, dwatn, jnp.stack([s1, s2, s12]), divX, divY

    # ------------------------------------------------------------------
    def freedrift(self, ice: IceState, uVel0, vVel0, forcex0, forcey0):
        """seaice_freedrift.F: analytic free-drift ice velocity from the
        2-term balance (surface stress + Coriolis) against quadratic
        ice-ocean drag; cell-centred solve, then averaged back to the
        C-grid velocity points and masked."""
        p = self.p
        g = self.grid
        # cell-centre forcing and state (seaice_freedrift.F:55-66)
        taux_c = 0.5 * (forcex0 + sh(forcex0, di=1))
        tauy_c = 0.5 * (forcey0 + sh(forcey0, dj=1))
        mIceCor = p.rhoIce * ice.HEFF * g.fCori
        u_c = 0.5 * (uVel0 + sh(uVel0, di=1))
        v_c = 0.5 * (vVel0 + sh(vVel0, dj=1))
        rhs_x = -taux_c - mIceCor * v_c
        rhs_y = -tauy_c + mIceCor * u_c
        nsq = rhs_x * rhs_x + rhs_y * rhs_y
        pos = nsq > 0.0
        rhs_n = jnp.where(pos, jnp.sqrt(jnp.where(pos, nsq, 1.0)), 0.0)
        rhs_a = jnp.where(pos, jnp.arctan2(rhs_y, rhs_x), 0.0)
        rhoConst = self.cfg.rhoConst
        wDrag = jnp.where(g.yC < 0.0, p.waterDrag_south, p.waterDrag)
        inv = 1.0 / (rhoConst * wDrag)
        t2 = (inv * inv) * mIceCor * mIceCor
        t3 = (inv * inv) * rhs_n * rhs_n
        t4 = t2 * t2 + 4.0 * t3
        pos3 = t3 > 0.0
        sol_n = jnp.where(
            pos3, jnp.sqrt(0.5 * (jnp.sqrt(jnp.where(pos3, t4, 1.0))
                                  - t2)), 0.0)
        c1 = wDrag * rhoConst
        s2 = c1 * sol_n * sol_n
        s3 = mIceCor * sol_n
        s4 = s2 * s2 + s3 * s3
        pos4 = s4 > 0.0
        sol_a = jnp.where(pos4, rhs_a - jnp.arctan2(s3, s2), 0.0)
        uic = u_c - sol_n * jnp.cos(sol_a)
        vic = v_c - sol_n * jnp.sin(sol_a)
        uic, vic = self.fill_uv(uic, vic)   # EXCH_UV_AGRID analog
        uFD = 0.5 * (sh(uic, di=-1) + uic) * self.SIMaskU
        vFD = 0.5 * (sh(vic, dj=-1) + vic) * self.SIMaskV
        return self.fill_uv(uFD, vFD)

    def ocean_stress_hb87(self, ice, windTauX, windTauY, stressDivX,
                          stressDivY, fu, fv):
        """seaice_ocean_stress.F:66-100 (useHB87StressCoupling): integral
        over ice and ocean surface layer (Hibler & Bryan 1987)."""
        p = self.p
        areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
        areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
        fu_new = ((1.0 - areaW) * fu + areaW * windTauX
                  + stressDivX * p.stressFactor)
        fv_new = ((1.0 - areaS) * fv + areaS * windTauY
                  + stressDivY * p.stressFactor)
        return self.fill_uv(fu_new, fv_new)

    def ocean_stress(self, ice, dwatn, uVel0, vVel0, fu, fv):
        """seaice_ocean_stress.F (non-HB87): blend ice-ocean drag."""
        p = self.p
        g = self.grid
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        sgn = jnp.sign(g.fCori)
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)
        du = ice.uIce - uVel0
        dv = ice.vIce - vVel0
        fuIce = (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * du
                 - sgn * sinwat * 0.5
                 * (dwatn * 0.5 * (dv + sh(dv, dj=1))
                    + sh(dwatn, di=-1) * 0.5
                    * (sh(dv, di=-1) + sh(sh(dv, dj=1), di=-1))))
        fvIce = (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * dv
                 + sgn * sinwat * 0.5
                 * (dwatn * 0.5 * (du + sh(du, di=1))
                    + sh(dwatn, dj=-1) * 0.5
                    * (sh(du, dj=-1) + sh(sh(du, di=1), dj=-1))))
        areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
        areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
        fu_new = (1.0 - areaW) * fu + areaW * fuIce
        fv_new = (1.0 - areaS) * fv + areaS * fvIce
        return self.fill_uv(fu_new, fv_new)

    # ------------------------------------------------------------------
    # advection (seaice_advdiff.F + seaice_advection.F, Cartesian npass=2)
    # ------------------------------------------------------------------
    def _advect_field(self, uc, vc, uTrans, vTrans, fld, dt, scheme=None):
        """SEAICE_ADVECTION for one extensive 2-D field: returns gFld."""
        if scheme is None:
            scheme = self.p.advScheme
        if self.cs:
            return self._advect_field_cs(uc, vc, uTrans, vTrans, fld, dt,
                                         scheme)
        g = self.grid
        localT = fld
        mW, mS = self.SIMaskU, self.SIMaskV
        # X pass
        af = self._flux_x(uTrans, uc, mW, localT, dt, scheme)
        localT = localT - dt * self.maskInCx * g.recip_rA * (
            sh(af, di=1) - af)
        # Y pass
        af = self._flux_y(vTrans, vc, mS, localT, dt, scheme)
        localT = localT - dt * self.maskInCx * g.recip_rA * (
            sh(af, dj=1) - af)
        return (localT - fld) / dt

    def _diffuse_field(self, fld, diffKh, xA, yA):
        """SEAICE_DIFFUSION (seaice_diffusion.F:40-64): harmonic
        Laplacian tendency of one extensive 2-D field, fac=1."""
        g = self.grid
        fZon = -diffKh * xA * g.recip_dxC * (fld - sh(fld, di=-1))
        fMer = -diffKh * yA * g.recip_dyC * (fld - sh(fld, dj=-1))
        return -self.HEFFM * g.recip_rA * (
            (sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer))

    def _flux_x(self, uTrans, uc, mW, localT, dt, scheme):
        """X advective flux of one 2-D extensive field: OS7MP (scheme 7,
        seaice kernel write band) or the generic_advdiff kernels
        (SEAICEadvScheme 77 etc. route through the same gad_*_adv_x
        code in the reference, seaice_advection.F:360-420)."""
        if scheme == 7:
            return os7mp_flux_x(uTrans, uc, mW, localT, dt,
                                self.grid.recip_dxC, self.band7x)
        from mitgcm_tpu.model import gad
        return gad.adv_flux_x(self.cfg, self.grid, scheme,
                              uTrans, uc, localT, dt, mW)

    def _flux_y(self, vTrans, vc, mS, localT, dt, scheme):
        if scheme == 7:
            return os7mp_flux_y(vTrans, vc, mS, localT, dt,
                                self.grid.recip_dyC, self.band7y)
        from mitgcm_tpu.model import gad
        return gad.adv_flux_y(self.cfg, self.grid, scheme,
                              vTrans, vc, localT, dt, mS)

    def _advect_field_cs(self, uc, vc, uTrans, vTrans, fld, dt,
                         scheme):
        """SEAICE_ADVECTION on the cubed sphere: the same 3-pass
        direction-split schedule with per-tile corner fills as
        gad_advection (seaice_advection.F:215-330 mirrors
        gad_advection.F); 2-D extensive update (no thickness factors,
        no compressibility compensation)."""
        from mitgcm_tpu.model.gad import _cs_pass_plan
        from mitgcm_tpu.parallel.cs import fill_cs_corner, fill_cs_corner_uv
        g = self.grid
        p = self.p
        cfg = self.cfg
        n, ol = cfg.ny, self.ol
        nyp = n + 2 * ol
        dtype = fld.dtype
        plans, kx, ky = _cs_pass_plan(n, ol)
        kx = jnp.asarray(kx, dtype)
        ky = jnp.asarray(ky, dtype)
        if scheme == 7:
            kx, ky = self.band7x, self.band7y
        # masks corner-filled once (FILL_CS_CORNER_UV_RS, withSigns=F,
        # seaice_advection.F:288-292)
        mW, mS = fill_cs_corner_uv(self.SIMaskU[None], self.SIMaskV[None],
                                   n, ol, with_sign=False)
        mW, mS = mW[0], mS[0]

        def sel_fill(a, d, faces):
            if not faces:
                return a
            filled = fill_cs_corner(a, d, n, ol)
            if len(faces) == 6:
                return filled
            m = np.zeros((6, 1, 1))
            for f in faces:
                m[f] = 1.0
            m = jnp.asarray(np.broadcast_to(
                m, (6, nyp, 1)).reshape(6 * nyp, 1), dtype)
            return m * filled + (1.0 - m) * a

        localT = fld
        mIn = self.maskInCx
        for pn, (xm, ym, x_over, y_over) in enumerate(plans):
            xm = jnp.asarray(xm, dtype)
            ym = jnp.asarray(ym, dtype)
            localT = sel_fill(localT, 1, x_over)
            afx = self._flux_x(uTrans, uc, mW, localT, dt, scheme) * kx
            if pn == 0:
                localT = sel_fill(localT, 2, x_over)
            localT = sel_fill(localT, 2, y_over)
            afy = self._flux_y(vTrans, vc, mS, localT, dt, scheme) * ky
            if pn == 0:
                localT = sel_fill(localT, 1, y_over)
            updX = localT - dt * mIn * g.recip_rA * (sh(afx, di=1) - afx)
            updY = localT - dt * mIn * g.recip_rA * (sh(afy, dj=1) - afy)
            localT = xm * updX + ym * updY + (1.0 - xm - ym) * localT
        return (localT - fld) / dt

    def _diffus(self, fld, DIFFA, iceMsk):
        """pkg/seaice/diffus.F (SEAICEuseFluxForm): Laplacian of fld with
        spatially varying coefficient, interior only (halos zeroed)."""
        g = self.grid
        dfx = (g.dyG * g.recip_dxC * (fld - sh(fld, di=-1)) * g.cosFacU
               * iceMsk * sh(iceMsk, di=-1)
               * 0.5 * (DIFFA + sh(DIFFA, di=-1)))
        dfy = (g.dxG * g.recip_dyC * (fld - sh(fld, dj=-1))
               * iceMsk * sh(iceMsk, dj=-1)
               * 0.5 * (DIFFA + sh(DIFFA, dj=-1)))
        out = ((sh(dfx, di=1) - dfx) + (sh(dfy, dj=1) - dfy)) * g.recip_rA
        return jnp.where(self.interior > 0, out, 0.0)

    def _advect_legacy(self, uc, vc, fld, iceMsk):
        """pkg/seaice/advect.F: legacy 2-pass centered (Heun) advection
        (SEAICEadvScheme=2, SEAICEuseFluxForm) + DIFF1 harmonic+biharmonic
        diffusion.  Returns the updated field (not a tendency)."""
        p = self.p
        g = self.grid
        dt = p.deltaTtherm
        fldNm1 = fld
        for _k in range(2):
            tmpFld = 0.5 * (fld + fldNm1)
            afx = g.dyG * uc * 0.5 * (tmpFld + sh(tmpFld, di=-1))
            afy = g.dxG * vc * 0.5 * (tmpFld + sh(tmpFld, dj=-1))
            upd = fldNm1 - dt * ((sh(afx, di=1) - afx)
                                 + (sh(afy, dj=1) - afy)) \
                * g.recip_rA * self.maskInCx
            fld = self.fill(jnp.where(self.interior > 0, upd, fld))
        if p.DIFF1 > 0.0:
            DIFFA = jnp.minimum(g.dxF, g.dyF)
            lap = self._diffus(fldNm1, DIFFA, iceMsk)
            fld = (fld + lap * p.DIFF1 * dt) * iceMsk
            lap = self.fill(lap)
            bilap = self._diffus(lap, -DIFFA * DIFFA, iceMsk)
            fld = (fld + bilap * p.DIFF1 * dt) * iceMsk
        return fld

    def advdiff(self, ice: IceState):
        """seaice_advdiff.F (multidim)."""
        p = self.p
        g = self.grid
        dt = p.deltaTtherm
        xA = g.dyG * self.SIMaskU
        yA = g.dxG * self.SIMaskV
        uTrans = ice.uIce * xA
        vTrans = ice.vIce * yA
        hm = self.HEFFM
        heffNm1, areaNm1 = ice.HEFF, ice.AREA
        if p.advScheme in (2, 3, 4):
            # SEAICEmultiDimAdvection=.FALSE. (readparms:1023-1030):
            # legacy ADVECT path for all transported fields
            if p.SItrNumInUse:
                raise NotImplementedError(
                    "SItracers with legacy (non-multidim) advection")
            heff = self._advect_legacy(ice.uIce, ice.vIce, ice.HEFF, hm)
            area = self._advect_legacy(ice.uIce, ice.vIce, ice.AREA, hm)
            hsnow = self._advect_legacy(ice.uIce, ice.vIce, ice.HSNOW, hm)
            if p.diffKhHeff > 0.0 or p.diffKhArea > 0.0 \
                    or p.diffKhSnow > 0.0:
                heff = heff + dt * self._diffuse_field(
                    heffNm1, p.diffKhHeff, xA, yA)
                area = area + dt * self._diffuse_field(
                    areaNm1, p.diffKhArea, xA, yA)
                hsnow = hsnow + dt * self._diffuse_field(
                    ice.HSNOW, p.diffKhSnow, xA, yA)
            return ice._replace(HEFF=heff, AREA=area, HSNOW=hsnow)
        def adv_plus_diff(fld, scheme, diffKh):
            gFld = self._advect_field(ice.uIce, ice.vIce, uTrans, vTrans,
                                      fld, dt, scheme)
            if diffKh > 0.0:
                gFld = gFld + self._diffuse_field(fld, diffKh, xA, yA)
            return gFld

        heff = hm * (ice.HEFF + dt * adv_plus_diff(
            ice.HEFF, p.advSchHeff, p.diffKhHeff))
        area = hm * (ice.AREA + dt * adv_plus_diff(
            ice.AREA, p.advSchArea, p.diffKhArea))
        hsnow = hm * (ice.HSNOW + dt * adv_plus_diff(
            ice.HSNOW, p.advSchSnow, p.diffKhSnow))
        sitr = ice.SItracer
        interior = self.interior
        siEps = 1.0e-5
        for itr in range(p.SItrNumInUse):
            mate = p.SItrMate[itr]
            carrier_nm1 = heffNm1 if mate == "HEFF" else areaNm1
            carrier = heff if mate == "HEFF" else area
            tr_sch = p.advSchHeff if mate == "HEFF" else p.advSchArea
            tr_kh = p.diffKhHeff if mate == "HEFF" else p.diffKhArea
            ext = hm * sitr[itr] * carrier_nm1
            ext = hm * (ext + dt * adv_plus_diff(ext, tr_sch, tr_kh))
            prev = sitr[itr]
            if mate == "HEFF":
                tr = jnp.where(carrier >= siEps, ext / jnp.where(
                    carrier >= siEps, carrier, 1.0), 0.0)
            else:
                tr = jnp.where(carrier >= p.area_floor, ext / jnp.where(
                    carrier >= p.area_floor, carrier, 1.0), 0.0)
            # ADVCAP: clip against the neighbourhood max of the previous
            # tracer (seaice_advdiff.F ALLOW_SITRACER_ADVCAP)
            nbmax = jnp.maximum(
                jnp.maximum(jnp.maximum(prev, sh(prev, di=1)),
                            jnp.maximum(sh(prev, di=-1), sh(prev, dj=1))),
                sh(prev, dj=-1))
            over = jnp.maximum(0.0, tr - nbmax)
            tr = tr - over
            if mate == "HEFF":
                neg = jnp.minimum(0.0, tr)
                tr = jnp.where(carrier >= siEps, tr - neg, tr)
            else:
                neg = jnp.minimum(0.0, tr)
                tr = jnp.where(carrier >= p.area_floor, tr - neg, tr)
            # interior update only; halos refreshed by the end-of-step fill
            tr = jnp.where(interior > 0, tr, prev)
            sitr = sitr.at[itr].set(tr)
        # interior-only updates for the carriers as well
        heff = jnp.where(interior > 0, heff, ice.HEFF)
        area = jnp.where(interior > 0, area, ice.AREA)
        hsnow = jnp.where(interior > 0, hsnow, ice.HSNOW)
        return ice._replace(HEFF=heff, AREA=area, HSNOW=hsnow,
                            SItracer=sitr)

    # ------------------------------------------------------------------
    def reg_ridge(self, ice: IceState):
        """seaice_reg_ridge.F (no ITD): clip negatives, area floor/cap.
        Returns (ice', d_HEFFbyNEG, d_HSNWbyNEG)."""
        p = self.p
        interior = self.interior
        heff, hsnow, area, tices = ice.HEFF, ice.HSNOW, ice.AREA, ice.TICES
        dHn = jnp.maximum(-heff, 0.0) * interior
        heff = heff + dHn
        dSn = jnp.maximum(-hsnow, 0.0) * interior
        hsnow = hsnow + dSn
        area = jnp.where(interior > 0, jnp.maximum(area, 0.0), area)
        siEps = 1.0e-5
        tiny = jnp.logical_and(heff <= siEps, interior > 0)
        t1 = jnp.where(tiny, -heff, 0.0)
        t2 = jnp.where(tiny, -hsnow, 0.0)
        tices = jnp.where(tiny[None], self.cfg.celsius2K, tices)
        heff = heff + t1
        hsnow = hsnow + t2
        dHn = dHn + t1
        dSn = dSn + t2
        both0 = jnp.logical_and(jnp.logical_and(heff == 0.0,
                                                hsnow == 0.0),
                                interior > 0)
        area = jnp.where(both0, 0.0, area)
        some = jnp.logical_and(jnp.logical_or(heff > 0.0, hsnow > 0.0),
                               interior > 0)
        area = jnp.where(some, jnp.maximum(area, p.area_floor), area)
        area = jnp.where(interior > 0, jnp.minimum(area, p.area_max),
                         area)
        return (ice._replace(HEFF=heff, HSNOW=hsnow, AREA=area,
                             TICES=tices), dHn, dSn)

    # ------------------------------------------------------------------
    def solve4temp(self, UG, hice, hsnow, tsurf_in, forc, salt0):
        """seaice_solve4temp.F for one category (2-D, vectorized).

        Returns (tsurf_out, F_ia_net, IcePenetSW, FWsublim)."""
        p = self.p
        g = self.grid
        c2k = self.cfg.celsius2K
        QS1 = 0.622 / 1013.0
        lnTEN = math.log(10.0)
        aa1, aa2 = 2663.5, 12.537
        bb1 = 0.622
        bb2 = 1.0 - bb1
        Ppascals = 100000.0
        cc0 = math.exp(aa2 * lnTEN)
        cc1 = cc0 * aa1 * bb1 * Ppascals * lnTEN
        cc2 = cc0 * bb2
        D1 = p.dalton * p.cpAir * p.rhoAir
        lhSublim = p.lhEvap + p.lhFusion
        D1I = p.dalton * lhSublim * p.rhoAir
        TMELT = c2k
        XKI, XKS = p.iceConduct, p.snowConduct
        HCUT = p.snowThick
        recip_HCUT = 1.0 / HCUT if HCUT > 0.0 else 0.0
        XIO = p.shortwave
        SurfMeltTemp = TMELT + p.wetAlbTemp

        iceOrNot = hice > 0.0
        lwdownLoc = jnp.maximum(p.MIN_LWDOWN, forc.lwdown)
        atempLoc = jnp.maximum(c2k + p.MIN_ATEMP, forc.atemp)
        tempFrz = p.dTempFrz_dS * salt0 + p.tempFrz0 + c2k
        snowy = hsnow > 0.0
        D3 = jnp.where(snowy, p.snow_emiss, p.ice_emiss) * p.boltzmann
        lwdownLoc = jnp.where(snowy, p.snow_emiss, p.ice_emiss) \
            * lwdownLoc
        south = g.yC < 0.0
        melt = tsurf_in >= SurfMeltTemp
        alb_ice = jnp.where(
            south, jnp.where(melt, p.wetIceAlb_south, p.dryIceAlb_south),
            jnp.where(melt, p.wetIceAlb, p.dryIceAlb))
        alb_snow = jnp.where(
            south,
            jnp.where(melt, p.wetSnowAlb_south, p.drySnowAlb_south),
            jnp.where(melt, p.wetSnowAlb, p.drySnowAlb))
        if HCUT <= 0.0:
            alb = alb_ice
        else:
            alb = jnp.minimum(alb_ice + hsnow * recip_HCUT
                              * (alb_snow - alb_ice), alb_snow)
        alb = jnp.where(hsnow > HCUT, alb_snow, alb)
        penet = jnp.where(snowy, 0.0, XIO * jnp.exp(-1.5 * hice))
        IcePenetSW = -(1.0 - alb) * penet * forc.swdown
        absorbedSW = (1.0 - alb) * (1.0 - penet) * forc.swdown
        effConduct = jnp.where(
            iceOrNot, XKI * XKS / jnp.maximum(
                XKS * hice + XKI * hsnow, 1e-30), 0.0)

        def flux_terms(t1):
            t2 = t1 * t1
            t3 = t2 * t1
            t4 = t2 * t2
            mm_pi = jnp.exp((-aa1 / t1 + aa2) * lnTEN)
            qhice = bb1 * mm_pi / (Ppascals - (1.0 - bb1) * mm_pi)
            cc3t = jnp.exp(aa1 / t1 * lnTEN)
            dqh_dTs = cc1 * cc3t / ((cc2 - cc3t * Ppascals) ** 2 * t2)
            F_c = effConduct * (tempFrz - t1)
            F_lh = D1I * UG * (qhice - forc.aqh)
            F_lwu = t4 * D3
            F_sens = D1 * UG * (t1 - atempLoc)
            F_ia = (-lwdownLoc - absorbedSW + F_lwu + F_sens + F_lh)
            dFia_dTs = 4.0 * D3 * t3 + D1 * UG + D1I * UG * dqh_dTs
            return F_c, F_ia, F_lh, dFia_dTs

        tsurf = tsurf_in
        for _ in range(p.IMAX_TICE):
            F_c, F_ia, _F_lh, dFia = flux_terms(tsurf)
            delta = (F_c - F_ia) / (effConduct + dFia)
            tsurf = jnp.where(iceOrNot, tsurf + delta, tsurf)
            tsurf = jnp.minimum(tsurf, TMELT)
        # postSolvTempIter = 2: recompute fluxes at the final
        # temperature; the returned flux is the FULL F_ia
        # (seaice_solve4temp.F output arg — F_ia_net is a local diag)
        F_c, F_ia, F_lh, _ = flux_terms(tsurf)
        tsurf_out = jnp.where(iceOrNot, tsurf, tsurf_in)
        FWsublim = jnp.where(iceOrNot, F_lh / lhSublim, 0.0)
        F_ia = jnp.where(iceOrNot, F_ia, 0.0)
        IcePenetSW = jnp.where(iceOrNot, IcePenetSW, 0.0)
        return tsurf_out, F_ia, IcePenetSW, FWsublim

    # ------------------------------------------------------------------
    def growth(self, ice: IceState, forc, theta0, salt0, dHn, dSn):
        """seaice_growth.F (0-layer, multDim, EXTERNAL_FLUXES).

        Returns (ice', dict of ocean forcing overrides, SItrHEFF stages,
        SItrAREA stages)."""
        p = self.p
        cfg = self.cfg
        g = self.grid
        c2k = cfg.celsius2K
        interior = self.interior
        if cfg.usingPCoords:
            dzSurf = float(cfg.delR[cfg.nr - 1]) / (cfg.rhoConst
                                                    * cfg.gravity)
        else:
            dzSurf = float(cfg.delR[0])
        recip_dtT = 1.0 / p.deltaTtherm
        ICE2SNOW = p.rhoIce / p.rhoSnow
        SNOW2ICE = 1.0 / ICE2SNOW
        QI = p.rhoIce * p.lhFusion
        recip_QI = 1.0 / QI
        lhSublim = p.lhEvap + p.lhFusion
        area_reg_sq = p.area_reg ** 2
        hice_reg_sq = p.hice_reg ** 2
        convertQ2HI = p.deltaTtherm / QI
        convertHI2Q = 1.0 / convertQ2HI
        convertPRECIP2HI = p.deltaTtherm * cfg.rhoConstFresh / p.rhoIce
        convertHI2PRECIP = 1.0 / convertPRECIP2HI
        denom = sum((it + 1) * p.pdf[it] for it in range(p.multDim))
        denom = 2.0 * denom - 1.0
        recip_denom = 1.0 / denom
        areaPDFfac = denom / p.multDim

        heff, hsnow, area, tices = ice.HEFF, ice.HSNOW, ice.AREA, ice.TICES
        HEFFpre, HSNWpre, AREApre = heff, hsnow, area
        stageH1 = heff
        stageA2 = area

        pos = HEFFpre > 0.0
        t1 = jnp.sqrt(AREApre * AREApre + area_reg_sq)
        t2 = HEFFpre / t1
        heffActual = jnp.where(pos, jnp.sqrt(t2 * t2 + hice_reg_sq), 0.0)
        hsnowActual = jnp.where(pos, HSNWpre / t1, 0.0)
        recip_heffActual = jnp.where(
            pos, AREApre / jnp.sqrt(HEFFpre * HEFFpre + hice_reg_sq), 0.0)
        latentHeatFluxMax = jnp.where(
            pos, lhSublim * recip_dtT
            * (HEFFpre * p.rhoIce + HSNWpre * p.rhoSnow)
            / jnp.where(pos, AREApre, 1.0), 0.0)

        UG = jnp.maximum(p.EPS, forc.wspeed)
        # open-water fluxes come straight from exf (budget_ocean.F with
        # SEAICE_EXTERNAL_FLUXES)
        a_QbyATM_open = forc.Qnet
        a_QSWbyATM_open = forc.Qsw

        # per-category surface solve
        s0 = salt0
        a_QbyATM_cover = jnp.zeros_like(heff)
        a_QSWbyATM_cover = jnp.zeros_like(heff)
        a_FWbySublim = jnp.zeros_like(heff)
        new_tices = []
        for it in range(p.multDim):
            pFac = (2.0 * (it + 1) - 1.0) * recip_denom
            pFacSnow = pFac if p.useMultDimSnow else 1.0
            ts, fia, pensw, fwsub = self.solve4temp(
                UG, heffActual * pFac, hsnowActual * pFacSnow,
                tices[it], forc, s0)
            new_tices.append(ts)
            a_QbyATM_cover = a_QbyATM_cover + fia * p.pdf[it]
            a_QSWbyATM_cover = a_QSWbyATM_cover + pensw * p.pdf[it]
            a_FWbySublim = a_FWbySublim + fwsub * p.pdf[it]
        tices = jnp.stack(new_tices)

        a_QbyATM_cover = a_QbyATM_cover * convertQ2HI * AREApre
        a_QSWbyATM_cover = a_QSWbyATM_cover * convertQ2HI * AREApre
        a_QbyATM_open = a_QbyATM_open * convertQ2HI * (1.0 - AREApre)
        a_QSWbyATM_open = a_QSWbyATM_open * convertQ2HI * (1.0 - AREApre)
        r_QbyATM_cover = a_QbyATM_cover
        r_QbyATM_open = a_QbyATM_open
        a_FWbySublim = (p.deltaTtherm / p.rhoIce) * a_FWbySublim * AREApre
        r_FWbySublim = a_FWbySublim

        # ocean-ice turbulent flux (growth.f PART 2 tail)
        tempFrz = p.tempFrz0 + p.dTempFrz_dS * salt0
        warm = theta0 >= tempFrz
        fac = jnp.where(warm, p.mcPheePiston,
                        p.frazilFrac * dzSurf / p.deltaTtherm)
        mltf = jnp.where(
            AREApre > 0.0,
            (1.0 - p.mcPheeTaper * AREApre) if not p.mcPheeStepFunc
            else (1.0 - p.mcPheeTaper), 1.0)
        turb = (-(cfg.HeatCapacity_Cp * cfg.rhoConst * recip_QI)
                * (theta0 - tempFrz) * p.deltaTtherm * self.HEFFM)
        a_QbyOCN = fac * turb * mltf
        r_QbyOCN = a_QbyOCN

        # ---- PART 3 ----
        # sublimation of snow then ice
        t2_ = jnp.maximum(jnp.minimum(r_FWbySublim, hsnow * SNOW2ICE),
                          0.0)
        d_HSNWbySublim = -t2_ * ICE2SNOW
        hsnow = hsnow - t2_ * ICE2SNOW
        r_FWbySublim = r_FWbySublim - t2_
        t2_ = jnp.maximum(jnp.minimum(r_FWbySublim, heff), 0.0)
        d_HEFFbySublim = -t2_
        heff = heff - t2_
        r_FWbySublim = r_FWbySublim - t2_
        a_QbyATM_cover = a_QbyATM_cover - r_FWbySublim
        r_QbyATM_cover = r_QbyATM_cover - r_FWbySublim

        # ice-ocean
        d_HEFFbyOCNonICE = jnp.maximum(r_QbyOCN, -heff)
        r_QbyOCN = r_QbyOCN - d_HEFFbyOCNonICE
        heff = heff + d_HEFFbyOCNonICE
        stageH2 = heff

        # snow melt by atmosphere
        t1_ = jnp.maximum(r_QbyATM_cover, -hsnow * SNOW2ICE)
        t2_ = jnp.minimum(t1_, 0.0)
        d_HSNWbyATMonSNW = t2_ * ICE2SNOW
        hsnow = hsnow + t2_ * ICE2SNOW
        r_QbyATM_cover = r_QbyATM_cover - t2_

        # ice melt/growth by atmosphere over ice
        t2_ = jnp.maximum(-heff, r_QbyATM_cover + AREApre * r_QbyOCN)
        d_HEFFbyATMonOCN_cover = t2_
        d_HEFFbyATMonOCN = t2_
        r_QbyATM_cover = r_QbyATM_cover - t2_
        heff = heff + t2_
        stageH3 = heff

        # precipitation to snow or freshwater
        snows = a_QbyATM_cover >= 0.0
        d_HSNWbyRAIN = jnp.where(
            snows, convertPRECIP2HI * ICE2SNOW * forc.precip * AREApre,
            0.0)
        d_HFRWbyRAIN = jnp.where(
            snows, 0.0, -convertPRECIP2HI * forc.precip * AREApre)
        hsnow = hsnow + d_HSNWbyRAIN

        # snow melt by ocean
        t1_ = jnp.maximum(r_QbyOCN * ICE2SNOW, -hsnow)
        t2_ = jnp.minimum(t1_, 0.0)
        d_HSNWbyOCNonSNW = t2_
        r_QbyOCN = r_QbyOCN - d_HSNWbyOCNonSNW * SNOW2ICE
        hsnow = hsnow + d_HSNWbyOCNonSNW

        # open-water ice growth
        facOpenGrow = 1.0 if p.doOpenWaterGrowth else 0.0
        facOpenMelt = 1.0 if p.doOpenWaterMelt else 0.0
        t4_ = heff
        t1_ = r_QbyATM_open + r_QbyOCN * (1.0 - AREApre)
        t2_ = self.SWFrac * a_QSWbyATM_open
        t3_ = facOpenGrow * jnp.maximum(
            t1_ - t2_, -t4_ * facOpenMelt) * self.HEFFM
        d_HEFFbyATMonOCN_open = t3_
        d_HEFFbyATMonOCN = d_HEFFbyATMonOCN + t3_
        r_QbyATM_open = r_QbyATM_open - t3_
        heff = heff + t3_
        stageH4 = heff

        # flooding
        if p.useFlooding:
            t0_ = (hsnow * p.rhoSnow + heff * p.rhoIce) / cfg.rhoConst
            t1_ = jnp.maximum(0.0, t0_ - heff)
            d_HEFFbyFLOODING = t1_
            heff = heff + t1_
            hsnow = hsnow - t1_ * ICE2SNOW
        else:
            d_HEFFbyFLOODING = jnp.zeros_like(heff)

        # ---- PART 4: area ----
        recip_HO = jnp.where(g.yC < 0.0, 1.0 / p.HO_south, 1.0 / p.HO)
        recip_HH = recip_heffActual
        if p.areaGainFormula == 1:
            gain = jnp.maximum(0.0, d_HEFFbyATMonOCN_open)
        else:
            gain = jnp.maximum(0.0, a_QbyATM_open)
        if p.areaLossFormula == 1:
            loss = (jnp.minimum(0.0, d_HEFFbyATMonOCN_cover)
                    + jnp.minimum(0.0, d_HEFFbyATMonOCN_open)
                    + jnp.minimum(0.0, d_HEFFbyOCNonICE))
        else:
            loss = jnp.minimum(0.0, d_HEFFbyATMonOCN_cover
                               + d_HEFFbyATMonOCN_open
                               + d_HEFFbyOCNonICE)
        some = jnp.logical_or(heff > 0.0, hsnow > 0.0)
        area = jnp.where(
            some,
            jnp.maximum(0.0, jnp.minimum(
                p.area_max,
                area + recip_HO * gain
                + 0.5 * recip_HH * loss * areaPDFfac)),
            0.0)
        stageA3 = area

        # ---- PART 5: salt flux ----
        t1_ = (dHn + d_HEFFbyOCNonICE + d_HEFFbyATMonOCN
               + d_HEFFbyFLOODING + d_HEFFbySublim)
        t3_ = jnp.maximum(0.0, jnp.minimum(p.salt0, salt0))
        saltFlux = t1_ * t3_ * self.HEFFM * recip_dtT * p.rhoIce

        # ---- PART 7: ocean forcing ----
        qnet = (r_QbyATM_cover + r_QbyATM_open + a_QSWbyATM_cover
                - (d_HEFFbyOCNonICE + d_HSNWbyOCNonSNW * SNOW2ICE
                   + dHn + dSn * SNOW2ICE) * self.HEFFM)
        qsw = a_QSWbyATM_cover + a_QSWbyATM_open
        qnet = qnet * convertHI2Q
        qsw = qsw * convertHI2Q
        empmr = self.HEFFM * (
            (forc.evap - forc.precip) * (1.0 - AREApre)
            - forc.runoff
            + (d_HSNWbyATMonSNW * SNOW2ICE + d_HFRWbyRAIN
               + d_HSNWbyOCNonSNW * SNOW2ICE + d_HEFFbyOCNonICE
               + d_HEFFbyATMonOCN + dHn + dSn * SNOW2ICE
               + r_FWbySublim) * convertHI2PRECIP
        ) * cfg.rhoConstFresh

        # SEAICEheatConsFix (seaice_growth.F:2230-2280): put the heat
        # content of the melt/freeze water exchange back into Qnet so the
        # ocean+ice system conserves heat under realFW + nonlin-FS
        if (p.heatConsFix and cfg.useRealFreshWaterFlux
                and cfg.nonlinFreeSurf > 0):
            tmpscal3 = cfg.rhoConstFresh * self.HEFFM * (
                (d_HSNWbyATMonSNW * SNOW2ICE + d_HSNWbyOCNonSNW * SNOW2ICE
                 + d_HEFFbyOCNonICE + d_HEFFbyATMonOCN
                 + dHn + dSn * SNOW2ICE) * convertHI2PRECIP)
            if cfg.temp_EvPrRn is not None:
                fixQ = -tmpscal3 * cfg.HeatCapacity_Cp * cfg.temp_EvPrRn
            else:
                fixQ = -tmpscal3 * cfg.HeatCapacity_Cp * theta0
            qnet = qnet + fixQ

        stageH5 = heff
        if getattr(self, "debug", False):
            # eager-mode introspection for digit-matching work
            self.last_debug = {
                "r_QbyATM_cover": r_QbyATM_cover,
                "r_QbyATM_open": r_QbyATM_open,
                "a_QSWbyATM_cover": a_QSWbyATM_cover,
                "a_QSWbyATM_open": a_QSWbyATM_open,
                "a_QbyOCN": a_QbyOCN,
                "d_HEFFbyOCNonICE": d_HEFFbyOCNonICE,
                "d_HSNWbyOCNonSNW": d_HSNWbyOCNonSNW,
                "dHn": dHn, "dSn": dSn,
                "d_HEFFbyATMonOCN": d_HEFFbyATMonOCN,
                "d_HEFFbyATMonOCN_open": d_HEFFbyATMonOCN_open,
                "open_t1": t1_, "open_t2": t2_,
                "facOpenGrow": facOpenGrow,
                "qnet": qnet, "qsw": qsw, "empmr": empmr,
                "saltFlux": saltFlux, "convertHI2Q": convertHI2Q,
            }
        # masked interior-only updates
        def m(a, b):
            return jnp.where(interior > 0, a, b)
        ice2 = ice._replace(
            HEFF=m(heff, ice.HEFF), HSNOW=m(hsnow, ice.HSNOW),
            AREA=m(area, ice.AREA),
            TICES=jnp.where(interior[None] > 0, tices, ice.TICES))
        stages_h = (stageH1, stageH2, stageH3, stageH4, stageH5)
        stages_a = (stageA2, stageA3)
        forc_upd = {"Qnet": m(qnet, forc.Qnet), "Qsw": m(qsw, forc.Qsw),
                    "EmPmR": m(empmr, forc.EmPmR),
                    "saltFlux": m(saltFlux, forc.saltFlux)}
        return ice2, forc_upd, stages_h, stages_a

    # ------------------------------------------------------------------
    def tracer_phys(self, ice: IceState, stages_h, stages_a):
        """seaice_tracer_phys.F (age / one tracers)."""
        p = self.p
        interior = self.interior
        sitr = ice.SItracer
        h1, h2, h3, h4, h5 = stages_h
        a2, a3 = stages_a
        for itr in range(p.SItrNumInUse):
            name = p.SItrName[itr]
            mate = p.SItrMate[itr]
            fromOcean = p.SItrFromOcean0[itr]
            fromFlood = p.SItrFromFlood0[itr]
            expand0 = p.SItrExpand0[itr]
            tr = sitr[itr]
            if mate == "HEFF":
                for hp, hn in ((h1, h2), (h2, h3), (h3, h4)):
                    growFact = jnp.where(hn > hp, hp / jnp.where(
                        hn > hp, hn, 1.0), 1.0)
                    tr = tr * growFact + fromOcean * (1.0 - growFact)
                growFact = jnp.where(h5 > h4, h4 / jnp.where(
                    h5 > h4, h5, 1.0), 1.0)
                tr = tr * growFact + fromFlood * (1.0 - growFact)
            else:
                expandFact = jnp.where(a3 > a2, a2 / jnp.where(
                    a3 > a2, a3, 1.0), 1.0)
                tr = tr * expandFact + expand0 * (1.0 - expandFact)
            if name == "age":
                live = (h5 > 0.0) if mate == "HEFF" else (a3 > 0.0)
                tr = jnp.where(live, tr + p.deltaTtherm, 0.0)
            # 'one', 'salinity', others: no source
            tr = jnp.where(interior > 0, tr, sitr[itr])
            sitr = sitr.at[itr].set(tr)
        return ice._replace(SItracer=sitr)

    # ------------------------------------------------------------------
    def step(self, ice: IceState, forc, uVel0, vVel0, etaN, theta0,
             salt0, fu, fv, phiHydLow=None):
        """SEAICE_MODEL (seaice_model.F): one sea-ice step.

        Returns (ice', forcing updates dict incl fu/fv)."""
        p = self.p
        g = self.grid
        # strength & bounds (seaice_dynsolver.F:68-75)
        press0 = (p.strength * ice.HEFF
                  * jnp.exp(-p.cStar * (1.0 - ice.AREA))) * self.HEFFM
        zMax = p.zetaMaxFac * press0
        zMin = jnp.full_like(press0, p.zetaMin)
        taux, tauy = self.get_dynforcing(ice, forc)

        massC = p.rhoIce * ice.HEFF
        massU = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, di=-1))
        massV = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, dj=-1))
        if p.addSnowMass:
            massC = massC + p.rhoSnow * ice.HSNOW
            massU = massU + p.rhoSnow * 0.5 * (ice.HSNOW
                                               + sh(ice.HSNOW, di=-1))
            massV = massV + p.rhoSnow * 0.5 * (ice.HSNOW
                                               + sh(ice.HSNOW, dj=-1))
        # seaice_dynsolver.F:225-238: in p-coords the tilt potential is
        # the actual sea-surface geopotential phiHydLow (previous
        # DYNAMICS vintage); in z-coords Bo_surf*etaN
        if phiHydLow is not None:
            phiSurf = phiHydLow
        else:
            phiSurf = g.Bo_surf * etaN
        if p.scaleSurfStress:
            # seaice_dynsolver.F:266-273: wind stress scaled by the
            # ice-concentration fraction at the velocity point
            forcex0 = taux * 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            forcey0 = tauy * 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            forcex0 = taux
            forcey0 = tauy
        if p.useTilt:
            forcex0 = forcex0 - massU * g.recip_dxC * (
                phiSurf - sh(phiSurf, di=-1))
            forcey0 = forcey0 - massV * g.recip_dyC * (
                phiSurf - sh(phiSurf, dj=-1))

        stressDivX = stressDivY = None
        if p.useDYNAMICS and p.useFreeDrift:
            # seaice_dynsolver.F:303-321: uIce := uice_fd; nothing in
            # the free-drift path updates DWATN, so SEAICE_OCEAN_STRESS
            # runs with the stale init-time zeros (seaice_init_varia.F:79)
            uIce, vIce = self.freedrift(ice, uVel0, vVel0,
                                        forcex0, forcey0)
            ice = ice._replace(uIce=uIce, vIce=vIce)
            dwatn = jnp.zeros_like(press0)
        elif p.useDYNAMICS and p.useEVP:
            (uIce, vIce, dwatn, sigma, stressDivX,
             stressDivY) = self.evp(ice, forc, uVel0, vVel0, press0,
                                    massC, massU, massV, forcex0, forcey0)
            ice = ice._replace(uIce=uIce, vIce=vIce, sigma=sigma)
        elif p.useDYNAMICS:
            uIce, vIce, dwatn = self.lsr(
                ice, forc, uVel0, vVel0, etaN, press0, zMax, zMin,
                massC, massU, massV, forcex0, forcey0)
            ice = ice._replace(uIce=uIce, vIce=vIce)
        else:
            dwatn = self.oceandrag(ice.uIce, ice.vIce, uVel0, vVel0)

        upd = {}
        if p.updateOceanStress:
            if p.useHB87stressCoupling:
                if stressDivX is None:
                    raise NotImplementedError(
                        "useHB87StressCoupling needs the C-grid stress "
                        "divergence (EVP/LSR solver)")
                fu2, fv2 = self.ocean_stress_hb87(
                    ice, taux, tauy, stressDivX, stressDivY, fu, fv)
            else:
                fu2, fv2 = self.ocean_stress(ice, dwatn, uVel0, vVel0,
                                             fu, fv)
            upd["fu"] = fu2
            upd["fv"] = fv2
        if p.useDYNAMICS and p.useEVP and p.clipVelocities:
            # seaice_dynsolver.F:387-405: cap AFTER the ocean stress
            ice = ice._replace(uIce=jnp.clip(ice.uIce, -0.40, 0.40),
                               vIce=jnp.clip(ice.vIce, -0.40, 0.40))

        ice = self.advdiff(ice)
        ice, dHn, dSn = self.reg_ridge(ice)
        ice, forc_upd, stages_h, stages_a = self.growth(
            ice, forc, theta0, salt0, dHn, dSn)
        upd.update(forc_upd)
        ice = self.tracer_phys(ice, stages_h, stages_a)
        # end-of-step exchanges (seaice_model.F:1411-1420)
        ice = ice._replace(
            HEFF=self.fill(ice.HEFF), AREA=self.fill(ice.AREA),
            HSNOW=self.fill(ice.HSNOW),
            SItracer=self.fill(ice.SItracer)
            if ice.SItracer.shape[0] else ice.SItracer,
            TICES=self.fill(ice.TICES))
        for k in ("Qnet", "Qsw", "EmPmR", "saltFlux"):
            upd[k] = self.fill(upd[k])
        return ice, upd
