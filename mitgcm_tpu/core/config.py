"""Runtime configuration: the model parameter set.

Mirrors the reference's ~600 PARM01-05 runtime parameters (declared in
model/inc/PARAMS.h, defaults in model/src/set_defaults.F, namelist input in
model/src/ini_parms.F, derived values in model/src/set_parms.F) as a plain
Python dataclass. Only parameters wired into implemented physics are listed;
unknown namelist entries are kept in `extra` so configs never fail silently.

The config is static: it is closed over by jit-compiled step functions, so
every flag is a Python (trace-time) constant and XLA sees fully specialized
code — the analog of the reference's compile-time CPP selection.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from mitgcm_tpu.core import nml

UNSET = None


@dataclass
class Config:
    # --- domain size (SIZE.h analog) ---
    nx: int = 0
    ny: int = 0
    nr: int = 1
    olx: int = 2
    oly: int = 2

    # --- PARM01: continuous equation ---
    viscAh: float = 0.0
    viscA4: float = 0.0
    # horizontal viscosity for wVel (ini_parms.F:510-511: default viscAhD
    # which itself defaults to viscAh)
    viscAhW: float = UNSET
    viscA4W: float = UNSET
    viscAz: float = UNSET          # vertical viscosity (m2/s), z-coords
    viscAr: float = 0.0
    diffKhT: float = 0.0
    diffK4T: float = 0.0
    diffKzT: float = UNSET
    diffKrT: float = 0.0
    diffKhS: float = 0.0
    diffK4S: float = 0.0
    diffKzS: float = UNSET
    diffKrS: float = 0.0
    # Bryan & Lewis 1979 depth-dependent background diffusivity
    # (set_defaults.F:159-162; profile formula calc_3d_diffusivity.F:85)
    diffKrBL79surf: float = 0.0
    diffKrBL79deep: float = 0.0
    diffKrBL79scl: float = 200.0
    diffKrBL79Ho: float = -2000.0
    f0: float = 1.0e-4        # set_defaults.F:111
    beta: float = 0.0
    fPrime: float = 0.0
    omega: float = UNSET           # default 2pi/86164 s (set_parms)
    rotationPeriod: float = 86164.0
    rhoConst: float = UNSET        # defaults to rhoNil (ini_parms.F:476)
    rhoNil: float = 999.8
    gravity: float = 9.81
    sIceLoadFac: float = 1.0       # scale of sea-ice mass loading (PARM01)
    gBaro: float = UNSET           # defaults to gravity
    rigidLid: bool = False
    implicitFreeSurface: bool = True
    eosType: str = "LINEAR"
    tAlpha: float = 2.0e-4
    sBeta: float = 7.4e-4
    tRef: Tuple[float, ...] = ()
    sRef: Tuple[float, ...] = ()
    tRefFile: str = ""
    sRefFile: str = ""
    no_slip_sides: bool = True
    no_slip_bottom: bool = True
    sideDragFactor: float = 2.0
    bottomDragLinear: float = 0.0
    bottomDragQuadratic: float = 0.0
    selectBotDragQuadr: int = -1
    momViscosity: bool = True
    momAdvection: bool = True
    momForcing: bool = True
    momStepping: bool = True
    momPressureForcing: bool = True
    metricTerms: bool = True
    selectMetricTerms: int = UNSET
    useNHMTerms: bool = False
    implicitDiffusion: bool = False
    implicitViscosity: bool = False
    tempStepping: bool = True
    saltStepping: bool = True
    tempAdvection: bool = True
    saltAdvection: bool = True
    tempForcing: bool = True
    saltForcing: bool = True
    vectorInvariantMomentum: bool = False
    staggerTimeStep: bool = False
    useRealFreshWaterFlux: bool = False
    exactConserv: bool = False
    nonlinFreeSurf: int = 0
    select_rStar: int = 0
    implicSurfPress: float = 1.0
    implicDiv2Dflow: float = 1.0
    hFacMin: float = 1.0
    hFacMinDr: float = 0.0
    hFacInf: float = 0.2
    hFacSup: float = 2.0
    useMin4hFacEdges: bool = False
    selectCoriScheme: int = UNSET
    useJamartWetPoints: bool = False
    useEnergyConservingCoriolis: bool = False
    selectKEscheme: int = 0
    selectVortScheme: int = UNSET
    useAbsVorticity: bool = False
    upwindVorticity: bool = False
    highOrderVorticity: bool = False
    selectAddFluid: int = 0
    uniformLin_PhiSurf: bool = True
    linFSConserveTr: bool = False
    convertFW2Salt: float = UNSET
    temp_EvPrRn: float = UNSET
    salt_EvPrRn: float = 0.0
    readBinaryPrec: int = 32
    writeBinaryPrec: int = 32
    writeStatePrec: int = 64
    globalFiles: bool = True
    debugLevel: int = 1
    ivdc_kappa: float = 0.0
    cAdjFreq: float = 0.0
    hMixCriteria: float = -0.8
    rSphere: float = 6.37e6
    cosPower: float = 0.0          # cos(lat)^n anisotropic visc/diff scaling
    tempAdvScheme: int = 2
    saltAdvScheme: int = 2
    tempVertAdvScheme: int = UNSET
    saltVertAdvScheme: int = UNSET
    multiDimAdvection: bool = True
    tempImplVertAdv: bool = False
    saltImplVertAdv: bool = False
    viscAhGrid: float = 0.0
    viscA4Grid: float = 0.0
    viscAhMax: float = 1.0e21
    viscA4Max: float = 1.0e21
    viscAhGridMax: float = 1.0e21  # coeff on the L2/(4dt) CFL cap
    viscAhGridMin: float = 0.0
    viscA4GridMax: float = 1.0e21  # factor applied as coeff*rA^2/dt caps
    viscA4GridMin: float = 0.0
    # grid-Reynolds-number viscosity floors (mom_calc_visc.F:103-112)
    viscAhReMax: float = 0.0
    viscA4ReMax: float = 0.0
    # background viscosities split by location: Div (C) / vort (Z) points
    # (ini_parms.F: default to viscAh/viscA4 when unset)
    viscAhD: float = UNSET
    viscAhZ: float = UNSET
    viscA4D: float = UNSET
    viscA4Z: float = UNSET
    useAreaViscLength: bool = False
    viscC2LeithQG: float = 0.0
    viscC2leith: float = 0.0
    viscC2leithD: float = 0.0
    viscC4leith: float = 0.0
    viscC4leithD: float = 0.0
    viscC2smag: float = 0.0
    viscC4smag: float = 0.0
    useFullLeith: bool = False
    useSmag3D: bool = False
    useStrainTensionVisc: bool = False
    quasiHydrostatic: bool = False
    nonHydrostatic: bool = False
    use3dCoriolis: bool = True
    select3dCoriScheme: int = UNSET
    rhoConstFresh: float = UNSET
    allowFreezing: bool = False
    shortwaveHeating: bool = False   # CPP SHORTWAVE_HEATING
    # CPP ALLOW_3D_DIFFKR: one 3-D vertical diffusivity for all tracers,
    # initialised from the diffKrNrS profile (ini_mixing.F:45)
    allow3dDiffKr: bool = False
    # deck-override ptracers_forcing_surf.F applying surfaceForcingS to
    # every passive tracer (tutorial_tracer_adjsens code_ad)
    ptracersForcingLikeSalt: bool = False
    buoyancyRelation: str = "OCEANIC"
    atm_Rq: float = 0.0
    top_Pres: float = 0.0
    usingPCoords: bool = False
    usingZCoords: bool = True
    fluidIsAir: bool = False
    fluidIsWater: bool = True
    nFaces: int = 1                # 6 for the cubed sphere
    # distributed cubed sphere: this process holds ONE face of a cube
    # (mitgcm_tpu/parallel/dist.py DistCSModel) — nFaces==1 locally, but
    # the cube-corner code paths (FILL_CS_CORNER_*, no-wrap vorticity
    # stencils) must still run on the local face block
    csLocalFace: bool = False

    @property
    def onCubeFace(self) -> bool:
        """True when the arrays contain cubed-sphere face block(s) — the
        full stacked cube (nFaces==6) or one distributed face."""
        return self.nFaces > 1 or self.csLocalFace
    gadMultiDimCompressible: bool = False  # GAD_MULTIDIM_COMPRESSIBLE
    # exch2 global-file IO layout (pkg/exch2/w2_readparms.F:64 default -1):
    # -1/0 = global 2-D map, faces side by side along x ([n, 6n]);
    #  1   = compact, faces stacked along y ([6n, n])
    W2_mapIO: int = -1
    custom_forcing_uv: object = None   # f(cfg,grid,state)->(gu,gv) 3-D adds
    custom_forcing_t: object = None    # f(cfg,grid,state)->gT 3-D add
    useSHAP_FILT: bool = False
    shap: object = None                # ShapParams (data.shap)
    zonfilt: object = None             # ZonFiltParams (data.zonfilt)
    aim: object = None                 # AimParams (data.aimphys)
    grid_dir: str = ""                 # where tile*.mitgrid / input .bin
                                       # files live when not in run_dir
                                       # (verification prepare_run links)
    selectP_inEOS_Zc: int = UNSET      # set_parms.F:268 (2 for JMD95P etc)
    integr_GeoPot: int = 2             # set_defaults.F:136 (1=FV, 2=FD)
    selectFindRoSurf: int = 0          # 1: Po_surf from analytic theta
    geoPotAnomFile: str = ""           # phi0surf input (ini_linear_phisurf.F)
    surf_pRef: float = 101325.0        # set_defaults.F:103
    eosRefP0: float = 101325.0         # ini_eos.F:82
    celsius2K: float = 273.15
    atm_Cp: float = 1004.0
    atm_Rd: float = UNSET
    alph_AB: float = UNSET         # set -> Adams-Bashforth-3 time stepping
    beta_AB: float = UNSET
    useAB3: bool = False
    atm_kappa: float = 2.0 / 7.0
    atm_Po: float = 1.0e5
    thetaConst: float = UNSET
    HeatCapacity_Cp: float = 3994.0
    gravitySign: float = -1.0
    rkSign: float = -1.0

    # --- PARM02: elliptic solver ---
    cg2dMaxIters: int = 150
    # replicate the reference's sequential per-tile dot-product summation
    # order inside cg2d (bit-exact digit matching on solver-amplified
    # configs); tree-reduction jnp.sum otherwise (the default)
    cg2dExactSums: bool = False
    cg2dTargetResidual: float = 1.0e-7
    cg2dTargetResWunit: float = -1.0
    cg2dpcOffDFac: float = 0.51
    cg2dUseMinResSol: int = UNSET
    cg2dPreCondFreq: int = 1
    printResidualFreq: int = 0
    useSRCGSolver: bool = False
    cg3dMaxIters: int = 150
    cg3dTargetResidual: float = 1.0e-7
    cg3dTargetResWunit: float = -1.0
    # non-hydrostatic parameters (PARM01; set_defaults.F:214-220)
    nh_Am2: float = 1.0
    implicitNHPress: float = UNSET   # defaults to implicSurfPress
    selectNHfreeSurf: int = 0
    implicitIntGravWave: bool = False

    # --- PARM03: time stepping ---
    tauCD: float = 0.0
    rCD: float = -1.0
    epsAB_CD: float = UNSET
    useCDscheme: bool = False
    nIter0: int = 0
    nTimeSteps: int = 0
    deltaT: float = 0.0
    deltaTMom: float = 0.0
    deltaTTracer: float = 0.0
    deltaTFreeSurf: float = 0.0
    deltaTClock: float = 0.0
    abEps: float = 0.01
    momForcingOutAB: int = UNSET
    tracForcingOutAB: int = UNSET
    momDissip_In_AB: bool = True
    doAB_onGtGs: bool = True
    forcing_In_AB: bool = True
    baseTime: float = 0.0
    startTime: float = UNSET
    endTime: float = UNSET
    pChkptFreq: float = 0.0
    chkptFreq: float = 0.0
    dumpFreq: float = 0.0
    monitorFreq: float = UNSET
    monitorSelect: int = UNSET
    # Emit monitor stats with the pre-2009 formulas (MON_STATS_RL del2 =
    # 0.25*sum|masked laplacian|/nPts without sqrt; W_hf CFL on recip_drC).
    # Some committed verification outputs (e.g. aim.5l_LatLon) predate the
    # 2009/12/21 switch to MON_CALC_STATS_RL and can only be digit-matched
    # with the old formulas. Not a namelist parameter: set per-experiment.
    # hs94.cs-32x32x5's output sits between the two monitor revisions:
    # legacy del2 but the modern recip_drF W_hf — hence two flags.
    monitorLegacyStats: bool = False
    monitorLegacyWhf: bool = UNSET   # defaults to monitorLegacyStats
    externForcingPeriod: float = 0.0
    externForcingCycle: float = 0.0
    periodicExternalForcing: bool = False
    pickupStrictlyMatch: bool = True
    pickupSuff: str = ""
    startFromPickup: bool = False   # sets AB history validity (startAB=1)
    tauThetaClimRelax: float = 0.0
    tauSaltClimRelax: float = 0.0

    # --- PARM04: gridding ---
    usingCartesianGrid: bool = False
    usingSphericalPolarGrid: bool = False
    usingCylindricalGrid: bool = False
    usingCurvilinearGrid: bool = False
    dxSpacing: float = UNSET
    dySpacing: float = UNSET
    delX: Tuple[float, ...] = ()
    delY: Tuple[float, ...] = ()
    delR: Tuple[float, ...] = ()
    delRc: Tuple[float, ...] = ()
    delRFile: str = ""
    delXfile: str = ""
    delYfile: str = ""
    xgOrigin: float = 0.0
    ygOrigin: float = 0.0
    rSphereC: float = UNSET
    phiMin: float = 0.0
    thetaMin: float = 0.0
    deepAtmosphere: bool = False
    seaLev_Z: float = 0.0
    horizGridFile: str = ""
    radius_fromHorizGrid: float = UNSET

    # --- PARM05: input files ---
    bathyFile: str = ""
    topoFile: str = ""
    hydrogThetaFile: str = ""
    hydrogSaltFile: str = ""
    zonalWindFile: str = ""
    meridWindFile: str = ""
    thetaClimFile: str = ""
    saltClimFile: str = ""
    surfQFile: str = ""
    surfQnetFile: str = ""
    surfQswFile: str = ""
    EmPmRFile: str = ""
    saltFluxFile: str = ""
    pLoadFile: str = ""
    uVelInitFile: str = ""
    vVelInitFile: str = ""
    pSurfInitFile: str = ""
    checkIniTemp: bool = True
    checkIniSalt: bool = True

    # --- packages on/off (data.pkg analog) ---
    useMONITOR: bool = True
    useMNC: bool = False
    useGMRedi: bool = False
    useEXF: bool = False
    useCAL: bool = False
    exf_climtempfreeze: object = None  # set by model/exf.py when useEXF
    exf_useBulk: bool = False          # exf bulk-formulae mode (atemp set)
    exf_bulk: object = None            # bulk constants dict (EXF_NML_01)
    exf_useAtmWind: bool = True        # ALLOW_ATM_WIND / useAtmWind
    exf_ly04: bool = False             # ALLOW_BULK_LARGEYEAGER04
    exf_stressCgrid: bool = False      # readStressOnCgrid
    exf_runoftemp: bool = False        # runoftempfile present
    # reference tile decomposition (SIZE.h): the seaice LSR tridiagonal
    # sweeps are per-tile, so digit-matching needs the tile shape
    sNx: int = 0
    sNy: int = 0
    nSx: int = 1
    nSy: int = 1
    seaice: object = None              # SeaiceParams when useSEAICE
    poly3: object = None               # POLY3.COEFFS (refT,refS,sig0,C)
    useKPP: bool = False
    useGGL90: bool = False
    usePP81: bool = False
    useMY82: bool = False
    useOPPS: bool = False
    useSEAICE: bool = False
    useEXF: bool = False
    useCAL: bool = False
    useOBCS: bool = False
    usePTRACERS: bool = False
    useRBCS: bool = False
    useDiagnostics: bool = False
    useAIM: bool = False
    useLand: bool = False
    useThSIce: bool = False
    useZONAL_FILT: bool = False
    useOffLine: bool = False
    useGCHEM: bool = False
    # pkg/grdchk: finite-difference gradient checks (driven offline by
    # mitgcm_tpu.ad.grdchk, not inside the step)
    useGrdchk: bool = False
    # PARM02 useNSACGSolver selects cg2d_nsa.F (fixed-iteration, AD-safe
    # "no solver assumptions" CG). Our cg2d is already AD-safe via its
    # custom implicit-function VJP (solver/cg2d.py), so the flag only
    # records the deck's intent.
    useNSACGSolver: bool = False

    # package parameter groups (loaded from data.<pkg>)
    gmredi: Any = None
    ptracers: Any = None
    offline: Any = None                # OfflineParams when useOffLine
    gchem: Any = None                  # data.gchem GCHEM_PARM01 dict
    obcs: Any = None                   # OBCSParams when useOBCS
    custom_obcs_calc: Any = None       # analytic obcs_calc.F override hook

    # run-directory context + overflow storage
    run_dir: str = "."
    extra: Dict[str, Any] = field(default_factory=dict)

    # ---------------- derived (filled by finalize) ----------------
    mass2rUnit: float = 0.0
    rUnit2mass: float = 0.0
    freeSurfFac: float = 1.0
    recip_rhoConst: float = 0.0

    @property
    def ksurf0(self) -> int:
        """0-based surface-level index (kSurface in
        external_forcing_surf.F:103-109: Nr under p-coords, 1 else)."""
        return self.nr - 1 if self.usingPCoords else 0

    def find_code_file(self, fname: str) -> str:
        """Resolve a compile-options header: <deck>/../code/<fname> for
        the run dir and every grid_dir search entry (linked decks share
        the parent experiment's code/)."""
        cands = [self.run_dir] + (self.grid_dir.split(os.pathsep)
                                  if self.grid_dir else [])
        # AD decks (input_ad/input_tap) build from code_ad/code_tap,
        # which themselves fall back to the forward code/ dir
        subs = ["code"]
        base = os.path.basename(os.path.abspath(self.run_dir))
        if base.startswith("input_ad"):
            subs = ["code_ad", "code"]
        elif base.startswith("input_tap"):
            subs = ["code_tap", "code_ad", "code"]
        for d in cands:
            for sub in subs:
                p = os.path.join(os.path.dirname(os.path.abspath(d)),
                                 sub, fname)
                if os.path.exists(p):
                    return p
        return ""

    def find_file(self, fname: str) -> str:
        """Resolve an input file: run_dir first, then grid_dir (the
        reference's prepare_run symlinks files from sibling decks;
        grid_dir may hold several os.pathsep-separated directories)."""
        p1 = os.path.join(self.run_dir, fname)
        if os.path.exists(p1) or not self.grid_dir:
            return p1
        for d in self.grid_dir.split(os.pathsep):
            p2 = os.path.join(d, fname)
            if os.path.exists(p2):
                return p2
        return p1

    def finalize(self) -> "Config":
        """Resolve UNSET/derived parameters (ini_parms.F / set_parms.F)."""
        c = self
        # buoyancy relation -> coordinate system (set_parms.F)
        br = (c.buoyancyRelation or "OCEANIC").upper()
        if br == "ATMOSPHERIC":
            c.fluidIsAir = True
            c.fluidIsWater = False
            c.usingPCoords = True
            c.usingZCoords = False
            c.gravitySign = 1.0
        elif br == "OCEANICP":
            c.usingPCoords = True
            c.usingZCoords = False
            c.gravitySign = 1.0
        if c.usingCurvilinearGrid:
            c.nFaces = 6
        if c.gBaro is UNSET:
            c.gBaro = c.gravity
        if c.alph_AB is not UNSET:
            c.useAB3 = True
            if c.beta_AB is UNSET:
                c.beta_AB = 5.0 / 12.0    # set_defaults.F:319
        if c.atm_Rd is UNSET:
            c.atm_Rd = c.atm_Cp * c.atm_kappa     # ini_parms.F:490
        else:
            c.atm_kappa = c.atm_Rd / c.atm_Cp
        if c.omega is UNSET:
            c.omega = 2.0 * math.pi / c.rotationPeriod if c.rotationPeriod else 0.0
        # deltaT family (ini_parms.F:1013-1016): deltaT defaults from
        # deltaTClock FIRST, then deltaTtracer, deltaTMom, deltaTFreeSurf
        dt = (c.deltaT or c.deltaTClock or c.deltaTTracer or c.deltaTMom
              or c.deltaTFreeSurf)
        c.deltaT = c.deltaT or dt
        c.deltaTMom = c.deltaTMom or dt
        c.deltaTTracer = c.deltaTTracer or dt
        c.deltaTFreeSurf = c.deltaTFreeSurf or c.deltaTMom
        c.deltaTClock = c.deltaTClock or dt
        if c.startTime is UNSET and c.nIter0 is not None:
            # ini_parms.F: startTime = baseTime + nIter0*deltaTClock
            c.startTime = c.baseTime + c.nIter0 * (c.deltaTClock or 0.0)
        if (c.nTimeSteps == 0 and c.endTime is not UNSET and c.endTime
                and c.deltaTClock):
            # ini_parms.F:1112: NINT((endTime-startTime)/deltaTClock)
            c.nTimeSteps = int(round((c.endTime - c.startTime)
                                     / c.deltaTClock))
        # vertical mixing coefficient aliases (z-coords)
        if c.viscAz is not UNSET:
            c.viscAr = c.viscAz
        if c.diffKzT is not UNSET:
            c.diffKrT = c.diffKzT
        if c.diffKzS is not UNSET:
            c.diffKrS = c.diffKzS
        # Div/vort-point background viscosities (ini_parms.F:505-508)
        if c.viscAhD is UNSET:
            c.viscAhD = c.viscAh
        if c.viscAhZ is UNSET:
            c.viscAhZ = c.viscAh
        if c.viscA4D is UNSET:
            c.viscA4D = c.viscA4
        if c.viscA4Z is UNSET:
            c.viscA4Z = c.viscA4
        # wVel viscosities (ini_parms.F:510-511, viscAhD/viscA4D chain)
        if c.viscAhW is UNSET:
            c.viscAhW = c.viscAhD
        if c.viscA4W is UNSET:
            c.viscA4W = c.viscA4D
        if c.implicitNHPress is UNSET:
            c.implicitNHPress = c.implicSurfPress
        # freeSurfFac (ini_parms.F:473)
        c.freeSurfFac = 0.0 if c.rigidLid else 1.0
        # rhoConst defaults to rhoNil (ini_parms.F:476)
        if c.rhoConst is UNSET:
            c.rhoConst = c.rhoNil
        # mass <-> r-unit conversion (ini_parms.F:1542-1545)
        c.recip_rhoConst = 1.0 / c.rhoConst
        if c.usingPCoords:
            c.mass2rUnit = c.gravity
        else:
            c.mass2rUnit = c.recip_rhoConst
        c.rUnit2mass = 1.0 / c.mass2rUnit
        # AB forcing placement (ini_parms.F:1065)
        if c.momForcingOutAB is UNSET:
            c.momForcingOutAB = 0 if c.forcing_In_AB else 1
        if c.tracForcingOutAB is UNSET:
            c.tracForcingOutAB = 0 if c.forcing_In_AB else 1
        # Coriolis scheme (ini_parms.F:648)
        if c.selectCoriScheme is UNSET:
            s = 0
            if c.useJamartWetPoints:
                s = 1
            if c.useEnergyConservingCoriolis and not c.vectorInvariantMomentum:
                s += 2
            c.selectCoriScheme = s
        if c.select3dCoriScheme is UNSET:
            # vintage default (matches the committed verification
            # outputs): on only for quasi/non-hydrostatic runs
            c.select3dCoriScheme = (
                1 if (c.quasiHydrostatic or c.nonHydrostatic) else 0)
        if c.selectP_inEOS_Zc is UNSET:
            c.selectP_inEOS_Zc = (
                2 if c.eosType.upper() in ("JMD95P", "UNESCO", "MDJWF",
                                           "TEOS10") else 0)
        if c.selectMetricTerms is UNSET:
            c.selectMetricTerms = 1 if c.metricTerms else 0
        # cg2d min-residual solution (ini_parms.F:1557)
        if c.cg2dUseMinResSol is UNSET:
            c.cg2dUseMinResSol = (
                1 if (not c.topoFile and not c.bathyFile and c.usingCartesianGrid)
                else 0
            )
        if c.monitorFreq is UNSET:
            c.monitorFreq = c.deltaTClock
        if c.monitorSelect is UNSET:
            # ini_parms.F:1170: default 2, but 3 for water
            c.monitorSelect = 3 if not c.fluidIsAir else 2
        # reference profiles
        if not c.tRef:
            c.tRef = tuple([20.0] * c.nr)
        elif len(c.tRef) < c.nr:
            c.tRef = tuple(list(c.tRef) + [c.tRef[-1]] * (c.nr - len(c.tRef)))
        if not c.sRef:
            c.sRef = tuple([30.0] * c.nr)
        elif len(c.sRef) < c.nr:
            c.sRef = tuple(list(c.sRef) + [c.sRef[-1]] * (c.nr - len(c.sRef)))
        if c.convertFW2Salt is UNSET:
            c.convertFW2Salt = -1.0 if c.useRealFreshWaterFlux else 35.0
        if c.rhoConstFresh is UNSET:
            c.rhoConstFresh = c.rhoConst
        if c.epsAB_CD is UNSET:
            c.epsAB_CD = c.abEps
        if c.useCDscheme and c.tauCD == 0.0:
            c.tauCD = c.deltaTMom
        # dxSpacing/dySpacing: uniform grid spacing shorthands
        # (ini_parms.F:940-950, override delX/delY)
        for key, tgt in (("dxspacing", "delX"), ("dyspacing", "delY")):
            for k, v in list(c.extra.items()):
                if k.lower() == key:
                    n = c.nx if tgt == "delX" else c.ny
                    setattr(c, tgt, tuple([float(v)] * max(n, 1)))
        return c


# namelist name (lower) -> Config attribute; identity unless listed
_ALIASES = {
    "viscah": "viscAh",
    "visca4": "viscA4",
    "viscaz": "viscAz",
    "viscar": "viscAr",
    "diffkht": "diffKhT",
    "diffkzt": "diffKzT",
    "diffkrt": "diffKrT",
    "diffkhs": "diffKhS",
    "diffkzs": "diffKzS",
    "diffkrs": "diffKrS",
    # vertical grid spacing synonyms (ini_parms.F: delZ for z-coords,
    # delP for p-coords, both land in delRDefault)
    "delz": "delR",
    "delp": "delR",
    # ini_parms.F:637-638: hFacMinDr takes hFacMinDz (z-coords) or
    # hFacMinDp (p-coords) when not set directly
    "hfacmindz": "hFacMinDr",
    "hfacmindp": "hFacMinDr",
}


def _set_attr(cfg: Config, key: str, val: Any) -> None:
    key_l = key.lower()
    # strip any array-index suffix e.g. fields(1,1)
    if "(" in key_l:
        cfg.extra[key] = val
        return
    target = None
    for f in dataclasses.fields(Config):
        if f.name.lower() == key_l:
            target = f.name
            break
    if target is None:
        target = _ALIASES.get(key_l)
    if target is None:
        cfg.extra[key] = val
        return
    cur = getattr(cfg, target)
    if isinstance(cur, tuple) or target in ("tRef", "sRef", "delX", "delY", "delR", "delRc"):
        if not isinstance(val, list):
            val = [val]
        setattr(cfg, target, tuple(float(v) for v in val))
    elif isinstance(cur, str):
        if isinstance(val, list):
            val = val[0] if val else ""
        setattr(cfg, target, str(val) if val is not None else "")
    elif isinstance(val, list):
        setattr(cfg, target, tuple(val) if val else cur)
    else:
        setattr(cfg, target, val)


def _code_dirs(input_dir: str):
    """Candidate code dirs for a deck: input_ad builds from code_ad (falling
    back to code/), input_tap from code_tap, plain input from code/."""
    parent = os.path.dirname(os.path.abspath(input_dir))
    base = os.path.basename(os.path.abspath(input_dir))
    if base.startswith("input_ad"):
        subs = ["code_ad", "code"]
    elif base.startswith("input_tap"):
        subs = ["code_tap", "code_ad", "code"]
    else:
        subs = ["code"]
    return [os.path.join(parent, s) for s in subs]


def read_size_h(code_dir: str):
    """Parse sNx/sNy/Nr/OLx/OLy/nSx/nPx... assignments from a reference
    SIZE.h (model/inc/SIZE.h format: `&  sNx =  32,`)."""
    import re as _re
    path = os.path.join(code_dir, "SIZE.h")
    out = {}
    if not os.path.exists(path):
        return out
    for line in open(path, errors="replace"):
        if line[:1] in ("C", "c", "!"):
            continue
        for m in _re.finditer(r"(\w+)\s*=\s*(\d+)", line):
            out[m.group(1)] = int(m.group(2))
    return out


# namelist keys with no effect on the computed solution (IO cadence,
# precision of file output, runtime chatter); accepted silently by
# config_check rather than failing the run (model/src/config_check.F
# analog: anything else unknown raises)
_IGNORABLE_KEYS = {
    "tavefreq", "tavefreq_diag", "usesinglecpuio", "monitorselect",
    "debuglevel", "plotlevel", "dumpinitandlast", "pickupsuff",
    "writepickupatend", "rwsuffixtype", "adjmonitorfreq", "diagfreq",
    "adjdumpfreq", "outputtypesinclusive", "usemnc", "debugmode",
    "the_run_name", "usecoordletter", "readpickupwithtracer",
    "writepickupwithtracer", "globalfiles", "useexfcheckrange",
    "dumpatlast", "diag_mnc", "diagst_mnc", "timeave_mnc", "snapshot_mnc",
    "monitor_mnc", "pickup_mnc", "mdsiolocaldir", "checkinitemp",
    "checkinisalt",
    # diagnostic-only packages: they sample/report the state but never
    # feed back into it (pkg/sbo angular-momentum budgets, pkg/profiles
    # observation sampling), so a deck enabling them still computes the
    # same solution
    "usesbo", "useprofiles", "uselayers",
    # hFac recompute-from-pickup control (ini_masks_etc.F); our grids are
    # always rebuilt from the bathymetry so both settings are equivalent
    "doresethfactors",
}


class ConfigCheckError(ValueError):
    """Raised when a deck requests parameters/packages the framework
    does not implement (fail-loudly analog of config_check.F)."""


def config_check(cfg: Config, strict: bool = True) -> List[str]:
    """Return (and optionally raise on) namelist keys that were read but
    not understood.  The reference's CONFIG_CHECK stops the run on
    inconsistent/unsupported settings; silently dropping a key here can
    silently change the physics, so unknown non-IO keys are fatal."""
    unknown = sorted(k for k in cfg.extra
                     if k.split("(")[0].lower() not in _IGNORABLE_KEYS)
    if unknown and strict:
        raise ConfigCheckError(
            "config_check: deck parameters not implemented by mitgcm_tpu: "
            + ", ".join(unknown)
            + "  (pass strict_config=False to run anyway)")
    return unknown


def ref_output_vintage(input_dir: str) -> Optional[tuple]:
    """MITgcm version that produced the deck's committed reference output
    ("// MITgcmUV version: checkpoint67t" in ../results/output.txt), as a
    comparable tuple (67, 't').  None when no results file is present.
    Verification decks in the reference repo carry outputs generated by
    different code vintages; a few behaviors (e.g. GM Kux/Kvy tapering)
    changed between them, and digit-matching requires honoring the stamp."""
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(input_dir)),
                        "results", "output.txt")
    if not os.path.exists(path):
        return None
    try:
        with open(path, errors="replace") as f:
            for _ in range(200):
                line = f.readline()
                if not line:
                    break
                m = re.search(r"checkpoint(\d+)([a-z]*)", line)
                if m:
                    return (int(m.group(1)), m.group(2))
    except OSError:
        return None
    return None


def load_experiment(input_dir: str, nx: int = 0, ny: int = 0, nr: int = 0,
                    olx: int = 0, oly: int = 0, grid_dir: str = "") -> Config:
    """Build a Config from a reference-format experiment input directory.

    Reads `data` (PARM01-05) and `data.pkg` (PACKAGES); the domain size is
    inferred from delX/delY/delR lengths when not given (the reference bakes
    it into SIZE.h at compile time instead). The halo width comes from the
    experiment's code/SIZE.h OLx/OLy when present (the cubed-sphere
    multi-dim advection passes are overlap-width-sensitive), else 2.
    """
    cfg = Config()
    cfg.run_dir = input_dir
    cfg.grid_dir = grid_dir or input_dir
    data = nml.read_namelist(os.path.join(input_dir, "data"))
    for grp in ("PARM01", "PARM02", "PARM03", "PARM04", "PARM05"):
        for k, v in data.get(grp, {}).items():
            _set_attr(cfg, k, v)
    pkg_path = os.path.join(input_dir, "data.pkg")
    if os.path.exists(pkg_path):
        pk = nml.read_namelist(pkg_path)
        for k, v in pk.get("PACKAGES", {}).items():
            _set_attr(cfg, k, v)
    gm_path = cfg.find_file("data.gmredi")
    if cfg.useGMRedi and os.path.exists(gm_path):
        from mitgcm_tpu.model import gmredi as gmredi_mod
        gmnl = nml.read_namelist(gm_path)
        cfg.gmredi = gmredi_mod.from_namelist(gmnl.get("GM_PARM01", {}))
        # GM_NON_UNITY_DIAGONAL (see GMParams.nonUnityDiagonal): defined
        # unless the deck ships a custom code/GMREDI_OPTIONS.h that
        # #undef's it (lab_sea, cfc_example, ...).
        opt = os.path.join(os.path.dirname(os.path.abspath(input_dir)),
                           "code", "GMREDI_OPTIONS.h")
        if os.path.exists(opt):
            with open(opt, errors="replace") as f:
                txt = f.read()
            if "#undef GM_NON_UNITY_DIAGONAL" in txt:
                cfg.gmredi = dataclasses.replace(
                    cfg.gmredi, nonUnityDiagonal=False)
    x2_path = os.path.join(input_dir, "data.exch2")
    if os.path.exists(x2_path):
        x2nl = nml.read_namelist(x2_path)
        x2 = {k.lower(): v for k, v in x2nl.get("W2_EXCH2_PARM01", {}).items()}
        if "w2_mapio" in x2:
            cfg.W2_mapIO = int(x2["w2_mapio"])
    pt_path = os.path.join(input_dir, "data.ptracers")
    if cfg.usePTRACERS and os.path.exists(pt_path):
        ptnl = nml.read_namelist(pt_path)
        cfg.ptracers = ptnl.get("PTRACERS_PARM01", {})
    if cfg.useOffLine:
        # pkg/offline turns off all prognostic stepping of the ocean
        # state (offline_reset_parms.F:23-25); exactConserv is forced
        # off when wVel is read from files (:40-48)
        cfg.momStepping = False
        cfg.tempStepping = False
        cfg.saltStepping = False
        off_path = cfg.find_file("data.off")
        if os.path.exists(off_path):
            from mitgcm_tpu.model import offline as offline_mod
            offnl = nml.read_namelist(off_path)
            cfg.offline = offline_mod.params_from_namelists(
                cfg, offnl.get("OFFLINE_PARM01", {}),
                offnl.get("OFFLINE_PARM02", {}))
            if "wvel" in cfg.offline.files:
                cfg.exactConserv = False
            elif not cfg.exactConserv:
                cfg.exactConserv = True
    if cfg.useGCHEM:
        gc_path = cfg.find_file("data.gchem")
        if os.path.exists(gc_path):
            gcnl = nml.read_namelist(gc_path)
            cfg.gchem = {k.lower(): v for k, v in
                         gcnl.get("GCHEM_PARM01", {}).items()}
    # grid-spacing vectors from file (ini_parms.F delXFile/delYFile)
    prec = ">f8" if cfg.readBinaryPrec == 64 else ">f4"
    if cfg.delXfile and not cfg.delX:
        import numpy as _np
        cfg.delX = tuple(_np.fromfile(
            cfg.find_file(cfg.delXfile), prec).astype(float))
    if cfg.delYfile and not cfg.delY:
        import numpy as _np
        cfg.delY = tuple(_np.fromfile(
            cfg.find_file(cfg.delYfile), prec).astype(float))
    cfg.nx = nx or len(cfg.delX)
    cfg.ny = ny or len(cfg.delY)
    if not (cfg.nx and cfg.ny):
        # uniform-spacing decks (dXspacing + no delX vector) bake the
        # domain size into code/SIZE.h only: nx = sNx*nSx*nPx
        _sz = {}
        for _cd in _code_dirs(input_dir):
            _sz = read_size_h(_cd)
            if _sz:
                break
        if "sNx" in _sz:
            cfg.nx = cfg.nx or (_sz["sNx"] * _sz.get("nSx", 1)
                                * _sz.get("nPx", 1))
            cfg.ny = cfg.ny or (_sz["sNy"] * _sz.get("nSy", 1)
                                * _sz.get("nPy", 1))
    if not cfg.delX and cfg.dxSpacing is not UNSET:
        if not cfg.nx:
            raise ValueError("dxSpacing given without delX: pass nx=")
        cfg.delX = tuple([float(cfg.dxSpacing)] * cfg.nx)
    if not cfg.delY and cfg.dySpacing is not UNSET:
        if not cfg.ny:
            raise ValueError("dySpacing given without delY: pass ny=")
        cfg.delY = tuple([float(cfg.dySpacing)] * cfg.ny)
    cfg.nr = nr or max(len(cfg.delR), 1)
    sz = {}
    for _cd in _code_dirs(input_dir):
        sz = read_size_h(_cd)
        if sz:
            break
    if not (olx and oly):
        olx = olx or sz.get("OLx", 2)
        oly = oly or sz.get("OLy", 2)
    cfg.sNx = sz.get("sNx", cfg.nx)
    cfg.sNy = sz.get("sNy", cfg.ny)
    cfg.nSx = sz.get("nSx", 1)
    cfg.nSy = sz.get("nSy", 1)
    # SHORTWAVE_HEATING compile flag (model/inc/CPP_OPTIONS.h:22, default
    # undef): penetrating-SW interior heating; decks opt in via a custom
    # code/CPP_OPTIONS.h (lab_sea, global_with_exf, ...)
    for _cd in _code_dirs(input_dir):
        cpp_path = os.path.join(_cd, "CPP_OPTIONS.h")
        if os.path.exists(cpp_path):
            with open(cpp_path, errors="replace") as f:
                txt = f.read()
            if "#define SHORTWAVE_HEATING" in txt:
                cfg.shortwaveHeating = True
            if "#define ALLOW_3D_DIFFKR" in txt:
                # ini_mixing.F:45: the 3-D diffusivity is initialised
                # from the diffKrNrS profile and used for ALL tracers
                cfg.allow3dDiffKr = True
            break
    for _cd in _code_dirs(input_dir):
        pfs = os.path.join(_cd, "ptracers_forcing_surf.F")
        if os.path.exists(pfs):
            body = open(pfs, errors="replace").read()
            # active (non-comment) surfaceForcingS line in the override
            for ln in body.splitlines():
                if (ln[:1] not in ("C", "c", "!") and
                        "surfaceForcingS" in ln and "&" in ln):
                    cfg.ptracersForcingLikeSalt = True
                    break
            break
    cfg.olx = olx
    cfg.oly = oly
    if not (cfg.usingCartesianGrid or cfg.usingSphericalPolarGrid
            or cfg.usingCylindricalGrid or cfg.usingCurvilinearGrid):
        cfg.usingSphericalPolarGrid = True  # reference default when unset
    cfg.finalize()
    p3 = os.path.join(input_dir, "POLY3.COEFFS")
    if cfg.eosType.upper() == "POLY3" and os.path.exists(p3):
        import numpy as _np
        toks = open(p3).read().split()
        nlev = int(toks[0])
        vals = _np.asarray([float(t) for t in toks[1:]])
        hdr = vals[:3 * nlev].reshape(nlev, 3)
        coef = vals[3 * nlev:3 * nlev + 9 * nlev].reshape(nlev, 9)
        cfg.poly3 = (hdr[:, 0].copy(), hdr[:, 1].copy(),
                     hdr[:, 2].copy(), coef.copy())

    obcs_path = os.path.join(input_dir, "data.obcs")
    if cfg.useOBCS and os.path.exists(obcs_path):
        from mitgcm_tpu.model import obcs as obcs_mod
        cfg.obcs = obcs_mod.parse_data_obcs(obcs_path, cfg)

    shap_path = os.path.join(input_dir, "data.shap")
    if cfg.useSHAP_FILT and os.path.exists(shap_path):
        from mitgcm_tpu.model import shap_filt as shap_mod
        shnl = nml.read_namelist(shap_path)
        cfg.shap = shap_mod.from_namelist(shnl.get("SHAP_PARM01", {}), cfg)

    zf_path = os.path.join(input_dir, "data.zonfilt")
    if cfg.useZONAL_FILT:
        from mitgcm_tpu.model import zonal_filt as zf_mod
        zp = zf_mod.ZonFiltParams()
        if os.path.exists(zf_path):
            znl = nml.read_namelist(zf_path).get("ZONFILT_PARM01", {})
            for key, val in znl.items():
                for f in zp.__dataclass_fields__:
                    if f.lower() == key.lower():
                        setattr(zp, f, val)
        cfg.zonfilt = zp

    aim_path = os.path.join(input_dir, "data.aimphys")
    if cfg.useAIM:
        from mitgcm_tpu.model import aim as aim_mod
        anl = {}
        if os.path.exists(aim_path):
            anl = nml.read_namelist(aim_path).get("AIM_PARAMS", {})
        cfg.aim = aim_mod.from_namelist(anl)
    return cfg
