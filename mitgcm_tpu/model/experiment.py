"""Experiment driver: load a reference-format experiment directory and run.

The analog of the reference's PROGRAM MAIN + THE_MODEL_MAIN
(eesupp/src/main.F:61, model/src/the_model_main.F:528): read namelists,
build grid, initialize state, then run the time loop with monitor output.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core import config as config_mod
from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid, build_grid
from mitgcm_tpu.core.state import Forcing, State, init_state, zero_forcing
from mitgcm_tpu.diag import monitor
from mitgcm_tpu.io import mds
from mitgcm_tpu.model import step as step_mod
from mitgcm_tpu.ops.stencil import cyclic_fill_halo
from mitgcm_tpu.solver import cg2d as cg2d_mod


# package objects forward_step takes (Experiment attributes of these names)
_PACKAGES = ("kpp", "ggl90", "vmix", "opps", "seaice", "obcs", "op3",
             "rbcs", "aim", "zonfilt", "thsice", "offline", "cfc", "dic")


def cs_global_to_faces(arr, n, mapIO=-1):
    """Global cubed-sphere record -> [..., 6, n, n].

    mapIO = W2_mapIO (pkg/exch2/w2_readparms.F:64): -1/0 = global 2-D map,
    faces side by side along x ([n, 6n], exch2_txGlobalo x-offsets);
    1 = compact layout, faces stacked along y ([6n, n]). Verified per
    layout: advect_cs T.init (mapIO=-1) and solid-body S_init.bin
    (mapIO=1) each reproduce the reference's volume-weighted tracer
    statistics to >=13 digits only in their declared layout."""
    lead = arr.shape[:-2]
    if mapIO == 1:
        return arr.reshape(lead + (6, n, n))
    return arr.reshape(lead + (n, 6, n)).swapaxes(-3, -2)


def _pad_and_fill(cfg: Config, arr, dtype, cs_fill=None):
    """Pad an interior array into the halo layout and fill halos.
    Cartesian: arr is [..., ny, nx]. Cubed sphere: arr is the global-file
    record [..., n, 6n] (x-concatenated faces)."""
    oly, olx = cfg.oly, cfg.olx
    if cfg.nFaces > 1:
        n = cfg.ny
        nyp = n + 2 * oly
        lead = arr.shape[:-2]
        faces = cs_global_to_faces(arr, n, cfg.W2_mapIO)
        padded = np.zeros(lead + (cfg.nFaces, nyp, n + 2 * olx))
        padded[..., oly:oly + n, olx:olx + n] = faces
        filled = cs_fill.ex.fill_C(jnp.asarray(padded, dtype))
        return filled.reshape(lead + (cfg.nFaces * nyp, n + 2 * olx))
    padded = np.zeros(arr.shape[:-2]
                      + (cfg.ny + 2 * oly, cfg.nx + 2 * olx))
    padded[..., oly:oly + cfg.ny, olx:olx + cfg.nx] = arr
    return cyclic_fill_halo(jnp.asarray(padded, dtype), oly, olx)


def _global_dims(cfg: Config):
    """(rows, cols) of one global-file record (see cs_global_to_faces)."""
    if cfg.nFaces > 1:
        if cfg.W2_mapIO == 1:
            return cfg.nFaces * cfg.ny, cfg.ny
        return cfg.ny, cfg.nFaces * cfg.ny
    return cfg.ny, cfg.nx


def _load_2d(cfg: Config, fname: str, dtype, cs_fill=None, scale=1.0
             ) -> Optional[jnp.ndarray]:
    """Load all records of a 2-D forcing file -> [nrec, nyp, nxp]
    (the reference reads records on demand, external_fields_load.F;
    we keep the whole annual cycle resident and interpolate in-jit)."""
    path = cfg.find_file(fname) if fname else ""
    if not fname or not os.path.exists(path):
        return None
    prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"
    itemsize = 4 if cfg.readBinaryPrec == 32 else 8
    gy, gx = _global_dims(cfg)
    nrec = os.path.getsize(path) // (itemsize * gy * gx)
    arr = mds.read_raw(path, (nrec, gy, gx), prec).astype(np.float64)
    arr = arr * scale
    return _pad_and_fill(cfg, arr, dtype, cs_fill)


def _load_3d(cfg: Config, fname: str, dtype, cs_fill=None
             ) -> Optional[jnp.ndarray]:
    path = cfg.find_file(fname) if fname else ""
    if not fname or not os.path.exists(path):
        return None
    prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"
    gy, gx = _global_dims(cfg)
    arr = mds.read_raw(path, (cfg.nr, gy, gx), prec).astype(np.float64)
    return _pad_and_fill(cfg, arr, dtype, cs_fill)


def _exf_to_forcing(cfg, grid, exfobj, fields, forcing, dtype, cs_fill):
    """exf_mapfields.F: exf fields -> model forcing arrays, per record.

    All mappings are linear, so they commute with the per-step time
    interpolation (the windstressmax clamp is asserted inactive)."""
    oly, olx = cfg.oly, cfg.olx
    ny, nx = cfg.ny * cfg.nFaces, cfg.nx
    ks = cfg.ksurf0   # surface level (Nr under p-coords)
    maskC0 = np.asarray(grid.maskC[ks])
    maskW0 = np.asarray(grid.maskW[ks])
    maskS0 = np.asarray(grid.maskS[ks])

    def refill(padded):
        if cfg.nFaces > 1:
            # stacked-face layout: strip each face block's interior and
            # rebuild the global-map record (inverse of
            # cs_global_to_faces) before re-padding
            n = cfg.ny
            nypf = n + 2 * oly
            f6 = padded.reshape(padded.shape[:-2]
                                + (cfg.nFaces, nypf, nx + 2 * olx))
            inter = f6[..., oly:oly + n, olx:olx + n]
            if cfg.W2_mapIO == 1:
                glob = inter.reshape(inter.shape[:-3]
                                     + (cfg.nFaces * n, n))
            else:
                glob = np.swapaxes(inter, -3, -2).reshape(
                    inter.shape[:-3] + (n, cfg.nFaces * n))
            return np.stack([np.asarray(
                _pad_and_fill(cfg, r, dtype, cs_fill)) for r in glob])
        inter = padded[..., oly:oly + ny, olx:olx + nx]
        return np.stack([np.asarray(
            _pad_and_fill(cfg, r, dtype, cs_fill)) for r in inter])

    upd = {}
    tknots = dict(forcing.tknots)

    def masked_records(name, mask):
        stack, knots = fields[name]
        # exf_filter_rl.F: zero on land before anything else
        stack = stack * mask[None]
        return stack, knots

    if "hflux" in fields:
        stack, knots = masked_records("hflux", maskC0)
        upd["Qnet"] = jnp.asarray(refill(stack))
        if knots is not None:
            tknots["Qnet"] = jnp.asarray(knots)
    if "swflux" in fields:
        stack, knots = masked_records("swflux", maskC0)
        upd["Qsw"] = jnp.asarray(refill(stack))
        if knots is not None:
            tknots["Qsw"] = jnp.asarray(knots)
    if "sflux" in fields:
        stack, knots = masked_records("sflux", maskC0)
        upd["EmPmR"] = jnp.asarray(refill(stack * cfg.rhoConstFresh))
        if knots is not None:
            tknots["EmPmR"] = jnp.asarray(knots)
    if "ustress" in fields:
        # stressIsOnCgrid: the file is already at U points (masked with
        # maskW at load, exf_init_fixed.F:63-65); else A-grid averaged
        mU = maskW0 if exfobj.stressIsOnCgrid else maskC0
        stack, knots = masked_records("ustress", mU)
        assert np.abs(stack).max() < exfobj.windstressmax, \
            "windstressmax clamp would be active (not linear in time)"
        if exfobj.stressIsOnCgrid:
            fu = stack
        else:
            if cfg.nFaces > 1:
                raise NotImplementedError("A-grid exf stress on the cube")
            # C-grid average to W points (exf_mapfields.F:241-248)
            fu = 0.5 * (stack + np.concatenate(
                [stack[..., -1:], stack[..., :-1]], axis=-1)) * maskW0[None]
        upd["fu"] = jnp.asarray(refill(fu))
        if knots is not None:
            tknots["fu"] = jnp.asarray(knots)
    if "vstress" in fields:
        mV = maskS0 if exfobj.stressIsOnCgrid else maskC0
        stack, knots = masked_records("vstress", mV)
        assert np.abs(stack).max() < exfobj.windstressmax
        if exfobj.stressIsOnCgrid:
            fv = stack
        else:
            fv = 0.5 * (stack + np.concatenate(
                [stack[..., -1:, :], stack[..., :-1, :]], axis=-2)) \
                * maskS0[None]
        upd["fv"] = jnp.asarray(refill(fv))
        if knots is not None:
            tknots["fv"] = jnp.asarray(knots)
    if "climsst" in fields:
        stack, knots = masked_records("climsst", maskC0)
        upd["SST"] = jnp.asarray(refill(stack))
        if knots is not None:
            tknots["SST"] = jnp.asarray(knots)
        cfg.exf_climtempfreeze = exfobj.climtempfreeze
    if "climsss" in fields:
        stack, knots = masked_records("climsss", maskC0)
        upd["SSS"] = jnp.asarray(refill(stack))
        if knots is not None:
            tknots["SSS"] = jnp.asarray(knots)
    if "apressure" in fields:
        # exf_mapfields.F:314-321: pLoad = apressure - surf_pRef
        # (pressure ANOMALY, ATMOSPHERIC_LOADING)
        stack, knots = masked_records("apressure", maskC0)
        upd["pLoad"] = jnp.asarray(refill(
            (stack - cfg.surf_pRef) * maskC0[None]))
        if knots is not None:
            tknots["pLoad"] = jnp.asarray(knots)
    # bulk-formulae mode (ALLOW_ATM_TEMP/ALLOW_ATM_WIND): carry the raw
    # atmospheric state; fluxes are computed per step in forward_step
    if "snowprecip" in fields:
        raise NotImplementedError("exf snowPrecipFile")
    for name, fkey in (("atemp", "atemp"), ("aqh", "aqh"),
                       ("uwind", "uwind"), ("vwind", "vwind"),
                       ("precip", "precip"), ("swdown", "swdown"),
                       ("lwdown", "lwdown"), ("runoff", "runoff"),
                       ("evap", "evap"), ("wspeed", "wspeed"),
                       ("runoftemp", "runoftemp")):
        if name in fields:
            stack, knots = masked_records(name, maskC0)
            upd[fkey] = jnp.asarray(refill(stack))
            if knots is not None:
                if knots is not None:
                    tknots[fkey] = jnp.asarray(knots)
    if "atemp" in fields:
        cfg.exf_useBulk = True
    return Forcing(**{**forcing.__dict__, **upd, "tknots": tknots})


@dataclass
class Experiment:
    cfg: Config
    grid: Grid
    state: State
    forcing: Forcing
    op: cg2d_mod.CG2DOperator
    monitor_lines: List[str] = field(default_factory=list)
    diags: List[Dict[str, float]] = field(default_factory=list)
    cs_fill: object = None   # CSFill hooks for cubed-sphere runs
    kpp: object = None       # KPP instance when useKPP
    ggl90: object = None     # GGL90 instance when useGGL90
    vmix: object = None      # PP81/MY82 instance
    opps: object = None      # OPPS convection instance
    seaice: object = None    # SeaIce instance when useSEAICE
    obcs: object = None      # obcs.OBCS hook when useOBCS
    op3: object = None       # cg3d.CG3DOperator when nonHydrostatic
    rbcs: object = None      # rbcs.RBCS hook when useRBCS
    aim: object = None       # aim.AIM physics when useAIM
    zonfilt: object = None   # zonal_filt.ZonalFilt when useZONAL_FILT

    @classmethod
    def from_dir(cls, input_dir: str, dtype=jnp.float64,
                 strict_config: bool = True, **size_kw):
        if dtype == jnp.float64 and not jax.config.jax_enable_x64:
            # digit-level verification needs real f64
            jax.config.update("jax_enable_x64", True)
        cfg = config_mod.load_experiment(input_dir, **size_kw)
        # fail-loudly on deck parameters we would otherwise silently drop
        config_mod.config_check(cfg, strict=strict_config)
        cs_fill = None
        if cfg.usingCurvilinearGrid:
            from mitgcm_tpu.core.grid import build_cs_grid
            grid, cs_fill = build_cs_grid(cfg, dtype=dtype)
        else:
            grid = build_grid(cfg, dtype=dtype)
        if cfg.geoPotAnomFile:
            # topographic geopotential anomaly phi0surf
            # (ini_linear_phisurf.F:200-213)
            import dataclasses as _dc
            prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"
            gy, gx = _global_dims(cfg)
            p0 = mds.read_raw(cfg.find_file(cfg.geoPotAnomFile),
                              (gy, gx), prec).astype(np.float64)
            grid = _dc.replace(
                grid, phi0surf=_pad_and_fill(cfg, p0, dtype, cs_fill))
        if cfg.useOBCS and cfg.obcs is not None:
            # obcs_init_fixed.F: fold the OB interior mask into maskInC/W/S
            # BEFORE the cg2d operator and any flux masks are built
            from mitgcm_tpu.model import obcs as obcs_mod
            import dataclasses as _dc
            _, mC, mW, mS = obcs_mod.build_masks(
                cfg, cfg.obcs, np.asarray(grid.kSurfC),
                np.asarray(grid.maskInC), np.asarray(grid.maskInW),
                np.asarray(grid.maskInS))
            grid = _dc.replace(
                grid, maskInC=jnp.asarray(mC, dtype),
                maskInW=jnp.asarray(mW, dtype),
                maskInS=jnp.asarray(mS, dtype))
        state = init_state(cfg, grid, dtype=dtype)

        # initial condition files (model/src/ini_fields.F path)
        t0 = _load_3d(cfg, cfg.hydrogThetaFile, dtype, cs_fill)
        if t0 is not None:
            if cfg.checkIniTemp and cfg.allowFreezing:
                # ini_theta.F:130-144: clamp init temperature at freezing
                t0 = jnp.maximum(t0, -1.9)
            state = State(**{**state.__dict__, "theta": t0 * grid.maskC})
        s0 = _load_3d(cfg, cfg.hydrogSaltFile, dtype, cs_fill)
        if s0 is not None:
            state = State(**{**state.__dict__, "salt": s0 * grid.maskC})
        # initial velocities + free surface (ini_vel.F / ini_psurf.F)
        u0 = _load_3d(cfg, cfg.uVelInitFile, dtype, cs_fill)
        if u0 is not None:
            state = State(**{**state.__dict__, "uVel": u0 * grid.maskW})
        v0 = _load_3d(cfg, cfg.vVelInitFile, dtype, cs_fill)
        if v0 is not None:
            state = State(**{**state.__dict__, "vVel": v0 * grid.maskS})
        eta0 = _load_2d(cfg, cfg.pSurfInitFile, dtype, cs_fill)
        if eta0 is not None:
            eta0 = (eta0[0] if eta0.ndim == 3 else eta0) * grid.maskInC
            state = State(**{**state.__dict__, "etaN": eta0, "etaH": eta0})

        forcing = zero_forcing(cfg, dtype)
        # simple-path forcing files (model/src/external_fields_load.F with
        # periodicExternalForcing=F: loaded once, constant in time)
        fu = _load_2d(cfg, cfg.zonalWindFile, dtype, cs_fill)
        if fu is not None:
            forcing = Forcing(**{**forcing.__dict__, "fu": fu})
        fv = _load_2d(cfg, cfg.meridWindFile, dtype, cs_fill)
        if fv is not None:
            forcing = Forcing(**{**forcing.__dict__, "fv": fv})
        qnet = _load_2d(cfg, cfg.surfQnetFile or cfg.surfQFile, dtype, cs_fill)
        if qnet is not None:
            forcing = Forcing(**{**forcing.__dict__, "Qnet": qnet})
        # EmPmR file in m/s -> kg/m2/s (external_fields_load.F:82)
        empmr = _load_2d(cfg, cfg.EmPmRFile, dtype, cs_fill, scale=cfg.rhoConstFresh)
        if empmr is not None:
            forcing = Forcing(**{**forcing.__dict__, "EmPmR": empmr})
        sst = _load_2d(cfg, cfg.thetaClimFile, dtype, cs_fill)
        if sst is not None:
            forcing = Forcing(**{**forcing.__dict__, "SST": sst})
        sss = _load_2d(cfg, cfg.saltClimFile, dtype, cs_fill)
        if sss is not None:
            forcing = Forcing(**{**forcing.__dict__, "SSS": sss})
        pload = _load_2d(cfg, cfg.pLoadFile, dtype, cs_fill)
        if pload is not None:
            if not cfg.usingZCoords:
                raise NotImplementedError(
                    "pLoadFile under p-coords (the phi0surf-from-file "
                    "hack, ini_forcing.F) is not supported")
            forcing = Forcing(**{**forcing.__dict__, "pLoad": pload})

        # pkg/exf forcing pipeline (records pre-interpolated at setup,
        # calendar-aware time knots; see model/exf.py)
        if cfg.useEXF:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.utils.cal import Cal
            from mitgcm_tpu.model import exf as exf_mod
            calnl = {}
            cpath = cfg.find_file("data.cal")
            if cfg.useCAL and os.path.exists(cpath):
                calnl = nml.read_namelist(cpath).get("CAL_NML", {})
            calobj = Cal.from_namelist(calnl)
            exfobj = exf_mod.EXF(cfg, grid, input_dir, calobj)
            t_end = cfg.startTime + cfg.nTimeSteps * cfg.deltaTClock
            fields = exfobj.build(
                t_end, lambda a: np.asarray(
                    _pad_and_fill(cfg, a, dtype, cs_fill)))
            forcing = _exf_to_forcing(cfg, grid, exfobj, fields, forcing,
                                      dtype, cs_fill)

        # initial hydrostatic pressure for pressure-dependent EOS
        # (model/src/ini_pressure.F: 15 Jacobi sweeps of CALC_PHI_HYD
        # with myIter=-1; each sweep recomputes rho from the previous
        # sweep's totPhiHyd)
        if (cfg.selectP_inEOS_Zc >= 2 and not cfg.usingPCoords
                and cfg.nIter0 == 0):
            from mitgcm_tpu.model.phihyd import calc_phi_hyd
            from mitgcm_tpu.ops import eos as eos_mod

            @jax.jit
            def _ini_pressure(theta, salt):
                tot = jnp.zeros_like(theta)
                for _ in range(15):
                    rho = eos_mod.find_rho(cfg, grid, theta, salt,
                                           totPhiHyd=tot) * grid.maskC
                    tot = calc_phi_hyd(cfg, grid, rho)[0]
                return tot
            state = State(**{**state.__dict__, "totPhiHyd": _ini_pressure(
                state.theta, state.salt)})

        op = cg2d_mod.build_cg2d(cfg, grid)
        op3 = None
        if cfg.nonHydrostatic:
            from mitgcm_tpu.solver import cg3d as cg3d_mod
            op3 = cg3d_mod.build_cg3d(cfg, grid)

        # experiment code/ overrides of GAD compile options
        from mitgcm_tpu.model.kpp import scan_cpp_options as _scan_opts
        gad_opts = _scan_opts(os.path.join(
            os.path.dirname(os.path.abspath(input_dir)), "code",
            "GAD_OPTIONS.h"))
        if "GAD_MULTIDIM_COMPRESSIBLE" in gad_opts:
            cfg.gadMultiDimCompressible = True

        kpp_obj = None
        if cfg.useKPP:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import kpp as kpp_mod
            knl = {}
            kpath = cfg.find_file("data.kpp")
            if os.path.exists(kpath):
                knl = nml.read_namelist(kpath).get("KPP_PARM01", {})
            opt_path = os.path.join(
                os.path.dirname(os.path.abspath(input_dir)), "code",
                "KPP_OPTIONS.h")
            if os.path.exists(opt_path):
                opts = kpp_mod.scan_cpp_options(opt_path)
            else:
                # pkg/kpp/KPP_OPTIONS.h defaults
                opts = {"KPP_SMOOTH_SHSQ", "KPP_SMOOTH_DBLOC", "KPP_GHAT"}
            for bad in ("KPP_SMOOTH_DVSQ", "KPP_SMOOTH_DENS",
                        "KPP_SMOOTH_VISC", "KPP_SMOOTH_DIFF",
                        "ALLOW_KPP_VERTICALLY_SMOOTH"):
                if bad in opts:
                    raise NotImplementedError(f"KPP option {bad}")
            kpp_obj = kpp_mod.KPP(cfg, grid, knl, options=opts)

        ggl90_obj = None
        if cfg.useGGL90:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import ggl90 as ggl90_mod
            g1, g3 = {}, {}
            gpath = cfg.find_file("data.ggl90")
            g2 = {}
            if os.path.exists(gpath):
                gnl = nml.read_namelist(gpath)
                g1 = gnl.get("GGL90_PARM01", {})
                g2 = gnl.get("GGL90_PARM02", {})
                g3 = gnl.get("GGL90_PARM03", {})
            ggl90_obj = ggl90_mod.GGL90(cfg, grid, g1, g3, group2=g2)
            if ggl90_obj.p["useIDEMIX"]:
                def _ld2(fname):
                    a = _load_2d(cfg, fname, dtype, cs_fill)
                    if a is None:
                        raise FileNotFoundError(f"IDEMIX file {fname}")
                    return a[0]
                ggl90_obj.init_idemix_forc(_ld2)
            tke0 = _load_3d(cfg, ggl90_obj.p["GGL90TKEFile"], dtype,
                            cs_fill)
            if tke0 is None:
                tke0 = ggl90_obj.init_tke(dtype)
            else:
                tke0 = tke0 * grid.maskC
            state = State(**{**state.__dict__, "GGL90TKE": tke0})

        vmix_obj = None
        if cfg.usePP81 or cfg.useMY82:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import vertmix
            if cfg.usePP81:
                grp, fname, gname = {}, "data.pp81", "PP81_PARM01"
                klass = vertmix.PP81
            else:
                grp, fname, gname = {}, "data.my82", "MY_PARM01"
                klass = vertmix.MY82
            vpath = cfg.find_file(fname)
            if os.path.exists(vpath):
                grp = nml.read_namelist(vpath).get(gname, {})
            vmix_obj = klass(cfg, grid, grp)

        opps_obj = None
        if cfg.useOPPS:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import opps as opps_mod
            grp = {}
            opath = cfg.find_file("data.opps")
            if os.path.exists(opath):
                grp = nml.read_namelist(opath).get("OPPS_PARM01", {})
            opps_obj = opps_mod.OPPS(cfg, grid, grp)

        offline_obj = None
        if cfg.useOffLine and cfg.offline is not None:
            from mitgcm_tpu.model import offline as offline_mod
            offline_obj = offline_mod.Offline(
                cfg, cfg.offline, cfg.run_dir,
                fill3d=lambda a: _pad_and_fill(cfg, a, dtype, cs_fill),
                dtype=dtype)

        dic_obj = None
        cfc_obj = None
        if cfg.useGCHEM and cfg.gchem and cfg.gchem.get("usecfc"):
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import cfc as cfc_mod
            cfcnl = {}
            cfc_path = cfg.find_file("data.cfc")
            if os.path.exists(cfc_path):
                cfcnl = nml.read_namelist(cfc_path).get("CFC_FORCING", {})
            cfc_obj = cfc_mod.Cfc(
                cfg, grid, cfc_mod.params_from_namelists(cfg, cfcnl),
                cfg.run_dir,
                fill2d=lambda a: _pad_and_fill(cfg, a, dtype, cs_fill),
                dtype=dtype)

        thsice_obj = None
        if cfg.useThSIce:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import thsice as thsice_mod
            tc, t1 = {}, {}
            tpath = cfg.find_file("data.ice")
            if os.path.exists(tpath):
                tnl = nml.read_namelist(tpath)
                tc = tnl.get("THSICE_CONST", {})
                t1 = tnl.get("THSICE_PARM01", {})
            thp = thsice_mod.params_from_namelists(cfg, tc, t1)
            thsice_obj = thsice_mod.ThSIce(cfg, grid, thp, fills=cs_fill)
            th0 = thsice_obj.init_state(
                lambda f: _load_2d(cfg, f, dtype, cs_fill), dtype)
            state = State(**{**state.__dict__, **th0})

        seaice_obj = None
        if cfg.useSEAICE:
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import seaice as seaice_mod
            s1, s3 = {}, {}
            spath = cfg.find_file("data.seaice")
            if os.path.exists(spath):
                snl = nml.read_namelist(spath)
                s1 = snl.get("SEAICE_PARM01", {})
                s3 = snl.get("SEAICE_PARM03", {})
            sip = seaice_mod.params_from_namelists(cfg, s1, s3)
            cfg.seaice = sip
            seaice_obj = seaice_mod.SeaIce(cfg, grid, sip,
                                           fills=cs_fill)
            ice0 = seaice_obj.init_state(dtype)
            if sip.uIceFile or sip.vIceFile or sip.HeffFile \
                    or sip.AreaFile or sip.HsnowFile:
                # seaice_init_varia.F:285-367 fresh-start file reads
                fuv = seaice_obj.fill_uv
                fl = seaice_obj.fill
                uI, vI = ice0.uIce, ice0.vIce
                if sip.uIceFile:
                    uI = _load_2d(cfg, sip.uIceFile, dtype, cs_fill)[0]
                if sip.vIceFile:
                    vI = _load_2d(cfg, sip.vIceFile, dtype, cs_fill)[0]
                if sip.uIceFile or sip.vIceFile:
                    uI = uI * seaice_obj.seaiceMaskU
                    vI = vI * seaice_obj.seaiceMaskV
                    uI, vI = fuv(uI, vI)
                heff, area = ice0.HEFF, ice0.AREA
                if sip.HeffFile:
                    heff = jnp.maximum(
                        fl(_load_2d(cfg, sip.HeffFile, dtype,
                                    cs_fill)[0]), 0.0)
                area = jnp.where(heff > 0.0, 1.0, area)
                if sip.AreaFile:
                    area = jnp.clip(
                        fl(_load_2d(cfg, sip.AreaFile, dtype,
                                    cs_fill)[0]), 0.0, 1.0)
                    heff = jnp.where(area <= 0.0, 0.0, heff)
                    area = jnp.where(heff <= 0.0, 0.0, area)
                hsnow = 0.2 * area
                if sip.HsnowFile:
                    hsnow = jnp.maximum(
                        fl(_load_2d(cfg, sip.HsnowFile, dtype,
                                    cs_fill)[0]), 0.0)
                ice0 = ice0._replace(uIce=uI, vIce=vI, HEFF=heff,
                                     AREA=area, HSNOW=hsnow)
            state = State(**{**state.__dict__,
                             "uIce": ice0.uIce, "vIce": ice0.vIce,
                             "siAREA": ice0.AREA, "siHEFF": ice0.HEFF,
                             "siHSNOW": ice0.HSNOW, "siHSALT": ice0.HSALT,
                             "siTICES": ice0.TICES,
                             "SItracer": ice0.SItracer,
                             "siSigma": ice0.sigma})

        obcs_obj = None
        if cfg.useOBCS and cfg.obcs is not None:
            from mitgcm_tpu.model import obcs as obcs_mod
            obcs_obj = obcs_mod.OBCS(cfg, grid, dtype)

        rbcs_obj = None
        if cfg.useRBCS:
            from mitgcm_tpu.model import rbcs as rbcs_mod
            rbcs_obj = rbcs_mod.RBCS(
                cfg, grid, dtype,
                lambda f: _load_3d(cfg, f, dtype, cs_fill))

        aim_obj = None
        if cfg.useAIM:
            from mitgcm_tpu.model import aim as aim_mod
            fill2d = lambda a: _pad_and_fill(        # noqa: E731
                cfg, a, dtype, cs_fill)
            aim_obj = aim_mod.AIM(cfg, grid, cfg.aim, dtype,
                                  fill2d=fill2d)
            if cfg.useLand:
                from mitgcm_tpu.core import nml
                from mitgcm_tpu.model import land as land_mod
                lnl = {}
                lpath = cfg.find_file("data.land")
                if os.path.exists(lpath):
                    lnl = nml.read_namelist(lpath)
                lp = land_mod.params_from_namelists(cfg, lnl)
                grnd_alb = aim_obj.fm.get(
                    "alb", jnp.zeros_like(aim_obj.landFr)) \
                    if getattr(aim_obj, "fm", None) is not None \
                    else jnp.zeros_like(aim_obj.landFr)
                land_obj = land_mod.Land(cfg, lp, aim_obj.landFr,
                                         grnd_alb, dtype)
                aim_obj.land = land_obj
                gy, gx = _global_dims(cfg)
                prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"

                def read_rec(fname, nrec):
                    return mds.read_raw(cfg.find_file(fname),
                                        (nrec, gy, gx), prec
                                        ).astype(np.float64)

                lst0 = land_mod.init_state(land_obj, fill2d, read_rec)
                state = State(**{
                    **state.__dict__,
                    "landEnthalp": lst0.enthalp, "landW": lst0.groundW,
                    "landT": lst0.groundT, "landSkinT": lst0.skinT,
                    "landHSnow": lst0.hSnow,
                    "landSnowAge": lst0.snowAge})
        zonfilt_obj = None
        if cfg.useZONAL_FILT:
            from mitgcm_tpu.model import zonal_filt as zf_mod
            zonfilt_obj = zf_mod.ZonalFilt(cfg, grid, cfg.zonfilt)

        # passive-tracer initial conditions (ptracers_init_varia.F:
        # ref profile, overridden by PTRACERS_initialFile)
        if cfg.usePTRACERS and state.pTr.shape[0]:
            from mitgcm_tpu.model.thermodynamics import ptracer_params
            ptr0 = list(state.pTr)
            changed = False
            for itr in range(state.pTr.shape[0]):
                ppt = ptracer_params(cfg, itr)
                if ppt["ref"]:
                    prof = jnp.asarray(ppt["ref"], dtype)
                    prof = jnp.concatenate(
                        [prof, jnp.zeros(cfg.nr - prof.shape[0], dtype)]) \
                        if prof.shape[0] < cfg.nr else prof[:cfg.nr]
                    ptr0[itr] = (prof[:, None, None]
                                 * jnp.ones_like(state.theta) * grid.maskC)
                    changed = True
                if ppt["initialFile"]:
                    f0 = _load_3d(cfg, ppt["initialFile"], dtype, cs_fill)
                    if f0 is not None:
                        ptr0[itr] = f0 * grid.maskC
                        changed = True
            if changed:
                state = State(**{**state.__dict__,
                                 "pTr": jnp.stack(ptr0)})

        if cfg.useGCHEM and cfg.gchem and cfg.gchem.get("usedic"):
            # constructed after the ptracer initial conditions: the
            # 10-iteration initial pH spin needs DIC/Alk/PO4
            from mitgcm_tpu.core import nml
            from mitgcm_tpu.model import dic as dic_mod
            dicnl = {}
            dic_path = cfg.find_file("data.dic")
            if os.path.exists(dic_path):
                dicnl = nml.read_namelist(dic_path)
            # DIC_AD_SAFE from the deck's DIC_OPTIONS.h (genmake2-style
            # compile-flag check): changes the forward nutrient limit
            dopt = cfg.find_code_file("DIC_OPTIONS.h")
            ad_safe = bool(dopt) and "#define DIC_AD_SAFE" in open(
                dopt, errors="replace").read()
            dic_obj = dic_mod.Dic(
                cfg, grid, dic_mod.params_from_namelists(cfg, dicnl),
                fill2d=lambda a: _pad_and_fill(cfg, a, dtype, cs_fill),
                dtype=dtype, ad_safe=ad_safe)
            ksd = cfg.ksurf0
            # OFFLINE_INIT_VARIA runs before GCHEM_INIT_VARI
            # (packages_init_variables.F:184 vs :347): the pH spin sees
            # the offline-loaded theta/salt at startTime, not tRef
            th_ini, sa_ini = state.theta, state.salt
            if offline_obj is not None:
                off0 = offline_obj.fields_at(cfg.startTime)
                th_ini = off0.get("thet", th_ini)
                sa_ini = off0.get("salt", sa_ini)
            state = State(**{**state.__dict__, "dicPH": dic_obj.init_ph(
                state.pTr, th_ini[ksd], sa_ini[ksd])})

        if obcs_obj is not None and cfg.nIter0 == 0:
            # obcs_init_variables.F:386-449: at nIter0=0 compute the OB
            # values at startTime (OBCS_CALC + prescribed records) and
            # apply them to the initial uVel/vVel/theta/salt/ptracers
            # for consistency; ob0 is kept for the init-continuity wVel
            from mitgcm_tpu.model import obcs as obcs_mod
            ob0 = obcs_mod.calc_fields(
                cfg, grid, cfg.obcs, state, cfg.startTime, 0,
                prescribed=obcs_obj.prescribed, m=obcs_obj.masks)
            u0, v0 = obcs_mod.apply_uv(cfg, obcs_obj.masks, cfg.obcs,
                                       ob0, state.uVel, state.vVel)
            t0, s0 = obcs_mod.apply_ts(cfg, obcs_obj.masks, ob0,
                                       state.theta, state.salt)
            # the reference exchanges AFTER the OB apply (initialise_varia
            # EXCH sequence), so the halo beyond an OB holds the cyclic
            # wrap of the opposite side, not the OB-extended value — the
            # monitor del2 stencil and biharmonic dissipation read it
            fill = ((lambda a: cs_fill.fill(a)) if cs_fill is not None
                    else (lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)))
            upd = {"uVel": fill(u0), "vVel": fill(v0),
                   "theta": fill(t0), "salt": fill(s0)}
            if cfg.usePTRACERS and state.pTr.shape[0]:
                upd["pTr"] = fill(obcs_mod.apply_all_ptracers(
                    cfg, obcs_obj.masks, ob0, state.pTr))
            state = State(**{**state.__dict__, **upd})
            obcs_obj.ob0 = ob0

        preconv_state = None
        if cfg.cAdjFreq != 0.0 and cfg.nIter0 == 0:
            # initialise_varia.F:283-296 (INCLUDE_CONVECT_INI_CALL):
            # "Initial conditions are convectively adjusted (for
            # historical reasons)" when startTime==baseTime.  The
            # pre-adjustment state is kept: the ctrl map runs BEFORE
            # this call in the reference (PACKAGES_INIT_VARIABLES at
            # initialise_varia.F:265), so AD control perturbations must
            # be applied to the un-adjusted state and re-adjusted
            # (see ad/estim.CtrlProblem.objective)
            preconv_state = state
            from mitgcm_tpu.model import thermodynamics as thermo_mod
            t0, s0, p0 = thermo_mod.convective_adjustment(
                cfg, grid, state.theta, state.salt,
                state.pTr if cfg.usePTRACERS and state.pTr.shape[0]
                else None)
            fillc = ((lambda a: cs_fill.fill(a)) if cs_fill is not None
                     else (lambda a: cyclic_fill_halo(a, cfg.oly,
                                                      cfg.olx)))
            updc = {"theta": fillc(t0), "salt": fillc(s0)}
            if p0 is not None:
                updc["pTr"] = fillc(p0)
            state = State(**{**state.__dict__, **updc})

        exp = cls(cfg=cfg, grid=grid, state=state, forcing=forcing, op=op,
                  cs_fill=cs_fill, kpp=kpp_obj, ggl90=ggl90_obj,
                  vmix=vmix_obj, opps=opps_obj, seaice=seaice_obj,
                  obcs=obcs_obj, op3=op3, rbcs=rbcs_obj,
                  aim=aim_obj, zonfilt=zonfilt_obj)
        exp.preconvect_state = preconv_state
        exp.thsice = thsice_obj
        exp.offline = offline_obj
        exp.cfc = cfc_obj
        exp.dic = dic_obj
        exp.init_continuity()
        return exp

    def init_continuity(self):
        """initialise_varia.F:336: integrate continuity once at init for
        the initial wVel (and, with exactConserv, dEtaHdt). Re-call after
        overriding the initial velocities (custom ini_vel experiments)."""
        cfg, grid = self.cfg, self.grid

        @jax.jit
        def _cont(st):
            g = grid
            if cfg.nonlinFreeSurf > 0 and cfg.select_rStar > 0:
                from mitgcm_tpu.model import rstar as rstar_mod
                fC, fW, fS = rstar_mod.rstar_facs(cfg, grid, st.etaH)
                g = rstar_mod.rstar_view(cfg, grid, fC, fW, fS)
            ob0 = self.obcs.ob0 if self.obcs is not None else None
            obm0 = self.obcs.masks if self.obcs is not None else None
            w, _etaN, etaH, dEtaHdt, PmEpR = step_mod.integr_continuity(
                cfg, g, st.uVel, st.vVel, st.etaN, st.etaH,
                st.dEtaHdt, jnp.zeros_like(st.etaN),
                jnp.asarray(cfg.nIter0), h0FacC=grid.hFacC,
                ob=ob0, obm=obm0)
            fill = ((lambda a: self.cs_fill.fill(a))
                    if self.cs_fill is not None
                    else (lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)))
            return fill(w), fill(etaH), fill(dEtaHdt), fill(PmEpR)

        w, etaH, dEtaHdt, PmEpR = _cont(self.state)
        upd = {"wVel": w}
        if cfg.exactConserv:
            # the init call also runs UPDATE_ETAH (integr_continuity.F:343):
            # etaHnm1 := etaH, etaH := etaN
            upd["dEtaHdt"] = dEtaHdt
            upd["PmEpR"] = PmEpR
            upd["etaHm1"] = self.state.etaH
            upd["etaH"] = etaH
        self.state = State(**{**self.state.__dict__, **upd})

    # ------------------------------------------------------------------
    def _step_kwargs(self):
        """The packages and halo hooks that every runner hands forward_step."""
        kw = {name: getattr(self, name, None) for name in _PACKAGES}
        if self.cs_fill is not None:
            kw.update(fill=self.cs_fill.fill, fill_uv=self.cs_fill.fill_uv,
                      fill_uv_cg=self.cs_fill.fill_uv_cg)
        return kw

    def _bind(self, fn):
        """jax.jit(fn) with this experiment's grid, cg2d operator and the
        packages' arrays as arguments. fn(*args, grid, op, step_kwargs).

        Arrays that a jitted function closes over are written into the
        compiled module as literals: gigabytes at full width, in the
        module, its cache key and the executable."""
        kw = self._step_kwargs()
        pkg = {name: {a: v for a, v in vars(obj).items()
                      if isinstance(v, (jax.Array, Grid))}
               for name, obj in kw.items()
               if name in _PACKAGES and hasattr(obj, "__dict__")}

        def with_packages(*args, grid, op, pkg):
            full = dict(kw)
            for name, attrs in pkg.items():
                full[name] = copy.copy(kw[name])
                vars(full[name]).update(attrs)
            return fn(*args, grid, op, full)

        return partial(jax.jit(with_packages), grid=self.grid, op=self.op,
                       pkg=pkg)

    def make_step_fn(self):
        """The jitted step(state, forcing, myIter) -> (state, StepDiag)."""
        if getattr(self, "_step_fn", None) is None:
            cfg = self.cfg
            self._step_fn = self._bind(
                lambda state, forcing, myIter, grid, op, kw:
                step_mod.forward_step(cfg, grid, op, state, forcing, myIter,
                                      **kw))
        return self._step_fn

    def make_scan_fn(self):
        """The jitted scan(state, forcing, iters) -> (state, stacked
        StepDiag) of run_scan: the steps as one program."""
        if getattr(self, "_scan_fn", None) is None:
            cfg = self.cfg

            def scan(state, forcing, iters, grid, op, kw):
                def body(st, myIter):
                    new_state, diag = step_mod.forward_step(
                        cfg, grid, op, st, forcing, myIter, **kw)
                    # don't stack the per-step 2-D forcing snapshots
                    return new_state, diag._replace(forc=None)
                return jax.lax.scan(body, state, iters)

            self._scan_fn = self._bind(scan)
        return self._scan_fn

    def forcing_monitor(self, forc) -> Dict[str, float]:
        """monitor.F:133-146 forcing_* stats (monitorSelect>=3) from the
        step's effective forcing dict (StepDiag.forc)."""
        if self.cfg.monitorSelect < 3 or forc is None:
            return {}
        if not hasattr(self, "_forc_mon_fn"):
            cfg = self.cfg
            self._forc_mon_fn = jax.jit(
                lambda f, g: monitor.forcing_stats(cfg, g, f))
        return {k: float(v)
                for k, v in self._forc_mon_fn(forc, self.grid).items()}

    def initial_forcing(self) -> Dict[str, float]:
        """The init-time effective forcing for the iter-0 monitor record.

        For the simple periodic path, INI_FORCING (ini_forcing.F:67-80)
        reads the raw FIRST record of each file with no time
        interpolation, so the tsnumber-0 %MON forcing_* lines show
        record 1 verbatim.  With exf active, the core fu/fv/Qnet/...
        arrays are still zero at the iter-0 monitor (EXF_GETFORCING
        fills them inside forward_step only), so all stats print 0."""
        cfg = self.cfg
        z = jnp.zeros_like(self.grid.rA)
        if cfg.useEXF:
            return {k: z for k in ("Qnet", "Qsw", "EmPmR", "fu", "fv")}
        out = {}
        for k in ("Qnet", "Qsw", "EmPmR", "fu", "fv"):
            a = getattr(self.forcing, k)
            out[k] = a[0] if a.ndim == 3 else a
        return out

    def monitor_stats(self, state: Optional[State] = None) -> Dict[str, float]:
        st = state if state is not None else self.state
        if not hasattr(self, "_monitor_fn"):
            cfg = self.cfg

            def mon(s, grid):
                g = grid
                if cfg.nonlinFreeSurf > 0 and cfg.select_rStar > 0:
                    # hFac as applied by the last UPDATE_R_STAR =
                    # h0 * F(etaH at entry of the last step) = F(etaHm1)
                    from mitgcm_tpu.model import rstar as rstar_mod
                    fC, fW, fS = rstar_mod.rstar_facs(cfg, grid, s.etaHm1)
                    g = rstar_mod.rstar_view(cfg, grid, fC, fW, fS)
                elif cfg.nonlinFreeSurf > 0:
                    # surf-dr analog: hFac as set by the last
                    # UPDATE_SURF_DR (calc_surf_dr from entry-time etaH)
                    from mitgcm_tpu.model import nlfs
                    fl = (self.cs_fill.fill if self.cs_fill is not None
                          else None)
                    fuv = None
                    if self.cs_fill is not None:
                        fuv = lambda a, b: self.cs_fill.fill_uv(  # noqa
                            a, b, False)
                    hs = nlfs.surf_dr_facs(cfg, grid, s.etaHm1,
                                           fill=fl, fill_uv=fuv)
                    g = nlfs.surf_dr_view(cfg, grid, *hs)
                stats = monitor.dynstat(cfg, g, s)
                if self.seaice is not None:
                    # pkg/seaice/seaice_monitor.F MON_WRITESTATS_RL calls
                    drn = grid.drF[:1]
                    rows = [("uice", s.uIce, grid.maskInW, grid.rAw),
                            ("vice", s.vIce, grid.maskInS, grid.rAs),
                            ("area", s.siAREA, grid.maskInC, grid.rA),
                            ("heff", s.siHEFF, grid.maskInC, grid.rA),
                            ("hsnow", s.siHSNOW, grid.maskInC, grid.rA)]
                    for i in range(self.seaice.p.SItrNumInUse):
                        rows.append((f"sitracer{i + 1:02d}",
                                     s.SItracer[i], grid.maskInC,
                                     grid.rA))
                    for nm, fld, mk, ar in rows:
                        st = monitor.calc_stats(cfg, fld[None], mk[None],
                                                mk, ar, drn)
                        for k2, v2 in st.items():
                            stats[f"seaice_{nm}_{k2}"] = v2
                if self.aim is not None \
                        and getattr(self.aim, "land", None) is not None:
                    from mitgcm_tpu.model import land as land_mod
                    lst = land_mod.LandState(
                        s.landEnthalp, s.landW, s.landT, s.landSkinT,
                        s.landHSnow, s.landSnowAge)
                    stats.update(self.aim.land.monitor(lst, cfg, grid))
                if getattr(self, "thsice", None) is not None:
                    th = {k: getattr(s, k) for k in
                          ("thIceMask", "thIceH", "thSnowH", "thSnowAge",
                           "thTsrf", "thTice1", "thTice2", "thQice1",
                           "thQice2")}
                    stats.update(self.thsice.monitor(th))
                return stats

            self._monitor_fn = jax.jit(mon)
        stats = self._monitor_fn(st, self.grid)
        return {k: float(v) for k, v in stats.items()}

    def run(self, n_steps: Optional[int] = None, collect_monitor: bool = True):
        """Python-loop runner (reference MAIN_DO_LOOP) with per-step diags.

        Returns list of dicts: one per monitor event (iter 0 included).
        """
        import time as _time
        cfg = self.cfg
        n = n_steps if n_steps is not None else cfg.nTimeSteps
        timers = getattr(self, "_timers", None)
        if timers is None:
            timers = self._timers = {}
        t0 = _time.perf_counter()
        step_fn = self.make_step_fn()
        timers["make_step_fn"] = timers.get("make_step_fn", 0.0) \
            + _time.perf_counter() - t0
        diag_mgr = getattr(self, "diag_mgr", None)
        nan_trap = getattr(self, "nan_trap", False)
        records: List[Dict[str, float]] = []
        # continue from wherever a previous run() call left off, so
        # incremental run(1) calls step through time like one long run
        if not hasattr(self, "_cur_iter") or self._cur_iter is None:
            self._cur_iter = cfg.nIter0
        if collect_monitor:
            rec = {"iter": self._cur_iter}
            rec.update(self.monitor_stats())
            if self._cur_iter == cfg.nIter0 and cfg.monitorSelect >= 3:
                rec.update(self.forcing_monitor(self.initial_forcing()))
            records.append(rec)
        state = self.state
        for _ in range(n):
            myIter = self._cur_iter
            t0 = _time.perf_counter()
            state, diag = step_fn(state, self.forcing, myIter)
            self._cur_iter = myIter + 1
            rec = {"iter": self._cur_iter,
                   "cg2d_init_res": float(diag.cg2d_init_res),
                   "cg2d_iters": int(diag.cg2d_iters),
                   "cg2d_last_res": float(diag.cg2d_last_res)}
            timers["forward_step"] = timers.get("forward_step", 0.0) \
                + _time.perf_counter() - t0
            if nan_trap:
                # debug NaN-trap: stop at the first step that corrupts
                # the state (the reference relies on post-mortem dumps)
                import numpy as _np
                for fname in ("etaN", "uVel", "theta", "salt"):
                    a = getattr(state, fname)
                    if a.size and not bool(_np.isfinite(
                            _np.asarray(a)).all()):
                        raise FloatingPointError(
                            f"NaN-trap: non-finite {fname} after iteration "
                            f"{self._cur_iter} (cg2d_init_res="
                            f"{rec['cg2d_init_res']!r})")
            if collect_monitor:
                t0 = _time.perf_counter()
                rec.update(self.monitor_stats(state))
                rec.update(self.forcing_monitor(diag.forc))
                timers["monitor"] = timers.get("monitor", 0.0) \
                    + _time.perf_counter() - t0
            records.append(rec)
            if diag_mgr is not None:
                self.state = state   # diagnostics read exp.state
                myTime = cfg.startTime \
                    + (self._cur_iter - cfg.nIter0) * cfg.deltaTClock
                t0 = _time.perf_counter()
                diag_mgr.step(myTime, self._cur_iter)
                timers["diagnostics"] = timers.get("diagnostics", 0.0) \
                    + _time.perf_counter() - t0
        self.state = state
        self.diags = records
        return records

    def timing_report(self) -> str:
        """Per-phase wall-clock table (eesupp/src/timers.F analog for the
        python driver loop; inside jit, XLA owns the schedule)."""
        timers = getattr(self, "_timers", {})
        total = sum(timers.values()) or 1.0
        lines = [" phase            seconds      %"]
        for k, v in sorted(timers.items(), key=lambda kv: -kv[1]):
            lines.append(f" {k:<16s} {v:8.3f} {100.0 * v / total:6.1f}")
        lines.append(f" {'total':<16s} {total:8.3f}  100.0")
        return "\n".join(lines)

    def enable_diagnostics(self, out_dir: str = ".",
                           path: Optional[str] = None) -> None:
        """Activate the pkg/diagnostics manager: parse the deck's
        data.diagnostics (or `path`) and write its output streams under
        out_dir during run()."""
        from mitgcm_tpu.model import diagnostics as diag_mod
        if path is None:
            path = os.path.join(self.cfg.run_dir, "data.diagnostics")
        os.makedirs(out_dir, exist_ok=True)
        self.diag_mgr = diag_mod.Diagnostics.from_file(self, path,
                                                       out_dir=out_dir)

    def run_scan(self, n_steps: Optional[int] = None):
        """lax.scan runner: the run as ONE compiled XLA program (monitor
        omitted; per-step cg2d diags stacked). Like run(), it continues
        from wherever the previous run() or run_scan() call stopped."""
        n = n_steps if n_steps is not None else self.cfg.nTimeSteps
        if getattr(self, "_cur_iter", None) is None:
            self._cur_iter = self.cfg.nIter0
        iters = self._cur_iter + jnp.arange(n)
        final_state, diags = self.make_scan_fn()(self.state, self.forcing,
                                                 iters)
        self.state = final_state
        self._cur_iter += n
        return final_state, diags


# ----------------------------------------------------------------------
# pickup (checkpoint) I/O — reference: model/src/write_pickup.F /
# read_pickup.F; format: MDS multi-record f64 + .meta with fldList
# ----------------------------------------------------------------------

_PICKUP_3D = ["Uvel", "Vvel", "Theta", "Salt",
              "GuNm1", "GvNm1", "GtNm1", "GsNm1"]
_PICKUP_2D = ["EtaN", "dEtaHdt", "EtaH"]


def _interior(cfg, a):
    return np.asarray(a)[..., cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]


def write_pickup(exp: "Experiment", out_dir: str, myIter: int) -> str:
    """Write pickup.<iter10>.data/.meta (write_pickup.F field set/order)."""
    cfg, st = exp.cfg, exp.state
    # AB3 carries a second tendency level (write_pickup.F:149/181 adds the
    # *Nm2 records when beta_AB != 0)
    flds3d = list(_PICKUP_3D)
    if cfg.useAB3:
        flds3d += ["GuNm2", "GvNm2", "GtNm2", "GsNm2"]
    # extra vs reference: carry wVel so restart is bit-identical without
    # relying on the recompute being fusion-identical to the in-step code
    # (the reference recomputes in initialise_varia.F — same Fortran, same
    # bits; XLA gives no such guarantee). Ignored by reference tooling.
    flds3d += ["Wvel"]
    recs = []
    for name in flds3d:
        fld = {"Uvel": st.uVel, "Vvel": st.vVel, "Theta": st.theta,
               "Salt": st.salt, "GuNm1": st.guNm1, "GvNm1": st.gvNm1,
               "GtNm1": st.gtNm1, "GsNm1": st.gsNm1,
               "GuNm2": st.guNm2, "GvNm2": st.gvNm2,
               "GtNm2": st.gtNm2, "GsNm2": st.gsNm2,
               "Wvel": st.wVel}[name]
        recs.append(_interior(cfg, fld))
    recs3d = np.concatenate(recs, axis=0)
    # 'EtaH' is etaHnm1, the pre-update_etah value (write_pickup.F:360);
    # PmEpR is an extra record (ignored by reference tooling) so our own
    # synchronous realFW restarts skip the lag-reconstruction
    recs2d = np.stack([_interior(cfg, st.etaN),
                       _interior(cfg, st.dEtaHdt),
                       _interior(cfg, st.etaHm1),
                       _interior(cfg, st.PmEpR)], axis=0)
    stack = np.concatenate([recs3d, recs2d], axis=0)
    # companion pickups (packages_write_pickup.F): ptracers + ggl90
    if cfg.usePTRACERS and st.pTr is not None and st.pTr.shape[0] > 0:
        npt = st.pTr.shape[0]
        pt_names = [f"pTr{i + 1:02d}" for i in range(npt)] + \
                   [f"gPtr{i + 1:02d}m1" for i in range(npt)]
        pt_stack = np.concatenate(
            [_interior(cfg, st.pTr[i]) for i in range(npt)]
            + [_interior(cfg, st.gPtrNm1[i]) for i in range(npt)], axis=0)
        mds.wrmds(os.path.join(out_dir, "pickup_ptracers"), pt_stack,
                  itr=myIter, dataprec="float64",
                  nrecords=pt_stack.shape[0], fldlist=pt_names,
                  timestep_number=myIter)
    if cfg.useGGL90 and st.GGL90TKE is not None:
        tke = _interior(cfg, st.GGL90TKE)
        mds.wrmds(os.path.join(out_dir, "pickup_ggl90"), tke,
                  itr=myIter, dataprec="float64",
                  nrecords=tke.shape[0], fldlist=["GGL90TKE"],
                  timestep_number=myIter)
    if cfg.useSEAICE and st.siHEFF is not None and st.siHEFF.ndim == 2:
        # pkg/seaice/seaice_write_pickup.F (old per-field format + the
        # multDim 'siTICES' stack + EVP sigmas); tracers as siTracNN
        si_names = []   # one name per FIELD (siTICES spans md records)
        si_recs = []    # one (gy, gx) array per RECORD
        md = st.siTICES.shape[0] if st.siTICES.ndim == 3 else 0
        if md > 1:
            si_names.append("siTICES")
            si_recs += [_interior(cfg, st.siTICES[i]) for i in range(md)]
        elif md == 1:
            si_names.append("siTICE")
            si_recs.append(_interior(cfg, st.siTICES[0]))
        for nm, fld in (("siAREA", st.siAREA), ("siHEFF", st.siHEFF),
                        ("siHSNOW", st.siHSNOW)):
            si_names.append(nm)
            si_recs.append(_interior(cfg, fld))
        if st.SItracer is not None and st.SItracer.ndim == 3:
            for i in range(st.SItracer.shape[0]):
                si_names.append(f"siTrac{i + 1:02d}")
                si_recs.append(_interior(cfg, st.SItracer[i]))
        si_names += ["siUICE", "siVICE"]
        si_recs += [_interior(cfg, st.uIce), _interior(cfg, st.vIce)]
        if st.siSigma is not None and st.siSigma.ndim == 3 \
                and st.siSigma.shape[0] == 3:
            si_names += ["siSigm1", "siSigm2", "siSigm12"]
            si_recs += [_interior(cfg, st.siSigma[i]) for i in range(3)]
        si_stack = np.stack(si_recs, axis=0)
        mds.wrmds(os.path.join(out_dir, "pickup_seaice"), si_stack,
                  itr=myIter, dataprec="float64",
                  nrecords=si_stack.shape[0], fldlist=si_names,
                  timestep_number=myIter)
    if cfg.useCDscheme and st.uVelD is not None and st.uVelD.ndim == 3:
        # pkg/cd_code/cd_code_write_pickup.F: uVelD,vVelD,uNM1,vNM1
        # (Nr records each) then etaNm1 — matches our reader above
        cd_stack = np.concatenate(
            [_interior(cfg, st.uVelD), _interior(cfg, st.vVelD),
             _interior(cfg, st.uNM1), _interior(cfg, st.vNM1),
             _interior(cfg, st.etaNm1)[None]], axis=0)
        mds.wrmds(os.path.join(out_dir, "pickup_cd"), cd_stack,
                  itr=myIter, dataprec="float64",
                  nrecords=cd_stack.shape[0],
                  fldlist=["uVelD", "vVelD", "uNM1", "vNM1", "etaNm1"],
                  timestep_number=myIter)
    froot = os.path.join(out_dir, "pickup")
    mds.wrmds(froot, stack, itr=myIter, dataprec="float64",
              nrecords=stack.shape[0],
              fldlist=flds3d + _PICKUP_2D + ["PmEpR"],
              timestep_number=myIter)
    return froot


def read_pickup(exp: "Experiment", in_dir: str, myIter: int) -> None:
    """Restore state from a pickup (read_pickup.F); sets startFromPickup."""
    cfg = exp.cfg
    froot = os.path.join(in_dir, "pickup")
    dtype = exp.state.etaN.dtype
    nr = cfg.nr
    if cfg.useOffLine and not os.path.exists(
            f"{froot}.{myIter:010d}.meta"):
        # offline runs restart from the companion pickups only (the
        # prescribed circulation replaces the main state each step)
        fields, meta, stack = {}, {}, None
    else:
        fields, meta = mds.read_mflds(froot, itr=myIter)
        stack = fields["__records__"]

    if cfg.nFaces > 1:
        # cubed-sphere pickup records are global-layout; scalar-fill the
        # halos here, u/v pairs get the vector exchange afterwards
        def pad3(a):
            return _pad_and_fill(cfg, np.asarray(a), dtype, exp.cs_fill)

        pad2 = pad3
    else:
        def pad3(a):
            out = np.zeros((nr, cfg.ny + 2 * cfg.oly,
                            cfg.nx + 2 * cfg.olx))
            out[:, cfg.oly:cfg.oly + cfg.ny,
                cfg.olx:cfg.olx + cfg.nx] = a
            return cyclic_fill_halo(jnp.asarray(out, dtype), cfg.oly,
                                    cfg.olx)

        def pad2(a):
            out = np.zeros((cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx))
            out[cfg.oly:cfg.oly + cfg.ny,
                cfg.olx:cfg.olx + cfg.nx] = a
            return cyclic_fill_halo(jnp.asarray(out, dtype), cfg.oly,
                                    cfg.olx)

    # walk the fldList: 3-D fields take nr records, 2-D one
    fld_names = [] if stack is None else [
        n for n in meta.get("fldList", _PICKUP_3D + _PICKUP_2D)
        if n and n.strip()]
    two_d = {"EtaN", "dEtaHdt", "EtaH", "EtaHnm1", "PmEpR", "Phi_rLow"}
    vals = {}
    off = 0
    for name in fld_names:
        name = name.strip()
        if name in two_d:
            vals[name] = pad2(stack[off])
            off += 1
        else:
            vals[name] = pad3(stack[off:off + nr])
            off += nr
    updates = {}
    if vals:
        updates = {
            "uVel": vals["Uvel"], "vVel": vals["Vvel"],
            "theta": vals["Theta"], "salt": vals["Salt"],
            "guNm1": vals["GuNm1"], "gvNm1": vals["GvNm1"],
            "gtNm1": vals["GtNm1"], "gsNm1": vals["GsNm1"],
            "etaN": vals["EtaN"],
        }
    # old-format pickups (e.g. aim.5l_LatLon, pickupStrictlyMatch=F)
    # lack EtaH/dEtaHdt: read_pickup.F falls back to etaH:=etaN and a
    # zero dEtaHdt
    if "dEtaHdt" in vals:
        updates["dEtaHdt"] = vals["dEtaHdt"]
    if vals:
        updates["etaH"] = vals.get("EtaH", vals["EtaN"])
    if "PhiHyd" in vals:
        updates["totPhiHyd"] = vals["PhiHyd"]
    if "Phi_rLow" in vals:
        # written for p-coords sea-ice runs (write_pickup.F:334-339)
        updates["phiHydLow"] = vals["Phi_rLow"]
    # AB3 second tendency level (read_pickup.F:285/305); if the pickup
    # lacks them the reference warns and keeps zeros — we do the same
    for pk, sk in (("GuNm2", "guNm2"), ("GvNm2", "gvNm2"),
                   ("GtNm2", "gtNm2"), ("GsNm2", "gsNm2")):
        if pk in vals:
            updates[sk] = vals[pk]
    # r* restart: old-time factors equal current ones (initialise_varia.F
    # calls CALC_R_STAR then UPDATE_R_STAR from the same etaH)
    if vals:
        updates["etaHm1"] = vals.get("EtaH", vals["EtaN"])
    if cfg.nFaces > 1 and exp.cs_fill is not None:
        # read_pickup.F exchanges: u/v get the C-grid VECTOR fill
        for ku, kv in (("uVel", "vVel"), ("guNm1", "gvNm1"),
                       ("guNm2", "gvNm2")):
            if ku in updates and kv in updates:
                uu, vv = exp.cs_fill.fill_uv(updates[ku], updates[kv])
                updates[ku], updates[kv] = uu, vv
    exp.state = State(**{**exp.state.__dict__, **updates})

    # pkg/land companion pickup (land_read_pickup.F new format:
    # enthalp[nLev], groundW[nLev], skinT, hSnow, snowAge)
    land_path = os.path.join(in_dir, f"pickup_land.{myIter:010d}")
    if (exp.aim is not None and getattr(exp.aim, "land", None) is not None
            and os.path.exists(land_path)):
        from mitgcm_tpu.model import land as land_mod
        gy, gx = _global_dims(cfg)
        raw = mds.read_raw(land_path, (7, gy, gx), ">f8")
        fill2d_l = lambda a: _pad_and_fill(     # noqa: E731
            cfg, np.asarray(a), dtype, exp.cs_fill)
        lst0 = land_mod.init_state(exp.aim.land, fill2d_l, None,
                                   pickup=raw)
        exp.state = State(**{
            **exp.state.__dict__,
            "landEnthalp": lst0.enthalp, "landW": lst0.groundW,
            "landT": lst0.groundT, "landSkinT": lst0.skinT,
            "landHSnow": lst0.hSnow, "landSnowAge": lst0.snowAge})

    # CD-scheme companion pickup (pkg/cd_code/cd_code_read_pickup.F:
    # records uVelD,vVelD,uNM1,vNM1 (Nr each) then etaNm1 at 4*Nr+1;
    # often written without a .meta file)
    cd_path = os.path.join(in_dir, f"pickup_cd.{myIter:010d}")
    if cfg.useCDscheme and (os.path.exists(cd_path)
                            or os.path.exists(cd_path + ".data")):
        if not os.path.exists(cd_path):
            cd_path = cd_path + ".data"
        raw = mds.read_raw(cd_path, (4 * nr + 1, cfg.ny, cfg.nx), ">f8")
        exp.state = State(**{
            **exp.state.__dict__,
            "uVelD": pad3(raw[0:nr]), "vVelD": pad3(raw[nr:2 * nr]),
            "uNM1": pad3(raw[2 * nr:3 * nr]),
            "vNM1": pad3(raw[3 * nr:4 * nr]),
            "etaNm1": pad2(raw[4 * nr]),
        })
    # ptracers companion pickup (pkg/ptracers/ptracers_read_pickup.F)
    pt_root = os.path.join(in_dir, "pickup_ptracers")
    if cfg.usePTRACERS:
        if os.path.exists(f"{pt_root}.{myIter:010d}.meta"):
            pfields, pmeta = mds.read_mflds(pt_root, itr=myIter)
            pstack = pfields["__records__"]
            pnames = [n.strip() for n in pmeta.get("fldList", [])
                      if n and n.strip()]
            npt = exp.state.pTr.shape[0]
            ptr = list(jnp.asarray(exp.state.pTr))
            gptr = list(jnp.asarray(exp.state.gPtrNm1))
            off = 0
            for name in pnames:
                rec = pad3(pstack[off:off + nr]); off += nr
                if name.startswith("pTr"):
                    idx = int(name[3:5]) - 1
                    if idx < npt:
                        ptr[idx] = rec
                elif name.startswith("gPtr"):
                    idx = int(name[4:6]) - 1
                    if idx < npt:
                        gptr[idx] = rec
            exp.state = State(**{**exp.state.__dict__,
                                 "pTr": jnp.stack(ptr),
                                 "gPtrNm1": jnp.stack(gptr)})
        elif exp.state.pTr is not None and exp.state.pTr.shape[0] > 0:
            raise FileNotFoundError(
                f"usePTRACERS restart needs {pt_root}.{myIter:010d} "
                "(refusing to silently reset passive tracers)")
    # ggl90 companion pickup (pkg/ggl90/ggl90_read_pickup.F)
    gg_root = os.path.join(in_dir, "pickup_ggl90")
    if cfg.useGGL90:
        if os.path.exists(f"{gg_root}.{myIter:010d}.meta"):
            gfields, _gm = mds.read_mflds(gg_root, itr=myIter)
            exp.state = State(**{**exp.state.__dict__,
                                 "GGL90TKE": pad3(gfields["__records__"][:nr])})
        else:
            raise FileNotFoundError(
                f"useGGL90 restart needs {gg_root}.{myIter:010d} "
                "(refusing to silently reset GGL90TKE)")
    # seaice companion pickup (pkg/seaice/seaice_read_pickup.F); old
    # format: per-field single records, 'siTICE' broadcast to all
    # categories, 'siTrac*' tolerated missing (keeps init values)
    si_meta = os.path.join(in_dir, f"pickup_seaice.{myIter:010d}.meta")
    if cfg.useSEAICE and os.path.exists(si_meta):
        sfields, smeta = mds.read_mflds(
            os.path.join(in_dir, "pickup_seaice"), itr=myIter)
        sstack = sfields["__records__"]
        snames = [n.strip() for n in smeta.get("fldList", [])
                  if n and n.strip()]
        md = exp.state.siTICES.shape[0]
        svals = {}
        rec = 0
        for nm in snames:
            if nm == "siTICES":
                # multDim>1: one record per thickness category
                svals[nm] = jnp.stack(
                    [pad2(sstack[rec + i]) for i in range(md)])
                rec += md
            else:
                svals[nm] = pad2(sstack[rec])
                rec += 1
        su = {}
        if "siTICE" in svals:
            su["siTICES"] = jnp.broadcast_to(
                svals["siTICE"], (md,) + svals["siTICE"].shape)
        if "siTICES" in svals:
            su["siTICES"] = svals["siTICES"]
        ntr = exp.state.SItracer.shape[0] \
            if exp.state.SItracer is not None \
            and exp.state.SItracer.ndim == 3 else 0
        if ntr and all(f"siTrac{i + 1:02d}" in svals for i in range(ntr)):
            su["SItracer"] = jnp.stack(
                [svals[f"siTrac{i + 1:02d}"] for i in range(ntr)])
        for pk, sk in (("siAREA", "siAREA"), ("siHEFF", "siHEFF"),
                       ("siHSNOW", "siHSNOW"), ("siHSALT", "siHSALT"),
                       ("siUICE", "uIce"), ("siVICE", "vIce")):
            if pk in svals:
                su[sk] = svals[pk]
        # EVP internal stresses (seaice_write_pickup.F:171-192)
        if all(k in svals for k in ("siSigm1", "siSigm2", "siSigm12")):
            su["siSigma"] = jnp.stack([svals["siSigm1"],
                                       svals["siSigm2"],
                                       svals["siSigm12"]])
        exp.state = State(**{**exp.state.__dict__, **su})
    exp.cfg.startFromPickup = True
    # keep (startTime, nIter0) consistent: myTime = startTime +
    # (myIter-nIter0)*deltaTClock, and the reference's invariant is
    # startTime = baseTime + nIter0*deltaTClock (ini_parms.F:1126)
    exp.cfg.startTime = (exp.cfg.baseTime
                         + myIter * exp.cfg.deltaTClock)
    exp.cfg.nIter0 = myIter
    exp._cur_iter = None   # restart run() iteration tracking
    if "Wvel" in vals:
        # our own pickups carry wVel (and PmEpR) — bit-identical restart,
        # no recompute; still apply UPDATE_ETAH (update_etah.F:58-73):
        # the stored 'EtaH' (= etaHnm1) stays in etaHm1, etaH := etaN
        su2 = {"wVel": vals["Wvel"]}
        if "PmEpR" in vals:
            su2["PmEpR"] = vals["PmEpR"]
        if cfg.exactConserv:
            su2["etaH"] = (vals["EtaN"]
                           + (1.0 - cfg.implicDiv2Dflow) * vals["dEtaHdt"]
                           * cfg.deltaTFreeSurf)
        exp.state = State(**{**exp.state.__dict__, **su2})
        return
    # initialise_varia.F:336: recompute wVel (and, with exactConserv,
    # dEtaHdt) from the restored velocities — wVel is not in the pickup
    g = exp.grid
    if cfg.nonlinFreeSurf > 0 and cfg.select_rStar > 0:
        from mitgcm_tpu.model import rstar as rstar_mod
        fC, fW, fS = rstar_mod.rstar_facs(cfg, exp.grid, exp.state.etaH)
        g = rstar_mod.rstar_view(cfg, exp.grid, fC, fW, fS)
    w, etaN, etaH, dEtaHdt, PmEpR = step_mod.integr_continuity(
        exp.cfg, g, exp.state.uVel, exp.state.vVel,
        exp.state.etaN, exp.state.etaH, exp.state.dEtaHdt,
        jnp.zeros_like(exp.state.etaN), jnp.asarray(myIter),
        h0FacC=exp.grid.hFacC)
    fill = lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)
    upd = {"wVel": fill(w), "dEtaHdt": fill(dEtaHdt)}
    if cfg.exactConserv:
        # UPDATE_ETAH runs on the init call too (integr_continuity.F:343):
        # the pickup etaH (which lags etaN by one step) moves to etaHm1
        # and etaH := etaN; with realFreshWaterFlux the returned dEtaHdt
        # is the pickup value and PmEpR the flux reconstructed from it
        upd["PmEpR"] = fill(PmEpR)
        upd["etaHm1"] = exp.state.etaH
        upd["etaH"] = fill(etaH)
    exp.state = State(**{**exp.state.__dict__, **upd})


def write_state(exp: "Experiment", out_dir: str, myIter: int) -> None:
    """Snapshot output U/V/W/T/S/Eta (model/src/write_state.F), one MDS
    file per field like the reference's dumpFreq output."""
    cfg, st = exp.cfg, exp.state
    for name, fld in (("U", st.uVel), ("V", st.vVel), ("W", st.wVel),
                      ("T", st.theta), ("S", st.salt)):
        mds.wrmds(os.path.join(out_dir, name), _interior(cfg, fld),
                  itr=myIter, dataprec="float64", timestep_number=myIter)
    mds.wrmds(os.path.join(out_dir, "Eta"), _interior(cfg, st.etaN),
              itr=myIter, dataprec="float64", timestep_number=myIter)
