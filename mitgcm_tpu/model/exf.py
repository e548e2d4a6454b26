"""External forcing package (reference: pkg/exf) — simple-field subset.

Implements the exf field pipeline for prescribed surface fluxes:
  - record selection & time interpolation (exf_set_fld.F):
      fldPeriod > 0   : uniform period, optional repeatCycle
      fldPeriod = -12 : 12 calendar-monthly records (cal_getmonthsrec.F)
      fldPeriod = -1  : sequential monthly records from the field start
                        month (exf_getmonthsrec.F)
  - on-the-fly spatial interpolation from a regular lat-lon source grid
    (USE_EXF_INTERPOLATION: exf_interp.F + exf_interpolate.F, bilinear
    method 1/11/21 and bicubic Lagrange 2/12/22, periodic longitude,
    pole rows, land filter exf_filter_rl.F)
  - mapping onto the model forcing arrays (exf_mapfields.F): Qnet from
    hflux, EmPmR from sflux*rhoConstFresh, fu/fv from ustress/vstress
    (C-grid average when .NOT.stressIsOnCgrid, +-windstressmax clamp),
    SST/SST climatologies with the climtempfreeze floor, and the
    relaxation constants folded into tauTheta/SaltClimRelax
    (exf_readparms.F:1076).

Design: every record is read + spatially interpolated ONCE at
setup (host-side numpy); the calendar-aware record/weight selection is
collapsed into per-field monotone time-knot tables so the in-jit
evaluation is a plain piecewise-linear lookup (load_fields) — this
reproduces the reference weights bit-for-bit because both reduce to
(t_mid1 - t)/(t_mid1 - t_mid0) on exact integer-seconds knots.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.io import mds
from mitgcm_tpu.utils.cal import Cal

_SPD = 86400.0

# (exf name, NML suffix aliases) -> handled fields and their defaults
_FIELDS = ["hflux", "sflux", "ustress", "vstress", "swflux", "lwflux",
           "atemp", "aqh", "uwind", "vwind", "precip", "evap",
           "swdown", "lwdown", "runoff", "runoftemp", "wspeed",
           "snowprecip", "climsst", "climsss", "apressure"]
_INTERP_DEFAULT = {"hflux": 1, "sflux": 1, "swflux": 1, "lwflux": 1,
                   "ustress": 12, "vstress": 22, "uwind": 12,
                   "vwind": 22, "atemp": 1, "aqh": 1, "precip": 1,
                   "evap": 1, "swdown": 1, "lwdown": 1, "runoff": 1,
                   "runoftemp": 1, "wspeed": 1, "snowprecip": 1,
                   "climsst": 2, "climsss": 2, "apressure": 1}

# EXF_CONSTANTS.h + exf_readparms.F:318-370 bulk-formulae constants
BULK = dict(
    cen2kel=273.150, gravity_mks=9.81, atmrho=1.200, atmcp=1005.0,
    flamb=2500000.0, flami=334000.0,
    cvapor_fac=640380.0, cvapor_exp=5107.4,
    cvapor_fac_ice=11637800.0, cvapor_exp_ice=5897.8,
    humid_fac=0.606, gamma_blk=0.010, saltsat=0.980, sstExtrapol=0.0,
    cdrag_1=0.0027000, cdrag_2=0.0001420, cdrag_3=0.0000764,
    cstanton_1=0.0327, cstanton_2=0.0180, cdalton=0.0346,
    zolmin=-100.0, psim_fac=5.0, zref=10.0, hu=10.0, ht=2.0,
    umin=0.5, exf_albedo=0.1,
    ocean_emissivity=5.50e-8 / 5.670e-8, stefanBoltzmann=5.670e-8,
    karman=0.4, niter_bulk=2, exf_scal_BulkCdn=1.0,
)


def _lagran(i, x, a, sp):
    """exf_interpolate.F LAGRAN: Lagrange weight i of sp-point stencil."""
    numer = np.ones_like(x)
    denom = 1.0
    for k in range(1, sp + 1):
        if k != i:
            denom = denom * (a[i - 1] - a[k - 1])
            numer = numer * (x - a[k - 1])
    return numer / denom


def exf_interp_np(arr, lon0, lon_inc, lat_inc_list, lat0, nlon, nlat,
                  xC, yC, method):
    """exf_interp.F + exf_interpolate.F on one record (numpy, float64).

    arr: [nlat, nlon] source record; xC/yC: target coordinates (deg);
    returns target-shaped array."""
    nxIn, nyIn = nlon, nlat
    xoff = yoff = 2          # Fortran index i lives at numpy [i + off]
    # source longitudes x_in(-1 : nxIn+2)
    x_in = np.empty(nxIn + 5)
    for i in range(-1, nxIn + 3):
        x_in[xoff + i] = lon0 + (i - 1) * lon_inc
    # latitudes y_in(-1 : nyIn+2)
    y_in = np.empty(nyIn + 5)
    y_in[yoff + 1] = lat0
    lat_inc = list(lat_inc_list) + [lat_inc_list[-1]] * nyIn
    for j in range(1, nyIn + 2):
        i = min(j, nyIn - 1)
        y_in[yoff + j + 1] = y_in[yoff + j] + lat_inc[i - 1]
    y_in[yoff + 0] = y_in[yoff + 1] - lat_inc[0]
    y_in[yoff - 1] = y_in[yoff + 0] - lat_inc[0]

    xIsPeriodic = nxIn == int(round(360.0 / lon_inc))
    nxd2 = int(round(nxIn * 0.5))
    poleSymmetry = xIsPeriodic and (nxIn == 2 * nxd2)

    # pole clamps (method < 10 handling applies to scalar AND the
    # method>=10 vector variants use the same y_in edges)
    if method < 10:
        for j in (0, -1):
            if abs(y_in[yoff + j + 1]) < 90.0 \
                    and abs(y_in[yoff + j]) > 90.0:
                y_in[yoff + j] = -90.0
                if j == 0:
                    y_in[yoff + j - 1] = -180.0 - y_in[yoff + j + 1]
    for j in (nyIn + 1, nyIn + 2):
        if abs(y_in[yoff + j - 1]) < 90.0 and abs(y_in[yoff + j]) > 90.0:
            y_in[yoff + j] = 90.0
            if j == nyIn + 1:
                y_in[yoff + j + 1] = 180.0 - y_in[yoff + j - 1]

    # padded array a(-1:nxIn+2, -1:nyIn+2)
    a = np.zeros((nyIn + 5, nxIn + 5))
    a[yoff + 1:yoff + nyIn + 1, xoff + 1:xoff + nxIn + 1] = arr
    if xIsPeriodic:
        a[:, xoff + 0] = a[:, xoff + nxIn]
        a[:, xoff - 1] = a[:, xoff + nxIn - 1]
        a[:, xoff + nxIn + 1] = a[:, xoff + 1]
        a[:, xoff + nxIn + 2] = a[:, xoff + 2]
    else:
        a[:, xoff + 0] = a[:, xoff + 1]
        a[:, xoff - 1] = a[:, xoff + 1]
        a[:, xoff + nxIn + 1] = a[:, xoff + nxIn]
        a[:, xoff + nxIn + 2] = a[:, xoff + nxIn]
    symSign = -1.0 if method >= 10 else 1.0
    for ll in (-1, 0, 1, 2):
        j = ll if ll < 1 else nyIn + ll
        k = max(1, min(j, nyIn))
        if poleSymmetry and abs(y_in[yoff + j]) > 90.0:
            if nyIn >= 3 and abs(y_in[yoff + k]) == 90.0:
                k = max(2, min(j, nyIn - 1))
            row = a[yoff + k]
            new = np.empty_like(row)
            # arrayin(i,j) = symSign*arrayin(i+nxd2,k) for i=-1..nxd2
            for i in range(-1, nxd2 + 1):
                new[xoff + i] = symSign * row[xoff + i + nxd2]
            for i in range(1, nxd2 + 3):
                new[xoff + i + nxd2] = symSign * row[xoff + i]
            a[yoff + j] = new
        else:
            a[yoff + j] = a[yoff + k]
    if method < 10:
        for ll in (-1, 0, 1, 2, 3, 4):
            j = ll if ll < 2 else nyIn + ll - 2
            if abs(y_in[yoff + j]) == 90.0 and method in (1, 2):
                pole = a[yoff + j, xoff + 1:xoff + nxIn + 1].sum() / nxIn
                a[yoff + j] = pole
        for ll in (0, 1):
            k = ll * (nyIn + 3) - 1
            if abs(y_in[yoff + k]) == 90.0:
                j = ll * (nyIn + 1)
                i = ll * (nyIn - 1) + 1
                edgeFac = (y_in[yoff + j] - y_in[yoff + k]) \
                    / (y_in[yoff + i] - y_in[yoff + k])
                poleFac = (y_in[yoff + i] - y_in[yoff + j]) \
                    / (y_in[yoff + i] - y_in[yoff + k])
                a[yoff + j] = a[yoff + j] * edgeFac + a[yoff + k] * poleFac

    # target coords: wrap longitude into [lon0, lon0+360)
    xG = lon0 + np.mod(xC - lon0 + 720.0, 360.0)
    yG = yC
    # s_ind: y_in(s) <= y < y_in(s+1), via the same bisection result
    s_ind = np.searchsorted(y_in[yoff + 0:yoff + nyIn + 2], yG,
                            side="right") - 1
    s_ind = np.clip(s_ind, 0, nyIn)
    w_ind = (np.floor((xG - x_in[xoff - 1]) / lon_inc)).astype(int) - 1

    sp = 2 if method % 10 == 1 else 4
    out = np.zeros_like(xG)
    if sp == 2:
        px = [x_in[xoff + w_ind], x_in[xoff + w_ind + 1]]
        py = [y_in[yoff + s_ind], y_in[yoff + s_ind + 1]]
        Lx = [_lagran(i, xG, px, 2) for i in (1, 2)]
        Ly = [_lagran(i, yG, py, 2) for i in (1, 2)]
        for k in range(2):
            ew = (a[yoff + s_ind + k, xoff + w_ind] * Lx[0]
                  + a[yoff + s_ind + k, xoff + w_ind + 1] * Lx[1])
            out = out + ew * Ly[k]
    else:
        px = [x_in[xoff + w_ind + l] for l in (-1, 0, 1, 2)]
        py = [y_in[yoff + s_ind + l] for l in (-1, 0, 1, 2)]
        Lx = [_lagran(i, xG, px, 4) for i in (1, 2, 3, 4)]
        Ly = [_lagran(i, yG, py, 4) for i in (1, 2, 3, 4)]
        for k in range(4):
            ew = np.zeros_like(xG)
            for l in range(4):
                ew = ew + a[yoff + s_ind + k - 1,
                            xoff + w_ind + l - 1] * Lx[l]
            out = out + ew * Ly[k]
    return out


class EXF:
    """Parsed data.exf + precomputed forcing records and time knots."""

    def __init__(self, cfg: Config, grid: Grid, input_dir: str,
                 calobj: Cal, n_steps_margin: int = 4):
        self.cfg, self.grid, self.cal = cfg, grid, calobj
        from mitgcm_tpu.core import nml
        groups = nml.read_namelist(cfg.find_file("data.exf"))
        g1 = groups.get("EXF_NML_01", {})
        g2 = groups.get("EXF_NML_02", {})
        g3 = groups.get("EXF_NML_03", {})
        g4 = groups.get("EXF_NML_04", {})
        self.iprec = int(g1.get("exf_iprec", 32))
        self.input_dir = input_dir
        self.windstressmax = float(g1.get("windstressmax", 2.0))
        self.climtempfreeze = float(g1.get("climtempfreeze", -1.9))
        repeatPeriod = float(g1.get("repeatperiod", 0.0))
        # compile options (code/EXF_OPTIONS.h): ALLOW_ATM_WIND sets the
        # useAtmWind default (exf_readparms.F); ALLOW_BULK_LARGEYEAGER04
        # selects the Large&Yeager04 stability-iteration branch
        from mitgcm_tpu.model.kpp import scan_cpp_options
        optp = cfg.find_code_file("EXF_OPTIONS.h")
        opts = scan_cpp_options(optp) if optp else {"ALLOW_ATM_WIND"}
        useAtmWind_dflt = "ALLOW_ATM_WIND" in opts
        v = g1.get("useatmwind", None)
        self.useAtmWind = bool(v) if v is not None else useAtmWind_dflt
        self.ly04 = "ALLOW_BULK_LARGEYEAGER04" in opts
        self.stressIsOnCgrid = bool(g1.get("readstressoncgrid", False))
        if bool(g1.get("readstressonagrid", False)):
            raise NotImplementedError("readStressOnAgrid")
        # bulk-formulae constants with EXF_NML_01 overrides
        # (exf_readparms.F EXF_NML_01 constants block)
        bulk = dict(BULK)
        for k in ("atmrho", "atmcp", "flamb", "flami", "humid_fac",
                  "gamma_blk", "saltsat", "cdrag_1", "cdrag_2", "cdrag_3",
                  "cstanton_1", "cstanton_2", "cdalton", "zolmin",
                  "psim_fac", "zref", "hu", "ht", "umin", "exf_albedo",
                  "ocean_emissivity", "cen2kel", "exf_scal_bulkcdn",
                  "sstextrapol", "niter_bulk"):
            if k in {kk.lower() for kk in g1}:
                val = {kk.lower(): vv for kk, vv in g1.items()}[k]
                tgt = {"exf_scal_bulkcdn": "exf_scal_BulkCdn",
                       "sstextrapol": "sstExtrapol"}.get(k, k)
                bulk[tgt] = type(BULK[tgt])(val)
        cfg.exf_bulk = bulk
        cfg.exf_useAtmWind = self.useAtmWind
        cfg.exf_ly04 = self.ly04
        cfg.exf_stressCgrid = self.stressIsOnCgrid
        cfg.exf_runoftemp = bool(str(g2.get("runoftempfile", "")).strip())
        self.fields = {}
        for name in _FIELDS:
            f = dict(
                file=str(g2.get(name + "file", "")).strip(),
                period=float(g2.get(name + "period", 0.0)),
                repCycle=float(g2.get(name + "repeatcycle",
                                      g2.get(name + "repcycle",
                                             repeatPeriod))),
                startdate1=int(g2.get(name + "startdate1", 0)),
                startdate2=int(g2.get(name + "startdate2", 0)),
                inscal=float(g3.get("exf_inscal_" + name, 1.0)),
                lon0=float(g4.get(name + "_lon0", 0.0)),
                lon_inc=float(g4.get(name + "_lon_inc", 1.0)),
                lat0=float(g4.get(name + "_lat0", 0.0)),
                lat_inc=g4.get(name + "_lat_inc", [1.0]),
                nlon=int(g4.get(name + "_nlon", 0)),
                nlat=int(g4.get(name + "_nlat", 0)),
                method=int(g4.get(name + "_interpmethod",
                                  _INTERP_DEFAULT[name])),
            )
            if not isinstance(f["lat_inc"], list):
                f["lat_inc"] = [f["lat_inc"]]
            self.fields[name] = f
        # relaxation constants override the model ones
        # (exf_readparms.F:1076-1077)
        if float(g2.get("climssttaurelax", 0.0)) != 0.0:
            cfg.tauThetaClimRelax = float(g2["climssttaurelax"])
        if float(g2.get("climssstaurelax", 0.0)) != 0.0:
            cfg.tauSaltClimRelax = float(g2["climssstaurelax"])

    # -----------------------------------------------------------------
    def _field_start_time(self, f) -> float:
        """exf_getffield_start.F (non-yearly): model time of the field
        start date."""
        if f["startdate1"] == 0 and f["startdate2"] == 0:
            return self.cfg.startTime
        # startTime + ToSeconds(date - modelStartDate) collapses to the
        # date measured from the calendar start date
        return self.cal.date_to_time(f["startdate1"], f["startdate2"])

    def _read_records(self, f, recs):
        path = self.cfg.find_file(f["file"])
        prec = ">f4" if self.iprec == 32 else ">f8"
        itemsize = 4 if self.iprec == 32 else 8
        ny, nx = f["nlat"], f["nlon"]
        if ny == 0 or nx == 0:       # no interpolation: model-grid file
            ny = self.cfg.ny * self.cfg.nFaces
            nx = self.cfg.nx
        nrec_file = os.path.getsize(path) // (itemsize * ny * nx)
        arr = mds.read_raw(path, (nrec_file, ny, nx), prec)
        return arr.astype(np.float64), nrec_file

    def build(self, t_end: float, pad_and_fill):
        """Returns dict: model forcing name -> (records [n,NY,NX] jnp,
        knots [n] np.float64). pad_and_fill: experiment's grid-shaping
        hook for model-grid-resolution arrays."""
        cfg, grid = self.cfg, self.grid
        xC = np.asarray(grid.xC)
        yC = np.asarray(grid.yC)
        out = {}
        for name, f in self.fields.items():
            if not f["file"]:
                continue
            raw, nrec_file = self._read_records(f, None)
            startT = self._field_start_time(f)
            # --- record sequence + knots ---
            if f["period"] in (-12.0, -1.0):
                knots_ym = self.cal.month_mid_knots(cfg.startTime, t_end)
                recs, knots = [], []
                if f["period"] == -12.0:
                    for (tm, y, m) in knots_ym:
                        recs.append(m - 1)
                        knots.append(tm)
                else:
                    # sequential records from the field start month
                    sd = self.cal.date_to_time(f["startdate1"],
                                               f["startdate2"])
                    # date of fldStartTime (cal_getdate(0, fldStartTime))
                    y0, m0 = f["startdate1"] // 10000, \
                        (f["startdate1"] // 100) % 100
                    for (tm, y, m) in knots_ym:
                        r = (y - y0) * 12 + m - m0
                        recs.append(r)
                        knots.append(tm)
                keep = [(r, t) for r, t in zip(recs, knots)
                        if 0 <= r < nrec_file]
                recs = [r for r, _ in keep]
                knots = [t for _, t in keep]
            elif f["period"] > 0.0:
                per, cyc = f["period"], f["repCycle"]
                knots, recs = [], []
                n0 = 0
                if cyg := cyc > 0.0:
                    # cyclic fields may be needed before the field start
                    n0 = int(np.floor((cfg.startTime - startT) / per)) - 2
                n = n0
                while startT + n * per <= t_end + 2 * per:
                    if cyc > 0.0:
                        recs.append(n % int(round(cyc / per)))
                    else:
                        recs.append(max(n, 0))
                    knots.append(startT + n * per)
                    n += 1
                recs = [min(r, nrec_file - 1) for r in recs]
            else:
                # constant-in-time field (period=0): single record, no
                # interpolation knots (load_fields uses record 0 as is)
                recs, knots = [0], None
            # --- spatial interpolation per needed record ---
            uniq = sorted(set(recs))
            interp_cache = {}
            for r in uniq:
                rec = raw[r]
                if f["nlon"] > 0:
                    fld = exf_interp_np(
                        rec, f["lon0"], f["lon_inc"], f["lat_inc"],
                        f["lat0"], f["nlon"], f["nlat"],
                        xC, yC, f["method"])
                else:
                    fld = pad_and_fill(rec)
                interp_cache[r] = fld * f["inscal"]
            stack = np.stack([interp_cache[r] for r in recs])
            out[name] = (stack, None if knots is None
                         else np.asarray(knots, np.float64))
        return out


def bulk_fluxes(cfg: Config, grid: Grid, forc, theta1, uVel1=None,
                vVel1=None):
    """EXF_RADIATION + EXF_WIND + EXF_BULKFORMULAE + the hflux/sflux
    assembly of exf_getforcing.F and the exf_mapfields.F mapping —
    the per-step (in-jit) part of the exf pipeline.

    forc: instantaneous Forcing (atemp [K], aqh, uwind/vwind [m/s],
    precip [m/s], swdown/lwdown [W/m2], runoff [m/s] already
    time-interpolated); theta1: surface-level potential temperature.
    Returns dict(fu, fv, Qnet, Qsw, EmPmR, hs, hl, evap, wspeed,
    ustress, vstress) on the model convention (exf_mapfields.F).

    Two stability-iteration branches (exf_bulkformulae.F): the classic
    Large&Pond-style one and, with ALLOW_BULK_LARGEYEAGER04 compiled
    (cfg.exf_ly04), the Large&Yeager04 form (huol clamped to +-10, xsq
    without the >=1 floor, wind shifted by 1+rdn*(zwln-psimh)/karman).
    With useAtmWind=F the wind stress comes from the input files
    (exf_wind.F:133-160) and only the scalar transfer coefficients are
    iterated (solve4Stress requires a wspeed file)."""
    B = cfg.exf_bulk if cfg.exf_bulk is not None else BULK
    ly04 = cfg.exf_ly04
    useAtmWind = cfg.exf_useAtmWind
    maskC0 = grid.maskC[cfg.ksurf0]
    atemp, aqh = forc.atemp, forc.aqh
    uwind, vwind = forc.uwind, forc.vwind

    # --- EXF_RADIATION ---
    Tsf = theta1 + B["cen2kel"]
    TsfSq = Tsf * Tsf
    lwflux = (B["ocean_emissivity"] * B["stefanBoltzmann"] * TsfSq * TsfSq
              - forc.lwdown * B["ocean_emissivity"])
    swflux = -forc.swdown * (1.0 - B["exf_albedo"])

    # --- EXF_WIND ---
    if useAtmWind:
        wsSq = uwind * uwind + vwind * vwind
        wspeed = jnp.sqrt(wsSq)
        solve4Stress = True
    else:
        # wind stress from files; wspeed must come from its own file for
        # the LY04 stability iteration (exf_bulkformulae.F:193-199)
        wspeed = forc.wspeed
        solve4Stress = ly04 and forc.wspeed is not None
        if not solve4Stress:
            raise NotImplementedError(
                "useAtmWind=F without a wspeed file (wStress-only bulk)")
    sh = jnp.maximum(wspeed, B["umin"])

    # --- EXF_BULKFORMULAE ---
    zwln = np.log(B["hu"] / B["zref"])
    ztln = np.log(B["ht"] / B["zref"])
    czol = B["hu"] * B["karman"] * B["gravity_mks"]
    active = atemp != 0.0
    tmpbulk = B["cvapor_fac"] * jnp.exp(-B["cvapor_exp"] / Tsf)
    ssq = B["saltsat"] * tmpbulk / B["atmrho"]
    deltap = atemp + B["gamma_blk"] * B["ht"] - Tsf
    if B.get("sstExtrapol", 0.0) != 0.0:
        raise NotImplementedError("sstExtrapol")
    delq = aqh - ssq
    stable0 = 0.5 + jnp.where(deltap >= 0, 0.5, -0.5)
    wsm = sh
    cdn = B["exf_scal_BulkCdn"] * (B["cdrag_1"] / wsm + B["cdrag_2"]
                                   + B["cdrag_3"] * wsm)
    rdn = jnp.sqrt(cdn)
    ustar = rdn * wsm
    rhn0 = (1.0 - stable0) * B["cstanton_1"] + stable0 * B["cstanton_2"]
    tstar = rhn0 * deltap
    qstar = B["cdalton"] * delq
    rd = rdn
    tau = jnp.zeros_like(ustar)
    for _ in range(B["niter_bulk"]):
        t0 = atemp * (1.0 + B["humid_fac"] * aqh)
        huol = (tstar / t0 + qstar / (1.0 / B["humid_fac"] + aqh)) \
            * czol / jnp.maximum(ustar * ustar, 1e-30)
        if ly04:
            huol = jnp.sign(huol) * jnp.minimum(jnp.abs(huol), 10.0)
        else:
            huol = jnp.maximum(huol, B["zolmin"])
        htol = huol * B["ht"] / B["hu"]
        stable = 0.5 + jnp.where(huol >= 0, 0.5, -0.5)
        if ly04:
            xsq = jnp.sqrt(jnp.abs(1.0 - 16.0 * huol))
        else:
            xsq = jnp.maximum(jnp.sqrt(jnp.abs(1.0 - 16.0 * huol)), 1.0)
        x = jnp.sqrt(xsq)
        psimh = (-B["psim_fac"] * huol * stable
                 + (1.0 - stable)
                 * (jnp.log((1.0 + 2.0 * x + xsq) * (1.0 + xsq) * 0.125)
                    - 2.0 * jnp.arctan(x) + 0.5 * np.pi))
        if ly04:
            xsq = jnp.sqrt(jnp.abs(1.0 - 16.0 * htol))
        else:
            xsq = jnp.maximum(jnp.sqrt(jnp.abs(1.0 - 16.0 * htol)), 1.0)
        psixh = (-B["psim_fac"] * htol * stable
                 + (1.0 - stable) * (2.0 * jnp.log(0.5 * (1.0 + xsq))))
        if ly04:
            dzTmp = (zwln - psimh) / B["karman"]
            usn = wspeed / (1.0 + rdn * dzTmp)
        else:
            usn = sh / (1.0 - rdn / B["karman"] * psimh)
        usm = jnp.maximum(usn, B["umin"])
        cdn = B["exf_scal_BulkCdn"] * (B["cdrag_1"] / usm + B["cdrag_2"]
                                       + B["cdrag_3"] * usm)
        rdn = jnp.sqrt(cdn)
        if ly04:
            rd = rdn / (1.0 + rdn * dzTmp)
        else:
            rd = rdn / (1.0 - rdn / B["karman"] * psimh)
        ustar = rd * sh
        tau = B["atmrho"] * rd * wspeed
        rhn = (1.0 - stable) * B["cstanton_1"] + stable * B["cstanton_2"]
        rh = rhn / (1.0 + rhn * (ztln - psixh) / B["karman"])
        re = B["cdalton"] / (1.0 + B["cdalton"] * (ztln - psixh)
                             / B["karman"])
        qstar = re * delq
        tstar = rh * deltap
    hs = B["atmcp"] * tau * tstar
    hl = B["flamb"] * tau * qstar
    evap = -(1.0 / cfg.rhoConstFresh) * tau * qstar
    if useAtmWind:
        ustress = tau * rd * uwind
        vstress = tau * rd * vwind
    else:
        # stresses are input fields, passed through (exf_bulkformulae.F
        # only computes them when useAtmWind)
        ustress = forc.fu
        vstress = forc.fv
    # zero where no atmospheric data (exf_bulkformulae.F:268-280)
    hs = jnp.where(active, hs, 0.0)
    hl = jnp.where(active, hl, 0.0)
    evap = jnp.where(active, evap, 0.0)
    if useAtmWind:
        ustress = jnp.where(active, ustress, 0.0)
        vstress = jnp.where(active, vstress, 0.0)

    # --- exf_getforcing.F flux assembly ---
    hflux = -hs - hl + lwflux            # SHORTWAVE_HEATING: sw separate
    sflux = evap - forc.precip - forc.runoff
    hflux = hflux * maskC0
    sflux = sflux * maskC0
    # SHORTWAVE_HEATING: hflux += swflux after getsurfacefluxes
    hflux = hflux + swflux

    # --- exf_mapfields.F ---
    Qnet = hflux
    # energy content of runoff (exf_mapfields.F:199-209, runoftempfile)
    if cfg.exf_runoftemp:
        Qnet = Qnet + (cfg.HeatCapacity_Cp
                       * (theta1 - forc.runoftemp)
                       * forc.runoff * cfg.rhoConstFresh)
    EmPmR = sflux * cfg.rhoConstFresh
    Qsw = swflux
    if cfg.exf_stressCgrid:
        # stress already at U/V points (exf_mapfields.F stressIsOnCgrid)
        fu, fv = ustress, vstress
    else:
        fu = 0.5 * (ustress + sh_shift(ustress, di=-1)) \
            * grid.maskW[cfg.ksurf0]
        fv = 0.5 * (vstress + sh_shift(vstress, dj=-1)) \
            * grid.maskS[cfg.ksurf0]
    return dict(fu=fu, fv=fv, Qnet=Qnet, Qsw=Qsw, EmPmR=EmPmR,
                hs=hs, hl=hl, evap=evap, wspeed=wspeed,
                ustress=ustress, vstress=vstress, lwflux=lwflux,
                swflux=swflux, hflux=hflux, sflux=sflux)


from mitgcm_tpu.ops.stencil import shift as sh_shift  # noqa: E402
