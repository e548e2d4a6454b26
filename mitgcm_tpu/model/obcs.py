"""Open boundary conditions (pkg/obcs replacement).

Reference anatomy:
  obcs_readparms.F   OBCS_PARM01/02/03 namelists (OB location index lists,
                     prescribe/Orlanski/sponge selectors, per-side files)
  obcs_init_fixed.F  interior mask (OBCS_insideMask) + maskInC/W/S edits
  obcs_calc.F        boundary values at future time (default: 0 / tRef)
  obcs_apply_uv.F    overwrite u,v at the OB rows/columns
  obcs_apply_ts.F    overwrite theta,salt at the OB cells
  obcs_apply_eta.F   overwrite etaH at the OB cells (nonlinFreeSurf)
  obcs_apply_w.F     overwrite wVel at the OB cells (non-hydrostatic)
  obcs_apply_surf_dr.F  surface-hFac at the OB edges (nonlinFreeSurf)
  obcs_u1_adv_tracer.F  1st-order-upwind advective flux across the OB
  obcs_prescribe_read.F / obcs_fields_load.F  record streaming from files

Realization: the per-row/column OB index lists become static
one-hot 2-D scatter masks precomputed on the host (numpy), so every apply
is a fused `where` inside the jitted step — no gather/scatter ops, no
boundary loops.  Boundary values live in OBFields, a pytree of per-side
[nr, n_along] arrays carried through the step function.

Array convention: padded arrays [.., ny+2*oly, nx+2*olx]; OB index arrays
are 0-based into the padded frame; -1 = no boundary on that row/column
(reference OB_indexNone).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

OB_NONE = -1


@dataclass
class OBCSParams:
    """Parsed data.obcs (obcs_readparms.F)."""
    # 0-based padded indices per padded column/row; -1 = none
    ob_jn: np.ndarray = None        # [nxp] northern OB cell row
    ob_js: np.ndarray = None        # [nxp]
    ob_ie: np.ndarray = None        # [nyp] eastern OB cell column
    ob_iw: np.ndarray = None        # [nyp]
    useOBCSprescribe: bool = False
    useOBCSsponge: bool = False
    useOBCSbalance: bool = False
    OBCSfixTopo: bool = False
    uvApplyFac: float = 1.0
    u1_adv_T: int = 0
    u1_adv_S: int = 0
    # sponge (OBCS_PARM03)
    spongeThickness: int = 0
    Urelaxobcsinner: float = 0.0
    Urelaxobcsbound: float = 0.0
    Vrelaxobcsinner: float = 0.0
    Vrelaxobcsbound: float = 0.0
    files: Dict[str, str] = field(default_factory=dict)  # e.g. "OBWu"->path
    extra: Dict[str, Any] = field(default_factory=dict)


class OBFields(NamedTuple):
    """Boundary values at one time level (OBCS_FIELDS.h).

    N/S arrays: [nr, nxp] (+ eta [nxp]); E/W arrays: [nr, nyp]."""
    OBNu: jnp.ndarray; OBNv: jnp.ndarray; OBNt: jnp.ndarray
    OBNs: jnp.ndarray; OBNw: jnp.ndarray; OBNeta: jnp.ndarray
    OBSu: jnp.ndarray; OBSv: jnp.ndarray; OBSt: jnp.ndarray
    OBSs: jnp.ndarray; OBSw: jnp.ndarray; OBSeta: jnp.ndarray
    OBEu: jnp.ndarray; OBEv: jnp.ndarray; OBEt: jnp.ndarray
    OBEs: jnp.ndarray; OBEw: jnp.ndarray; OBEeta: jnp.ndarray
    OBWu: jnp.ndarray; OBWv: jnp.ndarray; OBWt: jnp.ndarray
    OBWs: jnp.ndarray; OBWw: jnp.ndarray; OBWeta: jnp.ndarray
    # passive-tracer boundary values (OBCS_PTRACERS.h OB[NSEW]ptr):
    # [nptr, nr, n_along]; zero-size when no ptracers
    OBNptr: jnp.ndarray = None; OBSptr: jnp.ndarray = None
    OBEptr: jnp.ndarray = None; OBWptr: jnp.ndarray = None


def parse_data_obcs(path: str, cfg) -> OBCSParams:
    """obcs_readparms.F: OBCS_PARM01 (+02 Orlanski, +03 sponge)."""
    from mitgcm_tpu.core import nml
    groups = nml.read_namelist(path)
    p1 = {k.lower(): v for k, v in groups.get("OBCS_PARM01", {}).items()}
    p3 = {k.lower(): v for k, v in groups.get("OBCS_PARM03", {}).items()}
    pp = OBCSParams()
    nx, ny, olx, oly = cfg.nx, cfg.ny, cfg.olx, cfg.oly
    nxp, nyp = nx + 2 * olx, ny + 2 * oly

    def idx_array(key, n_along, n_across, pad_along):
        """Fortran 1-based (negative = from far end, readparms.F:669-677)
        -> 0-based padded; cyclically extended into halo rows/columns
        (the EXCH + overlap-index logic of obcs_init_fixed.F:167-280
        reduces to a periodic wrap for the single-tile topology)."""
        vals = p1.pop(key, None)
        out = np.full(n_along + 2 * pad_along, OB_NONE, np.int64)
        if vals is None:
            return out
        arr = np.asarray(vals, np.int64).ravel()
        if arr.size < n_along:
            arr = np.concatenate(
                [arr, np.full(n_along - arr.size, 0, np.int64)])
        arr = arr[:n_along]
        neg = arr < 0
        arr = np.where(neg, arr + n_across + 1, arr)
        pad_across = oly if pad_along == olx else olx
        interior = np.where(arr == 0, OB_NONE, arr - 1 + pad_across)
        # cyclic halo extension (covers halos wider than the interior)
        pos = (np.arange(-pad_along, n_along + pad_along)) % n_along
        return interior[pos]

    pp.ob_jn = idx_array("ob_jnorth", nx, ny, olx)
    pp.ob_js = idx_array("ob_jsouth", nx, ny, olx)
    pp.ob_ie = idx_array("ob_ieast", ny, nx, oly)
    pp.ob_iw = idx_array("ob_iwest", ny, nx, oly)
    # single-position shorthands (OB_singleJnorth etc.)
    for key, tgt, n_across, pad in (
            ("ob_singlejnorth", "ob_jn", ny, oly),
            ("ob_singlejsouth", "ob_js", ny, oly),
            ("ob_singleieast", "ob_ie", nx, olx),
            ("ob_singleiwest", "ob_iw", nx, olx)):
        if key in p1:
            v = int(p1.pop(key))
            if v < 0:
                v = v + n_across + 1
            getattr(pp, tgt)[:] = (OB_NONE if v == 0 else v - 1 + pad)

    pp.useOBCSprescribe = bool(p1.pop("useobcsprescribe", False))
    pp.useOBCSsponge = bool(p1.pop("useobcssponge", False))
    pp.useOBCSbalance = bool(p1.pop("useobcsbalance", False))
    pp.OBCSfixTopo = bool(p1.pop("obcsfixtopo", False))
    pp.uvApplyFac = float(p1.pop("obcs_uvapplyfac", 1.0))
    pp.u1_adv_T = int(p1.pop("obcs_u1_adv_t", 0))
    pp.u1_adv_S = int(p1.pop("obcs_u1_adv_s", 0))
    if pp.spongeThickness == 0:
        pp.spongeThickness = int(p3.pop("spongethickness", 0))
    for k in ("urelaxobcsinner", "urelaxobcsbound",
              "vrelaxobcsinner", "vrelaxobcsbound"):
        if k in p3:
            setattr(pp, k[0].upper() + k[1:], float(p3.pop(k)))
    for want in ("useorlanskinorth", "useorlanskisouth", "useorlanskieast",
                 "useorlanskiwest", "usestevensnorth", "usestevenssouth",
                 "usestevenseast", "usestevenswest"):
        if p1.pop(want, False):
            raise NotImplementedError(f"OBCS: {want} not implemented yet")
    # per-side boundary-value files
    for k in list(p1):
        if k.startswith("ob") and k.endswith("file"):
            name = k[:-4]            # e.g. "obwu"
            pp.files[name] = str(p1.pop(k))
        elif k.startswith("ob") and "ptrfile(" in k:
            itr = int(k.split("(")[1].rstrip(")"))
            pp.files[k.split("file")[0] + str(itr)] = str(p1.pop(k))
    # ignorable run-time chatter
    for k in ("obcs_monitorfreq", "obcs_monselect", "obcsprintdiags"):
        p1.pop(k, None)
    pp.extra = {**p1, **{k: v for k, v in p3.items()}}
    return pp


# ---------------------------------------------------------------------------
# obcs_init_fixed.F: interior mask + maskIn edits (host-side numpy)
# ---------------------------------------------------------------------------

def build_masks(cfg, pp: OBCSParams, kSurfC, maskInC, maskInW, maskInS):
    """Port of obcs_init_fixed.F:62-383 for the single-tile topology.

    Takes/returns numpy padded arrays; the caller folds the results into
    Grid.maskInC/W/S (and hence into cg2d, gad, correction_step)."""
    nx, ny, olx, oly = cfg.nx, cfg.ny, cfg.olx, cfg.oly
    nyp, nxp = maskInC.shape
    nr = cfg.nr
    inside = np.ones((nyp, nxp))
    wet = (np.asarray(kSurfC) <= nr)

    # -- interior mask from OB indices (obcs_init_fixed.F:77-122)
    for j in range(oly, oly + ny):
        ie = pp.ob_ie[j]
        if ie != OB_NONE:
            flag = True
            for i in range(ie, olx + nx):
                flag = flag and wet[j, i] and i != pp.ob_iw[j]
                if flag:
                    inside[j, i] = 0.0
        iw = pp.ob_iw[j]
        if iw != OB_NONE:
            flag = True
            for i in range(iw, olx - 1, -1):
                flag = flag and wet[j, i] and i != pp.ob_ie[j]
                if flag:
                    inside[j, i] = 0.0
    for i in range(olx, olx + nx):
        jn = pp.ob_jn[i]
        if jn != OB_NONE:
            flag = True
            for j in range(jn, oly + ny):
                flag = flag and wet[j, i] and j != pp.ob_js[i]
                if flag:
                    inside[j, i] = 0.0
        js = pp.ob_js[i]
        if js != OB_NONE:
            flag = True
            for j in range(js, oly - 1, -1):
                flag = flag and wet[j, i] and j != pp.ob_jn[i]
                if flag:
                    inside[j, i] = 0.0

    # EXCH (cyclic wrap of the interior into the halo; _cyc strips the
    # halo itself and rebuilds it from the interior)
    from mitgcm_tpu.core.grid import _cyc
    inside = _cyc(inside, oly, olx)

    # -- maskInW/S: leave the OB normal-velocity edge inside
    # (obcs_init_fixed.F:150-163, MAX of the two adjacent cells)
    maskInW = maskInW.copy()
    maskInS = maskInS.copy()
    maskInW[:, 1:] = maskInW[:, 1:] * np.maximum(inside[:, :-1],
                                                 inside[:, 1:])
    maskInS[1:, :] = maskInS[1:, :] * np.maximum(inside[:-1, :],
                                                 inside[1:, :])

    # -- zero the masks beyond the OB over the full overlap width
    # (obcs_init_fixed.F:284-379, OB_ApplX/Y = OLx/OLy)
    cols = np.arange(nxp)[None, :]
    rows = np.arange(nyp)[:, None]
    ie = pp.ob_ie[:, None]          # [nyp, 1]
    iw = pp.ob_iw[:, None]
    jn = pp.ob_jn[None, :]          # [1, nxp]
    js = pp.ob_js[None, :]

    def band(idx, lo_off, hi_off, axis_pos):
        has = idx != OB_NONE
        return has & (axis_pos >= idx + lo_off) & (axis_pos <= idx + hi_off)

    inside[band(ie, 0, olx - 1, cols)] = 0.0
    maskInW[band(ie, 1, olx - 1, cols)] = 0.0
    iem = np.roll(pp.ob_ie, 1)[:, None]     # OB_Ie(j-1)
    both = (ie != OB_NONE) & (iem != OB_NONE)
    ie2 = np.maximum(ie, iem)
    maskInS[both & (cols >= ie2) & (cols <= ie2 + olx - 1)] = 0.0

    inside[band(iw, 1 - olx, 0, cols)] = 0.0
    maskInW[band(iw, 2 - olx, 0, cols)] = 0.0
    iwm = np.roll(pp.ob_iw, 1)[:, None]
    both = (iw != OB_NONE) & (iwm != OB_NONE)
    iw2 = np.minimum(iw, iwm)
    maskInS[both & (cols >= iw2 - olx + 1) & (cols <= iw2)] = 0.0

    inside[band(jn, 0, oly - 1, rows)] = 0.0
    maskInS[band(jn, 1, oly - 1, rows)] = 0.0
    jnm = np.roll(pp.ob_jn, 1)[None, :]     # OB_Jn(i-1)
    both = (jn != OB_NONE) & (jnm != OB_NONE)
    jn2 = np.maximum(jn, jnm)
    maskInW[both & (rows >= jn2) & (rows <= jn2 + oly - 1)] = 0.0

    inside[band(js, 1 - oly, 0, rows)] = 0.0
    maskInS[band(js, 2 - oly, 0, rows)] = 0.0
    jsm = np.roll(pp.ob_js, 1)[None, :]
    both = (js != OB_NONE) & (jsm != OB_NONE)
    js2 = np.minimum(js, jsm)
    maskInW[both & (rows >= js2 - oly + 1) & (rows <= js2)] = 0.0

    maskInC = maskInC * inside
    return inside, maskInC, maskInW, maskInS


# ---------------------------------------------------------------------------
# Static scatter masks + gathered wet masks for the apply routines
# ---------------------------------------------------------------------------

class OBCSMasks(NamedTuple):
    """Precomputed one-hot scatter masks (float 2-D [nyp, nxp]) and
    per-boundary gathered wet masks ([nr, n_along])."""
    mN: jnp.ndarray; mNp1: jnp.ndarray
    mS: jnp.ndarray; mSp1: jnp.ndarray
    mE: jnp.ndarray; mEp1: jnp.ndarray
    mW: jnp.ndarray; mWp1: jnp.ndarray
    mNm1: jnp.ndarray          # one-hot at jn-1 (ptracer zero-gradient)
    mEm1: jnp.ndarray          # one-hot at ie-1
    maskW_N: jnp.ndarray   # maskW at (jn, i)       [nr, nxp]
    maskS_N: jnp.ndarray   # maskS at (jn, i)
    maskW_S: jnp.ndarray   # maskW at (js, i)
    maskS_Sp1: jnp.ndarray  # maskS at (js+1, i)
    maskS_E: jnp.ndarray   # maskS at (j, ie)       [nr, nyp]
    maskW_E: jnp.ndarray   # maskW at (j, ie)
    maskS_W: jnp.ndarray   # maskS at (j, iw)
    maskW_Wp1: jnp.ndarray  # maskW at (j, iw+1)
    wetS_N: jnp.ndarray    # kSurfS(i,jn)<=Nr       [nxp]
    wetS_Sp1: jnp.ndarray  # kSurfS(i,js+1)<=Nr
    wetW_E: jnp.ndarray    # kSurfW(ie,j)<=Nr       [nyp]
    wetW_Wp1: jnp.ndarray  # kSurfW(iw+1,j)<=Nr
    has_any: bool


def build_apply_masks(cfg, pp: OBCSParams, grid) -> OBCSMasks:
    nyp, nxp = np.asarray(grid.rA).shape
    nr = cfg.nr
    maskW = np.asarray(grid.maskW)
    maskS = np.asarray(grid.maskS)
    kSurfW = np.asarray(grid.kSurfW)
    kSurfS = np.asarray(grid.kSurfS)
    rows = np.arange(nyp)[:, None]
    cols = np.arange(nxp)[None, :]

    def onehot_row(idx, off=0):   # N/S: mask[j,i] = j == idx[i]+off
        t = np.where(idx[None, :] == OB_NONE, -10**6, idx[None, :] + off)
        return (rows == t).astype(np.float64)

    def onehot_col(idx, off=0):   # E/W: mask[j,i] = i == idx[j]+off
        t = np.where(idx[:, None] == OB_NONE, -10**6, idx[:, None] + off)
        return (cols == t).astype(np.float64)

    def gather_row(a3, idx, off=0):   # a3[k, idx[i]+off, i] -> [nr, nxp]
        j = np.clip(np.where(idx == OB_NONE, 0, idx + off), 0, nyp - 1)
        out = a3[:, j, np.arange(nxp)]
        return np.where(idx[None, :] == OB_NONE, 0.0, out)

    def gather_col(a3, idx, off=0):   # a3[k, j, idx[j]+off] -> [nr, nyp]
        i = np.clip(np.where(idx == OB_NONE, 0, idx + off), 0, nxp - 1)
        out = a3[:, np.arange(nyp), i]
        return np.where(idx[None, :] == OB_NONE, 0.0, out)

    J = jnp.asarray
    dt = grid.rA.dtype
    jn, js, ie, iw = pp.ob_jn, pp.ob_js, pp.ob_ie, pp.ob_iw
    return OBCSMasks(
        mN=J(onehot_row(jn), dtype=dt), mNp1=J(onehot_row(jn, 1), dtype=dt),
        mS=J(onehot_row(js), dtype=dt), mSp1=J(onehot_row(js, 1), dtype=dt),
        mE=J(onehot_col(ie), dtype=dt), mEp1=J(onehot_col(ie, 1), dtype=dt),
        mW=J(onehot_col(iw), dtype=dt), mWp1=J(onehot_col(iw, 1), dtype=dt),
        mNm1=J(onehot_row(jn, -1), dtype=dt),
        mEm1=J(onehot_col(ie, -1), dtype=dt),
        maskW_N=J(gather_row(maskW, jn), dtype=dt),
        maskS_N=J(gather_row(maskS, jn), dtype=dt),
        maskW_S=J(gather_row(maskW, js), dtype=dt),
        maskS_Sp1=J(gather_row(maskS, js, 1), dtype=dt),
        maskS_E=J(gather_col(maskS, ie), dtype=dt),
        maskW_E=J(gather_col(maskW, ie), dtype=dt),
        maskS_W=J(gather_col(maskS, iw), dtype=dt),
        maskW_Wp1=J(gather_col(maskW, iw, 1), dtype=dt),
        wetS_N=J(gather_row(kSurfS[None], jn)[0] <= nr, dtype=dt)
        if kSurfS.ndim == 2 else J(np.zeros(nxp), dtype=dt),
        wetS_Sp1=J(gather_row(kSurfS[None], js, 1)[0] <= nr, dtype=dt)
        if kSurfS.ndim == 2 else J(np.zeros(nxp), dtype=dt),
        wetW_E=J(gather_col(kSurfW[None], ie)[0] <= nr, dtype=dt)
        if kSurfW.ndim == 2 else J(np.zeros(nyp), dtype=dt),
        wetW_Wp1=J(gather_col(kSurfW[None], iw, 1)[0] <= nr, dtype=dt)
        if kSurfW.ndim == 2 else J(np.zeros(nyp), dtype=dt),
        has_any=bool((jn != OB_NONE).any() or (js != OB_NONE).any()
                     or (ie != OB_NONE).any() or (iw != OB_NONE).any()),
    )


# ---------------------------------------------------------------------------
# obcs_calc.F
# ---------------------------------------------------------------------------

def default_fields(cfg, pp: OBCSParams, dtype, m=None,
                   pTr=None) -> OBFields:
    """obcs_calc.F default: u=v=w=0, t=tRef(k), s=sRef(k), eta=0;
    passive tracers default to the zero-gradient interior-adjacent value
    (obcs_calc.F OB?ptr blocks) which needs the masks m and pTr."""
    nxp = pp.ob_jn.shape[0]
    nyp = pp.ob_ie.shape[0]
    nr = cfg.nr
    tRef = jnp.asarray(cfg.tRef, dtype)[:, None]
    sRef = jnp.asarray(cfg.sRef, dtype)[:, None]
    zx = jnp.zeros((nr, nxp), dtype)
    zy = jnp.zeros((nr, nyp), dtype)
    nptr = 0 if pTr is None else pTr.shape[0]
    if nptr and m is not None:
        # OBNptr = pTr(i, jn-1)*maskS(i, jn); OBSptr = pTr(i, js+1)
        # *maskS(i, js+1); OBEptr = pTr(ie-1, j)*maskW(ie, j);
        # OBWptr = pTr(iw+1, j)*maskW(iw+1, j)
        # full-precision products: a GPU runs f32 einsums in TF32 unless
        # told otherwise
        pick = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
        pN = pick("tkji,ji->tki", pTr, m.mNm1) * m.maskS_N[None]
        pS = pick("tkji,ji->tki", pTr, m.mSp1) * m.maskS_Sp1[None]
        pE = pick("tkji,ji->tkj", pTr, m.mEm1) * m.maskW_E[None]
        pW = pick("tkji,ji->tkj", pTr, m.mWp1) * m.maskW_Wp1[None]
    else:
        pN = pS = jnp.zeros((nptr, nr, nxp), dtype)
        pE = pW = jnp.zeros((nptr, nr, nyp), dtype)
    return OBFields(
        OBNu=zx, OBNv=zx, OBNt=zx + tRef, OBNs=zx + sRef, OBNw=zx,
        OBNeta=jnp.zeros(nxp, dtype),
        OBSu=zx, OBSv=zx, OBSt=zx + tRef, OBSs=zx + sRef, OBSw=zx,
        OBSeta=jnp.zeros(nxp, dtype),
        OBEu=zy, OBEv=zy, OBEt=zy + tRef, OBEs=zy + sRef, OBEw=zy,
        OBEeta=jnp.zeros(nyp, dtype),
        OBWu=zy, OBWv=zy, OBWt=zy + tRef, OBWs=zy + sRef, OBWw=zy,
        OBWeta=jnp.zeros(nyp, dtype),
        OBNptr=pN, OBSptr=pS, OBEptr=pE, OBWptr=pW,
    )


def calc_fields(cfg, grid, pp: OBCSParams, state, future_time, future_iter,
                prescribed=None, m=None) -> OBFields:
    """OBCS_CALC at t=futureTime (do_oceanic_phys.F:317 passes
    myTime+deltaTClock, myIter+1).  Resolution order: defaults ->
    custom analytic hook (experiment code/obcs_calc.F override) ->
    prescribed file records (useOBCSprescribe)."""
    ob = default_fields(cfg, pp, grid.rA.dtype, m=m, pTr=state.pTr)
    custom = getattr(cfg, "custom_obcs_calc", None)
    if custom is not None:
        ob = custom(cfg, grid, pp, ob, state, future_time, future_iter)
    if prescribed is not None:
        ob = prescribed.interp(ob, future_time, future_iter)
    return ob


# ---------------------------------------------------------------------------
# apply routines (pure jnp; write order mirrors the Fortran overwrites)
# ---------------------------------------------------------------------------

def _brow(val):
    """[nr, nxp] boundary value -> broadcastable [nr, 1, nxp]."""
    return val[:, None, :]


def _bcol(val):
    """[nr, nyp] boundary value -> broadcastable [nr, nyp, 1]."""
    return val[:, :, None]


def apply_uv(cfg, m: OBCSMasks, pp: OBCSParams, ob: OBFields, u, v):
    """obcs_apply_uv.F: tangential components first, then normal (the
    normal write wins at cells claimed by two boundaries)."""
    fac = pp.uvApplyFac
    # tangential
    u = u * (1 - m.mN) + m.mN * _brow(ob.OBNu * m.maskW_N)
    u = u * (1 - m.mS) + m.mS * _brow(ob.OBSu * m.maskW_S)
    v = v * (1 - m.mE) + m.mE * _bcol(ob.OBEv * m.maskS_E)
    v = v * (1 - m.mW) + m.mW * _bcol(ob.OBWv * m.maskS_W)
    # normal
    v = v * (1 - m.mN) + m.mN * _brow(ob.OBNv * m.maskS_N)
    v = v * (1 - m.mNp1) + m.mNp1 * _brow(ob.OBNv * m.maskS_N * fac)
    v = v * (1 - m.mSp1) + m.mSp1 * _brow(ob.OBSv * m.maskS_Sp1)
    v = v * (1 - m.mS) + m.mS * _brow(ob.OBSv * m.maskS_Sp1 * fac)
    u = u * (1 - m.mE) + m.mE * _bcol(ob.OBEu * m.maskW_E)
    u = u * (1 - m.mEp1) + m.mEp1 * _bcol(ob.OBEu * m.maskW_E * fac)
    u = u * (1 - m.mWp1) + m.mWp1 * _bcol(ob.OBWu * m.maskW_Wp1)
    u = u * (1 - m.mW) + m.mW * _bcol(ob.OBWu * m.maskW_Wp1 * fac)
    return u, v


def apply_ts(cfg, m: OBCSMasks, ob: OBFields, t, s):
    """obcs_apply_ts.F (non-Stevens branch): plain overwrite at OB cell."""
    t = t * (1 - m.mN) + m.mN * _brow(ob.OBNt)
    s = s * (1 - m.mN) + m.mN * _brow(ob.OBNs)
    t = t * (1 - m.mS) + m.mS * _brow(ob.OBSt)
    s = s * (1 - m.mS) + m.mS * _brow(ob.OBSs)
    t = t * (1 - m.mE) + m.mE * _bcol(ob.OBEt)
    s = s * (1 - m.mE) + m.mE * _bcol(ob.OBEs)
    t = t * (1 - m.mW) + m.mW * _bcol(ob.OBWt)
    s = s * (1 - m.mW) + m.mW * _bcol(ob.OBWs)
    return t, s


def apply_eta(cfg, m: OBCSMasks, ob: OBFields, eta):
    """obcs_apply_eta.F: overwrite etaFld at the OB cell where the OB
    edge is wet (kSurfS/W tests)."""
    eta = eta * (1 - m.mN * m.wetS_N[None, :]) \
        + m.mN * (m.wetS_N * ob.OBNeta)[None, :]
    eta = eta * (1 - m.mS * m.wetS_Sp1[None, :]) \
        + m.mS * (m.wetS_Sp1 * ob.OBSeta)[None, :]
    eta = eta * (1 - m.mE * m.wetW_E[:, None]) \
        + m.mE * (m.wetW_E * ob.OBEeta)[:, None]
    eta = eta * (1 - m.mW * m.wetW_Wp1[:, None]) \
        + m.mW * (m.wetW_Wp1 * ob.OBWeta)[:, None]
    return eta


def apply_w(cfg, m: OBCSMasks, ob: OBFields, w, maskC):
    """obcs_apply_w.F (non-hydrostatic): overwrite wVel at the OB cell
    with OB*w * maskC(k)*maskC(k-1) (the W-point wet mask)."""
    mk = maskC * jnp.concatenate([maskC[:1], maskC[:-1]], axis=0)
    w = w * (1 - m.mN) + m.mN * mk * _brow(ob.OBNw)
    w = w * (1 - m.mS) + m.mS * mk * _brow(ob.OBSw)
    w = w * (1 - m.mE) + m.mE * mk * _bcol(ob.OBEw)
    w = w * (1 - m.mW) + m.mW * mk * _bcol(ob.OBWw)
    return w


def apply_ptracer(cfg, m: OBCSMasks, obptr_n, obptr_s, obptr_e, obptr_w,
                  ptr):
    """obcs_apply_ptracer.F: overwrite one passive tracer at the OB."""
    ptr = ptr * (1 - m.mN) + m.mN * _brow(obptr_n)
    ptr = ptr * (1 - m.mS) + m.mS * _brow(obptr_s)
    ptr = ptr * (1 - m.mE) + m.mE * _bcol(obptr_e)
    ptr = ptr * (1 - m.mW) + m.mW * _bcol(obptr_w)
    return ptr


def apply_all_ptracers(cfg, m: OBCSMasks, ob: OBFields, pTr):
    """obcs_apply_ptracer.F over the full [nptr,...] stack."""
    out = []
    for itr in range(pTr.shape[0]):
        out.append(apply_ptracer(cfg, m, ob.OBNptr[itr], ob.OBSptr[itr],
                                 ob.OBEptr[itr], ob.OBWptr[itr], pTr[itr]))
    return jnp.stack(out) if out else pTr


def ptracer_neumann(cfg, m: OBCSMasks, pp: OBCSParams, grid, ptr):
    """obcs_calc.F pTracers default: near-v.Neumann condition — boundary
    value = previous-step tracer one cell inside the OB, times the wet
    mask of the OB edge. Returns per-side [nr, n_along] arrays."""
    nyp, nxp = ptr.shape[-2:]
    # gather tracer one cell inside the OB (host-precomputed indices)
    jn = jnp.asarray(np.clip(np.where(pp.ob_jn == OB_NONE, 0, pp.ob_jn - 1),
                             0, nyp - 1))
    js = jnp.asarray(np.clip(np.where(pp.ob_js == OB_NONE, 0, pp.ob_js + 1),
                             0, nyp - 1))
    ie = jnp.asarray(np.clip(np.where(pp.ob_ie == OB_NONE, 0, pp.ob_ie - 1),
                             0, nxp - 1))
    iw = jnp.asarray(np.clip(np.where(pp.ob_iw == OB_NONE, 0, pp.ob_iw + 1),
                             0, nxp - 1))
    cols = jnp.arange(nxp)
    rows = jnp.arange(nyp)
    tN = ptr[:, jn, cols] * m.maskS_N
    tS = ptr[:, js, cols] * m.maskS_Sp1
    tE = ptr[:, rows, ie] * m.maskW_E
    tW = ptr[:, rows, iw] * m.maskW_Wp1
    return tN, tS, tE, tW


def u1_flux_x(cfg, m_use, maskInC, uTrans, tracer, af, maskLoc, mode):
    """obcs_u1_adv_tracer.F X-direction: replace the scheme's advective
    flux with 1st-order upwind at faces crossing the OB."""
    from mitgcm_tpu.ops.stencil import shift as sh
    inC = maskInC
    inCm = sh(maskInC, di=-1)
    uAbs = jnp.abs(uTrans)
    up1 = ((uTrans + uAbs) * 0.5 * sh(tracer, di=-1)
           + (uTrans - uAbs) * 0.5 * tracer)
    if mode == 1:    # only outflow
        sel = (uTrans * maskLoc * (inCm - inC)) > 0.0
    else:            # inflow & outflow
        sel = (maskLoc == 1.0) & (inCm != inC)
    return jnp.where(sel, up1, af)


def u1_flux_y(cfg, m_use, maskInC, vTrans, tracer, af, maskLoc, mode):
    from mitgcm_tpu.ops.stencil import shift as sh
    inC = maskInC
    inCm = sh(maskInC, dj=-1)
    vAbs = jnp.abs(vTrans)
    up1 = ((vTrans + vAbs) * 0.5 * sh(tracer, dj=-1)
           + (vTrans - vAbs) * 0.5 * tracer)
    if mode == 1:
        sel = (vTrans * maskLoc * (inCm - inC)) > 0.0
    else:
        sel = (maskLoc == 1.0) & (inCm != inC)
    return jnp.where(sel, up1, af)


# ---------------------------------------------------------------------------
# prescribed boundary records (obcs_prescribe_read.F / obcs_fields_load.F)
# ---------------------------------------------------------------------------

_SIDE_AX = {"n": "x", "s": "x", "e": "y", "w": "y"}
_FLD_MAP = {"u": "u", "v": "v", "t": "t", "s": "s", "w": "w", "eta": "eta"}


class PrescribedOB:
    """Record streams for OB*File boundary data.

    Loads all records up front (host-side) into [nrec, nr, n_along]
    arrays; `interp` does the same two-record linear time interpolation
    as external_fields_load.F (periodicExternalForcing) at trace time."""

    def __init__(self, cfg, pp: OBCSParams, dtype):
        from mitgcm_tpu.io import mds
        self.cfg = cfg
        self.recs: Dict[str, jnp.ndarray] = {}
        nx, ny, olx, oly = cfg.nx, cfg.ny, cfg.olx, cfg.oly
        nr = cfg.nr
        for name, fname in pp.files.items():
            side = name[2]                     # obNu -> n
            fld = name[3:]                     # u/v/t/s/w/eta/a/h/...
            n_along = nx if _SIDE_AX.get(side) == "x" else ny
            path = cfg.find_file(fname)
            if not os.path.exists(path):
                raise FileNotFoundError(f"OBCS file {fname} not found")
            raw = np.fromfile(path, (">f8" if cfg.readBinaryPrec == 64
                                     else ">f4")).astype(np.float64)
            per_rec = n_along * nr
            nrec = raw.size // per_rec
            arr = raw[:nrec * per_rec].reshape(nrec, nr, n_along)
            pad = olx if _SIDE_AX.get(side) == "x" else oly
            padded = np.zeros((nrec, nr, n_along + 2 * pad))
            padded[:, :, pad:pad + n_along] = arr
            self.recs[name] = jnp.asarray(padded, dtype)

    def interp(self, ob: OBFields, future_time, future_iter) -> OBFields:
        cfg = self.cfg
        upd = {}
        ptr_upd = {}
        for name, arr in self.recs.items():
            side = name[2].upper()
            fld = name[3:]
            itr = None
            if fld.startswith("ptr"):
                itr = int(fld[3:]) - 1
                key = f"OB{side}ptr"
            else:
                key = f"OB{side}{fld}"
            if not hasattr(ob, key):
                continue   # ice fields etc. handled by their package
            nrec = arr.shape[0]
            if nrec == 1 or not cfg.periodicExternalForcing:
                val = arr[0]
            else:
                cyc = cfg.externForcingCycle
                per = cfg.externForcingPeriod
                locTime = future_time - per * 0.5 \
                    + cyc * (2 - jnp.round(future_time / cyc))
                tmpTime = jnp.mod(locTime, cyc)
                rec1 = jnp.floor(tmpTime / per).astype(jnp.int32)
                rec2 = jnp.mod(rec1 + 1, nrec)
                w2 = (tmpTime - per * rec1) / per
                val = ((1.0 - w2) * jnp.take(arr, rec1, axis=0)
                       + w2 * jnp.take(arr, rec2, axis=0))
            if itr is None:
                upd[key] = val
            else:
                ptr_upd.setdefault(key, {})[itr] = val
        for key, d in ptr_upd.items():
            stack = getattr(ob, key)
            for itr, val in d.items():
                stack = stack.at[itr].set(val)
            upd[key] = stack
        return ob._replace(**upd)


class OBCS:
    """Runtime hook bundle passed into forward_step (closure constant):
    parsed params, precomputed scatter masks, optional record streams."""

    def __init__(self, cfg, grid, dtype):
        self.pp: OBCSParams = cfg.obcs
        self.masks = build_apply_masks(cfg, self.pp, grid)
        self.prescribed = None
        self.ob0 = None     # startTime OB values (nIter0=0 init apply)
        if self.pp.useOBCSprescribe and self.pp.files:
            self.prescribed = PrescribedOB(cfg, self.pp, dtype)
