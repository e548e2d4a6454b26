"""Generic advection-diffusion: the tracer engine.

Reference: pkg/generic_advdiff — gad_calc_rhs.F (tendency assembly),
gad_c2_adv_*.F / gad_u3_adv_*.F / gad_dst3*_adv_*.F / gad_fluxlimit_adv_*.F
(per-direction flux kernels), model/src/calc_adv_flow.F (transports),
model/src/timestep_tracer.F + impldiff.F (update + implicit vertical).

Scheme numbers follow the reference enum (pkg/generic_advdiff/GAD.h:19-110):
  1 upwind-1st, 2 centered-2nd, 3 upwind-3rd, 4 centered-4th,
  20 DST-2 (Lax-Wendroff), 30 DST-3, 33 DST-3 flux-limited,
  77 non-linear flux limiter (Superbee), 7 OS7MP (later).

All kernels are vectorized over the full 3-D field; the hot x/y flux
passes are single fused elementwise chains, which XLA compiles to one
memory-bandwidth-bound sweep each.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import jax
import numpy as np

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import shift as sh
from mitgcm_tpu.ops.stencil import shift_k

ENUM_UPWIND_1RST = 1
ENUM_CENTERED_2ND = 2
ENUM_UPWIND_3RD = 3
ENUM_CENTERED_4TH = 4
ENUM_DST2 = 20
ENUM_DST3 = 30
ENUM_DST3_FLUX_LIMIT = 33
ENUM_FLUX_LIMIT = 77
ENUM_OS7MP = 7
ENUM_PPM_NULL = 40
ENUM_PPM_MONO = 41
ENUM_PPM_WENO = 42
ENUM_PQM_NULL = 50
ENUM_PQM_MONO = 51
ENUM_PQM_WENO = 52
PPM_SCHEMES = (ENUM_PPM_NULL, ENUM_PPM_MONO, ENUM_PPM_WENO)
PQM_SCHEMES = (ENUM_PQM_NULL, ENUM_PQM_MONO, ENUM_PQM_WENO)

MULTIDIM_SCHEMES = (ENUM_FLUX_LIMIT, ENUM_DST3_FLUX_LIMIT, ENUM_DST2,
                    ENUM_DST3, ENUM_UPWIND_1RST, ENUM_OS7MP) \
    + PPM_SCHEMES + PQM_SCHEMES


class AdvFlow(NamedTuple):
    uTrans: jnp.ndarray    # [nr,...]
    vTrans: jnp.ndarray
    rTrans: jnp.ndarray    # [nr,...] at interface k (surface index 0 = 0)
    rTransKp: jnp.ndarray  # [nr,...] at interface k+1 (bottom = 0)
    maskUp: jnp.ndarray    # [nr,...]
    xA: jnp.ndarray
    yA: jnp.ndarray


def calc_adv_flow(cfg: Config, grid: Grid, u, v, w) -> AdvFlow:
    """model/src/calc_adv_flow.F vectorized over k."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    uTrans = u * xA
    vTrans = v * yA
    mC = grid.maskC
    maskUp = jnp.concatenate(
        [jnp.zeros_like(mC[:1]), mC[1:] * mC[:-1]], axis=0)
    rTrans = w * grid.rA * maskUp
    rTransKp = jnp.concatenate([rTrans[1:], jnp.zeros_like(rTrans[:1])],
                               axis=0)
    return AdvFlow(uTrans=uTrans, vTrans=vTrans, rTrans=rTrans,
                   rTransKp=rTransKp, maskUp=maskUp, xA=xA, yA=yA)


# ----------------------------------------------------------------------
# horizontal advective fluxes: F at the W/S face of cell (i,j)
# ----------------------------------------------------------------------

def _limiter(cr):
    """Superbee limiter (pkg/generic_advdiff/gad_fluxlimit_adv_x.F Limiter)."""
    return jnp.maximum(0.0, jnp.maximum(
        jnp.minimum(1.0, 2.0 * cr), jnp.minimum(2.0, cr)))




_CR_MAX = 1.0e6       # gad_fluxlimit_adv_x.F:63
_THETA_MAX = 1.0e20   # gad_dst3fl_adv_x.F:36


# ----------------------------------------------------------------------
# OS7MP: 7th-order one-step monotonicity-preserving advection
# (gad_os7mp_adv_x/y/r.F).  Shared by ocean tracers (scheme 7) and the
# seaice advection (seaice_advection.F uses the same kernels).
# ----------------------------------------------------------------------

def os7mp_psi(trans, cfl, q_stack, m_stack):
    """One-directional OS7MP flux given upwind-ordered stencils.

    q_stack: tuple (Qippp,Qipp,Qip,Qi,Qim,Qimm,Qimmm);
    m_stack: (MskIpp,MskIp,MskI,MskIm,MskImm,MskImmm)."""
    Eps = 1.0e-20
    Qippp, Qipp, Qip, Qi, Qim, Qimm, Qimmm = q_stack
    MskIpp, MskIp, MskI, MskIm, MskImm, MskImmm = m_stack
    Fac = 1.0
    DelP = (Qip - Qi) * MskI
    Phi = Fac * DelP
    Fac = Fac * (cfl + 1.0) / 3.0
    DelM = (Qi - Qim) * MskIm
    Del2 = DelP - DelM
    Phi = Phi - Fac * Del2
    Fac = Fac * (cfl - 2.0) / 4.0
    DelPP = (Qipp - Qip) * MskIp * MskI
    Del2P = DelPP - DelP
    Del3P = Del2P - Del2
    Phi = Phi + Fac * Del3P
    Fac = Fac * (cfl - 3.0) / 5.0
    DelMM = (Qim - Qimm) * MskImm * MskIm
    Del2M = DelM - DelMM
    Del3M = Del2 - Del2M
    Del4 = Del3P - Del3M
    Phi = Phi + Fac * Del4
    Fac = Fac * (cfl + 2.0) / 6.0
    DelPPP = (Qippp - Qipp) * MskIpp * MskIp * MskI
    Del2PP = DelPP - DelP
    Del3PP = Del2PP - Del2P
    Del4P = Del3PP - Del3P
    Del5P = Del4P - Del4
    Phi = Phi + Fac * Del5P
    Fac = Fac * (cfl + 2.0) / 7.0
    DelMMM = (Qimm - Qimmm) * MskImmm * MskImm * MskIm
    Del2MM = DelMM - DelMMM
    Del3MM = Del2M - Del2MM
    Del4M = Del3M - Del3MM
    Del5M = Del4 - Del4M
    Del6 = Del5P - Del5M
    Phi = Phi - Fac * Del6
    DelIp = (Qip - Qi) * MskI
    recip_DelIp = jnp.sign(DelIp) / jnp.maximum(jnp.abs(DelIp), Eps)
    recip_DelIp = jnp.where(DelIp == 0.0, 1.0 / Eps, recip_DelIp)
    Phi = Phi * recip_DelIp
    DelI = (Qi - Qim) * MskIm
    recip_DelI = jnp.sign(DelI) / jnp.maximum(jnp.abs(DelI), Eps)
    recip_DelI = jnp.where(DelI == 0.0, 1.0 / Eps, recip_DelI)
    rp1h = DelI * recip_DelIp
    rp1h_cfl = rp1h / (cfl + Eps)
    d2, d2p1, d2m1 = Del2, Del2P, Del2M
    A = 4.0 * d2 - d2p1
    B = 4.0 * d2p1 - d2
    C, D = d2, d2p1
    dp1h = (jnp.maximum(jnp.minimum(jnp.minimum(A, B), jnp.minimum(C, D)),
                        0.0)
            + jnp.minimum(jnp.maximum(jnp.maximum(A, B),
                                      jnp.maximum(C, D)), 0.0))
    A = 4.0 * d2m1 - d2
    B = 4.0 * d2 - d2m1
    C, D = d2m1, d2
    dm1h = (jnp.maximum(jnp.minimum(jnp.minimum(A, B), jnp.minimum(C, D)),
                        0.0)
            + jnp.minimum(jnp.maximum(jnp.maximum(A, B),
                                      jnp.maximum(C, D)), 0.0))
    PhiMD = 1.0 / (1.0 - cfl) * (DelIp - dp1h) * recip_DelIp
    PhiLC = rp1h_cfl * (1.0 + dm1h * recip_DelI)
    PhiMin = jnp.maximum(jnp.minimum(0.0, PhiMD),
                         jnp.minimum(jnp.minimum(0.0, 2.0 * rp1h_cfl),
                                     PhiLC))
    PhiMax = jnp.minimum(jnp.maximum(2.0 / (1.0 - cfl), PhiMD),
                         jnp.maximum(jnp.maximum(0.0, 2.0 * rp1h_cfl),
                                     PhiLC))
    Phi = jnp.maximum(PhiMin, jnp.minimum(Phi, PhiMax))
    Psi = Phi * 0.5 * (1.0 - cfl)
    return trans * (Qi + Psi * DelIp)


def os7mp_flux_x(uTrans, uFld, maskW, Q, dt, recip_dxC, band):
    """gad_os7mp_adv_x.F; band zeroes the columns the reference kernel
    does not write (i in [1-OLx+4, sNx+OLx-3])."""
    cfl = jnp.abs(uFld * dt * recip_dxC)
    up = [sh(Q, di=d) for d in (2, 1, 0, -1, -2, -3, -4)]
    um = [sh(maskW, di=d) for d in (2, 1, 0, -1, -2, -3)]
    dn = [sh(Q, di=d) for d in (-3, -2, -1, 0, 1, 2, 3)]
    dm = [sh(maskW, di=d) for d in (-2, -1, 0, 1, 2, 3)]
    fp = os7mp_psi(uTrans, cfl, tuple(up), tuple(um))
    fn = os7mp_psi(uTrans, cfl, tuple(dn), tuple(dm))
    f = jnp.where(uTrans > 0.0, fp, jnp.where(uTrans < 0.0, fn, 0.0))
    return f * band


def os7mp_flux_y(vTrans, vFld, maskS, Q, dt, recip_dyC, band):
    cfl = jnp.abs(vFld * dt * recip_dyC)
    up = [sh(Q, dj=d) for d in (2, 1, 0, -1, -2, -3, -4)]
    um = [sh(maskS, dj=d) for d in (2, 1, 0, -1, -2, -3)]
    dn = [sh(Q, dj=d) for d in (-3, -2, -1, 0, 1, 2, 3)]
    dm = [sh(maskS, dj=d) for d in (-2, -1, 0, 1, 2, 3)]
    fp = os7mp_psi(vTrans, cfl, tuple(up), tuple(um))
    fn = os7mp_psi(vTrans, cfl, tuple(dn), tuple(dm))
    f = jnp.where(vTrans > 0.0, fp, jnp.where(vTrans < 0.0, fn, 0.0))
    return f * band


def os7mp_band(cfg: Config, axis: str, dtype):
    """The write band of the OS7MP kernels: x columns [1-OLx+4,
    sNx+OLx-3], y rows [1-OLy+4, sNy+OLy-3] (per face)."""
    nyp = cfg.ny + 2 * cfg.oly
    nxp = cfg.nx + 2 * cfg.olx
    band = jnp.zeros((cfg.nFaces * nyp, nxp), dtype)
    for f in range(cfg.nFaces):
        if axis == "x":
            band = band.at[f * nyp:(f + 1) * nyp, 4:nxp - 3].set(1.0)
        else:
            band = band.at[f * nyp + 4:(f + 1) * nyp - 3, :].set(1.0)
    return band


def _os7mp_flux_r(cfg: Config, grid: Grid, rTrans, wFld, Q, deltaT):
    """gad_os7mp_adv_r.F: vertical OS7MP flux at interface k (array
    index k-1).  Vertical indices clamp at the column ends and the
    stencil masks carry the float(kX-kY) clamp-indicator factors."""
    nr = cfg.nr
    mC = grid.maskC
    cflK = jnp.abs(wFld * deltaT * grid.recip_drC[:nr, None, None])

    def lev(off):
        # Q/maskC at clamped Fortran level k+off for interface k=1..Nr,
        # plus the (clamped_next - clamped_this) indicator pair handled
        # by the caller; array index = clamp(k-1+off, 0, nr-1)
        kk = np.arange(1, nr + 1)
        idx = np.clip(kk - 1 + off, 0, nr - 1)
        return idx

    def gather(a, idx):
        return a[idx]

    kk = np.arange(1, nr + 1)
    iK = {off: lev(off) for off in (-4, -3, -2, -1, 0, 1, 2, 3)}

    def mfac(off_hi, off_lo):
        # float(k_hi - k_lo) with clamped indices: 1 when distinct
        return jnp.asarray(
            (iK[off_hi] - iK[off_lo]).astype(float))[:, None, None]

    QL = {off: Q[iK[off]] for off in iK}
    ML = {off: mC[iK[off]] for off in iK}

    # wTrans < 0 branch (upwind from above, Qi = Q(k-1))
    q_dn = (QL[2], QL[1], QL[0], QL[-1], QL[-2], QL[-3], QL[-4])
    m_dn = (ML[2] * mfac(2, 1), ML[1] * mfac(1, 0), ML[0] * mfac(0, -1),
            ML[-1] * mfac(-1, -2), ML[-2] * mfac(-2, -3),
            ML[-3] * mfac(-3, -4))
    # wTrans > 0 branch (upwind from below, Qi = Q(k))
    q_up = (QL[-3], QL[-2], QL[-1], QL[0], QL[1], QL[2], QL[3])
    m_up = (ML[-2] * mfac(-2, -3), ML[-1] * mfac(-1, -2),
            ML[0] * mfac(0, -1), ML[1] * mfac(1, 0),
            ML[2] * mfac(2, 1), ML[3] * mfac(3, 2))
    fn = os7mp_psi(rTrans, cflK, q_dn, m_dn)
    fp = os7mp_psi(rTrans, cflK, q_up, m_up)
    flx = jnp.where(rTrans > 0.0, fp,
                    jnp.where(rTrans < 0.0, fn, 0.0))
    # interface k=1 (surface) flux zeroed by the caller
    return flx


# ---------------------------------------------------------------------------
# PPM / PQM: Lagrangian piecewise parabolic / quartic methods
# (pkg/generic_advdiff/gad_ppm_*.F, gad_pqm_*.F, gad_plm_fun.F,
#  gad_osc_hat_*.F, gad_osc_mul_*.F)
# ---------------------------------------------------------------------------

def _plm_slope(ffll, ff00, ffrr):
    """gad_plm_fun.F GAD_PLM_FUN_U: monotone centred half-slope dfds(0)
    plus the one-sided halves dfds(-1), dfds(+1)."""
    eps = 1.0e-16
    dm = ff00 - ffll
    dp = ffrr - ff00
    d0 = 0.5 * (0.5 * (ff00 + ffrr) - 0.5 * (ffll + ff00))
    scal = jnp.minimum(
        jnp.minimum(jnp.abs(dm), jnp.abs(dp))
        / jnp.maximum(jnp.abs(d0), eps), 1.0)
    d0 = jnp.where(dm * dp > 0.0, scal * d0, 0.0)
    return 0.5 * dm, d0, 0.5 * dp


def _ppm_coef(ff00, fell, ferr):
    """GAD_PPM_FUN_NULL coefficients on local coords s in [-1, 1]."""
    h1 = 1.5 * ff00 - 0.25 * (ferr + fell)
    h2 = 0.5 * (ferr - fell)
    h3 = -1.5 * ff00 + 0.75 * (ferr + fell)
    return h1, h2, h3


def _ppm_mono(ff00, ffll, ffrr, fell, ferr, d0):
    """GAD_PPM_FUN_MONO vectorized: (h1,h2,h3, mono>0 flag)."""
    extrema = (ffrr - ff00) * (ff00 - ffll) <= 0.0
    limL = (ffll - fell) * (fell - ff00) <= 0.0
    limR = (ffrr - ferr) * (ferr - ff00) <= 0.0
    fell = jnp.where(limL, ff00 - d0, fell)
    ferr = jnp.where(limR, ff00 + d0, ferr)
    h1, h2, h3 = _ppm_coef(ff00, fell, ferr)
    has_turn = jnp.abs(h3) > jnp.abs(h2) * 0.5
    turn = -0.5 * h2 / jnp.where(h3 == 0.0, 1.0, h3)
    condA = has_turn & (turn >= -1.0) & (turn <= 0.0)
    condB = has_turn & (turn > 0.0) & (turn <= 1.0)
    # A and B are exclusive (disjoint turn ranges)
    ferr = jnp.where(condA, 3.0 * ff00 - 2.0 * fell, ferr)
    fell = jnp.where(condB, 3.0 * ff00 - 2.0 * ferr, fell)
    redo = condA | condB
    n1, n2, n3 = _ppm_coef(ff00, fell, ferr)
    h1 = jnp.where(redo, n1, h1)
    h2 = jnp.where(redo, n2, h2)
    h3 = jnp.where(redo, n3, h3)
    h1 = jnp.where(extrema, ff00, h1)
    h2 = jnp.where(extrema, 0.0, h2)
    h3 = jnp.where(extrema, 0.0, h3)
    return h1, h2, h3, extrema | limL | limR | redo


def _pqm_coef(ff00, fell, ferr, dell, derr):
    """GAD_PQM_FUN_NULL coefficients (quartic, s in [-1, 1])."""
    h1 = ((30.0 / 16.0) * ff00 - (7.0 / 16.0) * (ferr + fell)
          + (1.0 / 16.0) * (derr - dell))
    h2 = (3.0 / 4.0) * (ferr - fell) - (1.0 / 4.0) * (derr + dell)
    h3 = (-(30.0 / 8.0) * ff00 + (15.0 / 8.0) * (ferr + fell)
          - (3.0 / 8.0) * (derr - dell))
    h4 = -(1.0 / 4.0) * (ferr - fell - derr - dell)
    h5 = ((30.0 / 16.0) * ff00 - (15.0 / 16.0) * (ferr + fell)
          + (5.0 / 16.0) * (derr - dell))
    return h1, h2, h3, h4, h5


def _pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr, dfm, d0, dfp):
    """GAD_PQM_FUN_MONO vectorized (incl. the QUADROOT inflexion test
    and the edge 'pop' branches): (h1..h5, mono>0 flag)."""
    extrema = (ffrr - ff00) * (ff00 - ffll) <= 0.0
    limL = (ffll - fell) * (fell - ff00) <= 0.0
    limR = (ffrr - ferr) * (ferr - ff00) <= 0.0
    fell = jnp.where(limL, ff00 - d0, fell)
    ferr = jnp.where(limR, ff00 + d0, ferr)
    limDL = dell * dfm < 0.0
    limDR = derr * dfp < 0.0
    dell = jnp.where(limDL, dfm, dell)
    derr = jnp.where(limDR, dfp, derr)
    h1, h2, h3, h4, h5 = _pqm_coef(ff00, fell, ferr, dell, derr)

    # QUADROOT on 12*h5*x^2 + 6*h4*x + 2*h3 (2nd derivative)
    aa, bb, cc = 12.0 * h5, 6.0 * h4, 2.0 * h3
    sq = bb * bb - 4.0 * aa * cc
    hasA = (jnp.abs(aa) > 0.0) & (sq >= 0.0)
    hasB = (jnp.abs(aa) <= 0.0) & (jnp.abs(bb) > 0.0)
    sqr = jnp.sqrt(jnp.maximum(sq, 0.0))
    ra = 0.5 / jnp.where(aa == 0.0, 1.0, aa)
    rb = -cc / jnp.where(bb == 0.0, 1.0, bb)
    far = 2.0      # outside (-1, 1): no effect
    x1 = jnp.where(hasA, (-bb + sqr) * ra, jnp.where(hasB, rb, far))
    x2 = jnp.where(hasA, (-bb - sqr) * ra, jnp.where(hasB, rb, far))

    def dflx(x):
        return h2 + x * h3 * 2.0 + x ** 2 * h4 * 3.0 + x ** 3 * h5 * 4.0

    bad1 = (x1 > -1.0) & (x1 < 1.0) & (dflx(x1) * d0 < 0.0)
    bad2 = (x2 > -1.0) & (x2 < 1.0) & (dflx(x2) * d0 < 0.0)
    anybad = bad1 | bad2
    bindm = anybad & (jnp.abs(dell) < jnp.abs(derr))
    bindp = anybad & ~bindm

    # bind == -1: pop inflexion onto the lower (-1) edge
    eA_l, eA_r = fell, ferr
    dA_r = -5.0 * ff00 + 3.0 * ferr + 2.0 * fell
    dA_l = (5.0 / 3.0) * ff00 - (1.0 / 3.0) * ferr - (4.0 / 3.0) * fell
    c1 = dA_l * dfm < 0.0
    eA_r = jnp.where(c1, 5.0 * ff00 - 4.0 * eA_l, eA_r)
    dA_r = jnp.where(c1, 10.0 * ff00 - 10.0 * eA_l, dA_r)
    dA_l = jnp.where(c1, 0.0, dA_l)
    c2 = dA_r * dfp < 0.0
    eA_l = jnp.where(c2, (5.0 / 2.0) * ff00 - (3.0 / 2.0) * eA_r, eA_l)
    dA_l = jnp.where(c2, -(5.0 / 3.0) * ff00 + (5.0 / 3.0) * eA_r, dA_l)
    dA_r = jnp.where(c2, 0.0, dA_r)

    # bind == +1: pop inflexion onto the upper (+1) edge
    eB_l, eB_r = fell, ferr
    dB_r = -(5.0 / 3.0) * ff00 + (4.0 / 3.0) * ferr + (1.0 / 3.0) * fell
    dB_l = 5.0 * ff00 - 2.0 * ferr - 3.0 * fell
    c1 = dB_l * dfm < 0.0
    eB_r = jnp.where(c1, (5.0 / 2.0) * ff00 - (3.0 / 2.0) * eB_l, eB_r)
    dB_r = jnp.where(c1, (5.0 / 3.0) * ff00 - (5.0 / 3.0) * eB_l, dB_r)
    dB_l = jnp.where(c1, 0.0, dB_l)
    c2 = dB_r * dfp < 0.0
    eB_l = jnp.where(c2, 5.0 * ff00 - 4.0 * eB_r, eB_l)
    dB_l = jnp.where(c2, -10.0 * ff00 + 10.0 * eB_r, dB_l)
    dB_r = jnp.where(c2, 0.0, dB_r)

    fell = jnp.where(bindm, eA_l, jnp.where(bindp, eB_l, fell))
    ferr = jnp.where(bindm, eA_r, jnp.where(bindp, eB_r, ferr))
    dell = jnp.where(bindm, dA_l, jnp.where(bindp, dB_l, dell))
    derr = jnp.where(bindm, dA_r, jnp.where(bindp, dB_r, derr))
    n = _pqm_coef(ff00, fell, ferr, dell, derr)
    out = [jnp.where(anybad, nn, hh)
           for nn, hh in zip(n, (h1, h2, h3, h4, h5))]
    flat = (ff00, 0.0, 0.0, 0.0, 0.0)
    out = [jnp.where(extrema, ff, hh) for ff, hh in zip(flat, out)]
    mono = extrema | limL | limR | limDL | limDR | anybad
    return out[0], out[1], out[2], out[3], out[4], mono


def _p3e_edge(s, mask, f):
    """GAD_PPM_P3E_*: 3rd-order edge value at the left edge of each
    cell, with the outward mask-expansion of the 4-point stencil."""
    mm1 = s(mask, -1)
    fm1v = f + mm1 * (s(f, -1) - f)
    f0v = s(f, -1) + mask * (f - s(f, -1))
    mm2 = s(mask, -2) * mm1
    tmp = 2.0 * fm1v - f0v
    fm2v = tmp + mm2 * (s(f, -2) - tmp)
    mp1 = s(mask, 1) * mask
    tmp = 2.0 * f0v - fm1v
    fp1v = tmp + mp1 * (s(f, 1) - tmp)
    return (-(1.0 / 12.0) * (fm2v + fp1v)
            + (7.0 / 12.0) * (fm1v + f0v))


def _p5e_edge(s, mask, f, recip_dC):
    """GAD_PQM_P5E_*: 5th-order edge value + edge slope (slope scaled
    by recip_dxC/dyC/drC at the edge)."""
    mm1 = s(mask, -1)
    fm1v = f + mm1 * (s(f, -1) - f)
    f0v = s(f, -1) + mask * (f - s(f, -1))
    mm2 = s(mask, -2) * mm1
    mm3 = s(mask, -3) * mm2
    tmp = 2.0 * fm1v - f0v
    fm2v = tmp + mm2 * (s(f, -2) - tmp)
    tmp = 2.0 * fm2v - fm1v
    fm3v = tmp + mm3 * (s(f, -3) - tmp)
    mp1 = s(mask, 1) * mask
    mp2 = s(mask, 2) * mp1
    tmp = 2.0 * f0v - fm1v
    fp1v = tmp + mp1 * (s(f, 1) - tmp)
    tmp = 2.0 * fp1v - f0v
    fp2v = tmp + mp2 * (s(f, 2) - tmp)
    e1 = ((1.0 / 60.0) * (fm3v + fp2v) - (8.0 / 60.0) * (fm2v + fp1v)
          + (37.0 / 60.0) * (fm1v + f0v))
    e2 = (-(1.0 / 90.0) * (fm3v - fp2v) + (5.0 / 36.0) * (fm2v - fp1v)
          - (49.0 / 36.0) * (fm1v - f0v)) * recip_dC
    return e1, e2


def _osc_hat(s, mask, f):
    """GAD_OSC_LOC_* interior formula: masked 1st/2nd derivatives in
    local coords (the callers fix the one-sided boundary columns)."""
    fm1 = f + s(mask, -1) * (s(f, -1) - f)
    fp1 = f + s(mask, 1) * (s(f, 1) - f)
    d1 = 0.25 * (fp1 - fm1)
    d2 = 0.25 * fp1 - 0.5 * f + 0.25 * fm1
    return d1, d2


def _osc_mul(s, mask, d1, d2):
    """GAD_OSC_MUL_* with hh=2: WENO oscillation weights (scal1 for the
    unlimited profile, scal2 for the limited one)."""
    zero = 1.0e-20
    omin = omax = None
    mval = jnp.ones_like(mask)
    for off in (-2, -1, 0, 1, 2):
        dels = 2.0 * off
        dd1 = s(d1, off)
        dd2 = s(d2, off)
        dfs1 = dd1 + dd2 * dels
        oval = (2.0 * dfs1) ** 2 + (4.0 * dd2) ** 2
        omin = oval if omin is None else jnp.minimum(omin, oval)
        omax = oval if omax is None else jnp.maximum(omax, oval)
        mval = mval * s(mask, off)
    # reference form: s1 = 1e5/(omax+z)^3, s2 = 1/(omin+z)^3, then
    # normalize.  Computed via the ratio q = ((omax+z)/(omin+z))^3 so no
    # intermediate under/overflows (oval^3 spans ~1e-60.., beyond the
    # f32 exponent range); q -> inf gives the correct (0, 1) limit.
    q = ((omax + zero) / (omin + zero)) ** 3
    s1 = 1.0e5 / (1.0e5 + q)
    s2 = q / (1.0e5 + q)
    ok = mval > 0.0
    return jnp.where(ok, s1, 0.0), jnp.where(ok, s2, 1.0)


def _ppm_pqm_hat(scheme, s, mask, f, edges, osc, xhat=None):
    """GAD_PPM_HAT_* / GAD_PQM_HAT_*: cell polynomial coefficients.

    edges: (value,) for PPM or (value, slope) for PQM, at the LEFT edge
    of each cell; osc: thunk returning the WENO weights; xhat: half
    grid spacing (PQM scales the edge slopes to local coords)."""
    ff00 = f
    ffll = f + s(mask, -1) * (s(f, -1) - f)
    ffrr = f + s(mask, 1) * (s(f, 1) - f)
    fell = edges[0]
    ferr = s(edges[0], 1)
    ppm = scheme in PPM_SCHEMES
    if not ppm:
        dell = edges[1] * xhat
        derr = s(edges[1], 1) * xhat
    if scheme in (ENUM_PPM_NULL, ENUM_PQM_NULL):
        if ppm:
            return _ppm_coef(ff00, fell, ferr)
        return _pqm_coef(ff00, fell, ferr, dell, derr)
    dfm, d0, dfp = _plm_slope(ffll, ff00, ffrr)
    if ppm:
        lhat = _ppm_mono(ff00, ffll, ffrr, fell, ferr, d0)
    else:
        lhat = _pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr,
                         dfm, d0, dfp)
    mono = lhat[-1]
    lhat = lhat[:-1]
    if scheme in (ENUM_PPM_MONO, ENUM_PQM_MONO):
        return lhat
    if ppm:
        uhat = _ppm_coef(ff00, fell, ferr)
    else:
        uhat = _pqm_coef(ff00, fell, ferr, dell, derr)
    fdel = jnp.abs(ffrr - ff00) + jnp.abs(ff00 - ffll)
    fmag = jnp.abs(ffll) + jnp.abs(ff00) + jnp.abs(ffrr)
    s1, s2 = osc()
    blend = mono & (fdel > 1.0e-6 * fmag)
    return tuple(jnp.where(blend, s1 * uu + s2 * ll, ll)
                 for uu, ll in zip(uhat, lhat))


def _sl_flux(s, uvel, ufac, coefs, cfl_up, cfl_dn, band):
    """GAD_PPM_FLX_* / GAD_PQM_FLX_*: semi-Lagrangian edge flux — the
    upwind cell polynomial integrated over the swept interval."""
    def integ(ss11, ss22, cs):
        tot = 0.0
        for n, c in enumerate(cs, start=1):
            tot = tot + (ss22 ** n - ss11 ** n) * (1.0 / n) * c
        return tot

    up = integ(1.0 - 2.0 * cfl_up, 1.0, [s(c, -1) for c in coefs])
    dn = integ(-1.0 - 2.0 * cfl_dn, -1.0, list(coefs))
    pos = uvel > 0.0
    intF = jnp.where(pos, up, dn)
    ucfl = jnp.where(pos, cfl_up, cfl_dn)
    mag = jnp.maximum(jnp.abs(ucfl), 1.0e-20)
    intF = 0.5 * intF / jnp.where(ucfl >= 0.0, mag, -mag)
    return jnp.where(uvel == 0.0, 0.0, ufac * intF) * band


def ppm_pqm_band(cfg: Config, axis: str, margin: int, dtype):
    """Write band of the PPM/PQM flux kernels: x columns
    [1-OLx+3, sNx+OLx-2] (PPM) / [1-OLx+4, sNx+OLx-3] (PQM); same rows
    in y, per face."""
    nyp = cfg.ny + 2 * cfg.oly
    nxp = cfg.nx + 2 * cfg.olx
    band = jnp.zeros((cfg.nFaces * nyp, nxp), dtype)
    for f in range(cfg.nFaces):
        if axis == "x":
            band = band.at[f * nyp:(f + 1) * nyp,
                           margin:nxp - margin + 1].set(1.0)
        else:
            band = band.at[f * nyp + margin:(f + 1) * nyp - margin + 1,
                           :].set(1.0)
    return band


def _ppm_pqm_flux_h(cfg: Config, grid: Grid, scheme: int, axis: str,
                    trans, vel, tracer, deltaT):
    """Horizontal PPM/PQM flux (gad_ppm_adv_x/y.F, gad_pqm_adv_x/y.F):
    operates on all levels at once with the 3-D maskC."""
    if axis == "x":
        s = lambda a, d: sh(a, di=d)                       # noqa: E731
        recip_dF, recip_dC = grid.recip_dxF, grid.recip_dxC
        dF = grid.dxF
    else:
        s = lambda a, d: sh(a, dj=d)                       # noqa: E731
        recip_dF, recip_dC = grid.recip_dyF, grid.recip_dyC
        dF = grid.dyF
    mask = grid.maskC
    ppm = scheme in PPM_SCHEMES
    if ppm:
        edges = (_p3e_edge(s, mask, tracer),)
        xhat = None
    else:
        e1, e2 = _p5e_edge(s, mask, tracer, recip_dC)
        edges = (e1, e2)
        xhat = dF * 0.5

    if scheme in (ENUM_PPM_WENO, ENUM_PQM_WENO):
        d1, d2 = _osc_hat(s, mask, tracer)
        d1, d2 = _osc_ends(axis, cfg, mask, tracer, d1, d2)
        osc = lambda: _osc_mul(s, mask, d1, d2)            # noqa: E731
    else:
        osc = None
    coefs = _ppm_pqm_hat(scheme, s, mask, tracer, edges, osc, xhat=xhat)
    if not ppm:
        # gad_pqm_hat_*.F zeroes the polynomial on dry cells
        coefs = tuple(c * mask for c in coefs)
    cfl_up = vel * deltaT * s(recip_dF, -1)
    cfl_dn = vel * deltaT * recip_dF
    band = ppm_pqm_band(cfg, axis, 3 if ppm else 4, tracer.dtype)
    return _sl_flux(s, vel, trans, coefs, cfl_up, cfl_dn, band)


def _osc_ends(axis, cfg, mask, f, d1, d2):
    """GAD_OSC_LOC_* one-sided boundary columns (the first/last cell of
    the padded row/column, reached by the +/-2 WENO window)."""
    if axis == "x":
        ax = -1
    else:
        # stacked-face layout: the per-face first/last rows; handled
        # only for the single-block case (nFaces==1) — the multi-face
        # y-sweep runs through the CS driver which splits per face
        ax = -2
    m = jnp.moveaxis(mask, ax, 0)
    g = jnp.moveaxis(f, ax, 0)
    e1 = jnp.moveaxis(d1, ax, 0)
    e2 = jnp.moveaxis(d2, ax, 0)
    f0 = g[0]
    f1 = f0 + m[1] * (g[1] - f0)
    f2 = f1 + m[2] * (g[2] - f1)
    e1 = e1.at[0].set(0.5 * (f1 - f0))
    e2 = e2.at[0].set(0.25 * f2 - 0.5 * f1 + 0.25 * f0)
    h0 = g[-1]
    h1 = h0 + m[-2] * (g[-2] - h0)
    h2 = h1 + m[-3] * (g[-3] - h1)
    e1 = e1.at[-1].set(0.5 * (h0 - h1))
    e2 = e2.at[-1].set(0.25 * h0 - 0.5 * h1 + 0.25 * h2)
    return jnp.moveaxis(e1, 0, ax), jnp.moveaxis(e2, 0, ax)


def _ppm_pqm_flux_r(cfg: Config, grid: Grid, scheme: int, rTrans, wFld,
                    tracer, deltaT):
    """Vertical PPM/PQM flux (gad_ppm_adv_r.F / gad_pqm_adv_r.F):
    columns padded with 3 ghost copies at both ends (mask 0), transport
    facR = rTrans*maskC(k-1) (gad_advection.F:885-898 rTran3d)."""
    nr = cfg.nr
    mC = grid.maskC
    ppm = scheme in PPM_SCHEMES
    # padded columns: ghost cells copy the end values, ghost masks 0
    P = jnp.concatenate([jnp.repeat(tracer[:1], 3, axis=0), tracer,
                         jnp.repeat(tracer[-1:], 3, axis=0)], axis=0)
    M = jnp.concatenate([jnp.zeros_like(mC[:3]), mC,
                         jnp.zeros_like(mC[:3])], axis=0)

    def cell(a, d, n):
        # value at 1-based cell ir+d for ir in 1..n; cell 1 sits at
        # padded index 3, so the slice starts at 3+d
        return jax.lax.dynamic_slice_in_dim(a, 3 + d, n, axis=0)

    # --- edges at interfaces ir in [1, Nr+1] (between cells ir-1, ir),
    #     same stencils as _p3e/_p5e_edge applied to the padded column
    def s_edge(a, d):
        return cell(a, d, nr + 1)

    mm1 = s_edge(M, -1)
    fm1v = s_edge(P, 0) + mm1 * (s_edge(P, -1) - s_edge(P, 0))
    f0v = s_edge(P, -1) + s_edge(M, 0) * (s_edge(P, 0) - s_edge(P, -1))
    if ppm:
        mm2 = s_edge(M, -2) * mm1
        tmp = 2.0 * fm1v - f0v
        fm2v = tmp + mm2 * (s_edge(P, -2) - tmp)
        mp1 = s_edge(M, 1) * s_edge(M, 0)
        tmp = 2.0 * f0v - fm1v
        fp1v = tmp + mp1 * (s_edge(P, 1) - tmp)
        eval_ = (-(1.0 / 12.0) * (fm2v + fp1v)
                 + (7.0 / 12.0) * (fm1v + f0v))
        eslp = None
    else:
        mm2 = s_edge(M, -2) * mm1
        mm3 = s_edge(M, -3) * mm2
        tmp = 2.0 * fm1v - f0v
        fm2v = tmp + mm2 * (s_edge(P, -2) - tmp)
        tmp = 2.0 * fm2v - fm1v
        fm3v = tmp + mm3 * (s_edge(P, -3) - tmp)
        mp1 = s_edge(M, 1) * s_edge(M, 0)
        mp2 = s_edge(M, 2) * mp1
        tmp = 2.0 * f0v - fm1v
        fp1v = tmp + mp1 * (s_edge(P, 1) - tmp)
        tmp = 2.0 * fp1v - f0v
        fp2v = tmp + mp2 * (s_edge(P, 2) - tmp)
        eval_ = ((1.0 / 60.0) * (fm3v + fp2v)
                 - (8.0 / 60.0) * (fm2v + fp1v)
                 + (37.0 / 60.0) * (fm1v + f0v))
        eslp = (-(1.0 / 90.0) * (fm3v - fp2v)
                + (5.0 / 36.0) * (fm2v - fp1v)
                - (49.0 / 36.0) * (fm1v - f0v)
                ) * grid.recip_drC[:nr + 1, None, None]

    # --- cell polynomials for cells 1..Nr ---
    f = tracer
    mk = mC
    mkm = jnp.concatenate([jnp.zeros_like(mk[:1]), mk[:-1]], axis=0)
    mkp = jnp.concatenate([mk[1:], jnp.zeros_like(mk[:1])], axis=0)
    fkm = jnp.concatenate([f[:1], f[:-1]], axis=0)
    fkp = jnp.concatenate([f[1:], f[-1:]], axis=0)
    ff00 = f
    ffll = f + mkm * (fkm - f)
    ffrr = f + mkp * (fkp - f)
    fell, ferr = eval_[:nr], eval_[1:]
    if not ppm:
        rhat = grid.drF[:, None, None] * 0.5
        dell, derr = eslp[:nr] * rhat, eslp[1:] * rhat

    if scheme in (ENUM_PPM_WENO, ENUM_PQM_WENO):
        # oscillation indicators on the padded column (interior formula;
        # the padded ends are outside the +/-2 window of real cells)
        sh1 = jnp.concatenate([M[:1] * 0, M[:-1]], axis=0)
        fm1o = P + sh1 * (jnp.concatenate([P[:1], P[:-1]], axis=0) - P)
        sh2 = jnp.concatenate([M[1:], M[:1] * 0], axis=0)
        fp1o = P + sh2 * (jnp.concatenate([P[1:], P[-1:]], axis=0) - P)
        D1 = 0.25 * (fp1o - fm1o)
        D2 = 0.25 * fp1o - 0.5 * P + 0.25 * fm1o
        zero = 1.0e-20
        omin = omax = None
        mval = jnp.ones_like(f)
        for off in (-2, -1, 0, 1, 2):
            dd1 = cell(D1, off, nr)
            dd2 = cell(D2, off, nr)
            dfs1 = dd1 + dd2 * (2.0 * off)
            oval = (2.0 * dfs1) ** 2 + (4.0 * dd2) ** 2
            omin = oval if omin is None else jnp.minimum(omin, oval)
            omax = oval if omax is None else jnp.maximum(omax, oval)
            mval = mval * cell(M, off, nr)
        q = ((omax + zero) / (omin + zero)) ** 3
        ok = mval > 0.0
        s1 = jnp.where(ok, 1.0e5 / (1.0e5 + q), 0.0)
        s2 = jnp.where(ok, q / (1.0e5 + q), 1.0)

    if scheme in (ENUM_PPM_NULL, ENUM_PQM_NULL):
        coefs = (_ppm_coef(ff00, fell, ferr) if ppm
                 else _pqm_coef(ff00, fell, ferr, dell, derr))
    else:
        dfm, d0, dfp = _plm_slope(ffll, ff00, ffrr)
        if ppm:
            lhat = _ppm_mono(ff00, ffll, ffrr, fell, ferr, d0)
        else:
            lhat = _pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr,
                             dfm, d0, dfp)
        mono = lhat[-1]
        coefs = lhat[:-1]
        if scheme in (ENUM_PPM_WENO, ENUM_PQM_WENO):
            uhat = (_ppm_coef(ff00, fell, ferr) if ppm
                    else _pqm_coef(ff00, fell, ferr, dell, derr))
            fdel = jnp.abs(ffrr - ff00) + jnp.abs(ff00 - ffll)
            fmag = jnp.abs(ffll) + jnp.abs(ff00) + jnp.abs(ffrr)
            blend = mono & (fdel > 1.0e-6 * fmag)
            coefs = tuple(jnp.where(blend, s1 * uu + s2 * ll, ll)
                          for uu, ll in zip(uhat, coefs))
    if not ppm:
        coefs = tuple(c * mk for c in coefs)

    # --- fluxes at interfaces ir in [2, Nr] (array index 1..nr-1) ---
    rdrF = grid.recip_drF[:, None, None]
    cm = [jnp.concatenate([c[:1], c[:-1]], axis=0) for c in coefs]
    w = wFld
    # wvel < 0: upwind cell ir-1, ss in [1+2*wCFL, 1]
    cfl_m = w * deltaT * jnp.concatenate([rdrF[:1], rdrF[:-1]], axis=0)
    # wvel > 0: cell ir, ss in [-1+2*wCFL, -1]
    cfl_p = w * deltaT * rdrF

    def integ(ss11, ss22, cs):
        tot = 0.0
        for n, c in enumerate(cs, start=1):
            tot = tot + (ss22 ** n - ss11 ** n) * (1.0 / n) * c
        return tot

    up = integ(1.0 + 2.0 * cfl_m, 1.0, cm)
    dn = integ(-1.0 + 2.0 * cfl_p, -1.0, list(coefs))
    neg = w < 0.0
    intF = jnp.where(neg, up, dn)
    wcfl = jnp.where(neg, cfl_m, cfl_p)
    mag = jnp.maximum(jnp.abs(wcfl), 1.0e-20)
    # NOTE the sign: a literal read of gad_ppm_flx_r.F gives
    # intF = -(upwind cell mean) in both branches, which is
    # anti-diffusive through the shared fVerT update — the working
    # convention (validated by digit-matching advect_xz) is +mean,
    # i.e. divide the oriented integral by -wCFL
    intF = -0.5 * intF / jnp.where(wcfl >= 0.0, mag, -mag)
    facR = rTrans * mkm
    flx = jnp.where(w == 0.0, 0.0, facR * intF)
    return flx.at[0].set(0.0)


def _adv_flux_highorder(cfg, scheme, trans, cfl, t, tm1, Rjp, Rj, Rjm,
                        mask_m1p1=None):
    """Shared wide-stencil advective flux (x/y direction-agnostic):
    Superbee flux limiter (gad_fluxlimit_adv_x.F), 3rd upwind
    (gad_u3_adv_x.F), 4th centered (gad_c4_adv_x.F), DST-3
    (gad_dst3_adv_x.F), DST-3 flux-limited (gad_dst3fl_adv_x.F)."""
    absT = jnp.abs(trans)
    if scheme == ENUM_FLUX_LIMIT:
        cr_raw = jnp.where(trans > 0.0, Rjm, Rjp)
        sign_rj = jnp.where(Rj >= 0.0, 1.0, -1.0)
        cr = jnp.where(
            jnp.abs(Rj) * _CR_MAX <= jnp.abs(cr_raw),
            jnp.where(cr_raw >= 0.0, _CR_MAX, -_CR_MAX) * sign_rj,
            cr_raw / jnp.where(Rj == 0.0, 1.0, Rj))
        lim = _limiter(cr)
        return (trans * (t + tm1) * 0.5
                - absT * ((1.0 - lim) + cfl * lim) * Rj * 0.5)
    if scheme in (ENUM_UPWIND_3RD, ENUM_CENTERED_4TH):
        # gad_u3_adv_x.F: Rjjp = Rjp-Rj, Rjjm = Rj-Rjm; C4 keeps the
        # upwind part only next to walls (gad_c4_adv_x.F mask factor)
        Rjjp = Rjp - Rj
        Rjjm = Rj - Rjm
        centered = trans * (t + tm1 - (Rjjp + Rjjm) * (1.0 / 6.0)) * 0.5
        upwind = absT * 0.5 * (1.0 / 6.0) * (Rjjp - Rjjm)
        if scheme == ENUM_UPWIND_3RD:
            return centered + upwind
        return centered + upwind * (1.0 - mask_m1p1)
    if scheme == ENUM_DST3:
        d0 = (2.0 - cfl) * (1.0 - cfl) * (1.0 / 6.0)
        d1 = (1.0 - cfl * cfl) * (1.0 / 6.0)
        return (0.5 * (trans + absT) * (tm1 + (d0 * Rj + d1 * Rjm))
                + 0.5 * (trans - absT) * (t - (d0 * Rj + d1 * Rjp)))
    if scheme == ENUM_DST3_FLUX_LIMIT:
        d0 = (2.0 - cfl) * (1.0 - cfl) * (1.0 / 6.0)
        d1 = (1.0 - cfl * cfl) * (1.0 / 6.0)
        thetaP = jnp.where(
            jnp.abs(Rj) * _THETA_MAX <= jnp.abs(Rjm),
            jnp.where(Rjm * Rj >= 0.0, _THETA_MAX, -_THETA_MAX),
            Rjm / jnp.where(Rj == 0.0, 1.0, Rj))
        thetaM = jnp.where(
            jnp.abs(Rj) * _THETA_MAX <= jnp.abs(Rjp),
            jnp.where(Rjp * Rj >= 0.0, _THETA_MAX, -_THETA_MAX),
            Rjp / jnp.where(Rj == 0.0, 1.0, Rj))
        psiP = d0 + d1 * thetaP
        psiP = jnp.maximum(0.0, jnp.minimum(
            jnp.minimum(1.0, psiP),
            thetaP * (1.0 - cfl) / (cfl + 1.0e-20)))
        psiM = d0 + d1 * thetaM
        psiM = jnp.maximum(0.0, jnp.minimum(
            jnp.minimum(1.0, psiM),
            thetaM * (1.0 - cfl) / (cfl + 1.0e-20)))
        return (0.5 * (trans + absT) * (tm1 + psiP * Rj)
                + 0.5 * (trans - absT) * (t - psiM * Rj))
    raise NotImplementedError(f"advection scheme {scheme}")


def adv_flux_x(cfg: Config, grid: Grid, scheme: int, uTrans, uFld, tracer,
               deltaT, maskW, wetW=None):
    """wetW: plain wet-point mask for the C4 wall-upwinding factor
    (gad_c4_adv_x.F:71 uses maskW, NOT maskLocW with maskIn folded in);
    defaults to maskW when the caller has no separate wet mask."""
    t = tracer
    tm1 = sh(t, di=-1)
    if scheme == ENUM_CENTERED_2ND:
        return uTrans * 0.5 * (t + tm1)
    if scheme == ENUM_OS7MP:
        band = os7mp_band(cfg, "x", t.dtype)
        return os7mp_flux_x(uTrans, uFld, maskW, t, deltaT,
                            grid.recip_dxC, band)
    if scheme in PPM_SCHEMES or scheme in PQM_SCHEMES:
        return _ppm_pqm_flux_h(cfg, grid, scheme, "x", uTrans, uFld, t,
                               deltaT)
    if scheme in (ENUM_UPWIND_1RST, ENUM_DST2):
        # gad_dst2u1_adv_x.F: Lax-Wendroff or upwind via CFL factor
        if scheme == ENUM_UPWIND_1RST:
            xLimit = 1.0
        else:
            xLimit = uFld * deltaT * grid.recip_dxC
        return 0.5 * (uTrans * (t + tm1)
                      - jnp.abs(uTrans) * xLimit * (t - tm1))
    tm2 = sh(t, di=-2)
    tp1 = sh(t, di=1)
    maskm1 = sh(maskW, di=-1)
    maskp1 = sh(maskW, di=1)
    Rjp = (tp1 - t) * maskp1
    Rj = (t - tm1) * maskW
    Rjm = (tm1 - tm2) * maskm1
    wet = maskW if wetW is None else wetW
    return _adv_flux_highorder(cfg, scheme, uTrans,
                               jnp.abs(uFld * deltaT * grid.recip_dxC),
                               t, tm1, Rjp, Rj, Rjm,
                               mask_m1p1=sh(wet, di=-1) * sh(wet, di=1))


def adv_flux_y(cfg: Config, grid: Grid, scheme: int, vTrans, vFld, tracer,
               deltaT, maskS, wetS=None):
    t = tracer
    tm1 = sh(t, dj=-1)
    if scheme == ENUM_CENTERED_2ND:
        return vTrans * 0.5 * (t + tm1)
    if scheme == ENUM_OS7MP:
        band = os7mp_band(cfg, "y", t.dtype)
        return os7mp_flux_y(vTrans, vFld, maskS, t, deltaT,
                            grid.recip_dyC, band)
    if scheme in PPM_SCHEMES or scheme in PQM_SCHEMES:
        return _ppm_pqm_flux_h(cfg, grid, scheme, "y", vTrans, vFld, t,
                               deltaT)
    if scheme in (ENUM_UPWIND_1RST, ENUM_DST2):
        if scheme == ENUM_UPWIND_1RST:
            yLimit = 1.0
        else:
            yLimit = vFld * deltaT * grid.recip_dyC
        return 0.5 * (vTrans * (t + tm1)
                      - jnp.abs(vTrans) * yLimit * (t - tm1))
    tm2 = sh(t, dj=-2)
    tp1 = sh(t, dj=1)
    maskm1 = sh(maskS, dj=-1)
    maskp1 = sh(maskS, dj=1)
    Rjp = (tp1 - t) * maskp1
    Rj = (t - tm1) * maskS
    Rjm = (tm1 - tm2) * maskm1
    wet = maskS if wetS is None else wetS
    return _adv_flux_highorder(cfg, scheme, vTrans,
                               jnp.abs(vFld * deltaT * grid.recip_dyC),
                               t, tm1, Rjp, Rj, Rjm,
                               mask_m1p1=sh(wet, dj=-1) * sh(wet, dj=1))


def adv_flux_r(cfg: Config, grid: Grid, scheme: int, rTrans, wFld, tracer,
               deltaT):
    """Vertical advective flux at interface k (gad_c2_adv_r.F,
    gad_fluxlimit_adv_r.F, gad_dst3_adv_r.F, gad_dst3fl_adv_r.F).

    Index convention: array index i0 = 1-based interface k=i0+1; the
    surface interface (index 0) flux is forced to zero. Vertical neighbor
    indices are CLAMPED at the column ends (km1=MAX(1,k-1) etc.).
    """
    t = tracer
    mC = grid.maskC
    # clamped vertical shifts
    tkm1 = jnp.concatenate([t[:1], t[:-1]], axis=0)       # t(k-1)
    tkm2 = jnp.concatenate([tkm1[:1], tkm1[:-1]], axis=0)  # t(k-2)
    tkp1 = jnp.concatenate([t[1:], t[-1:]], axis=0)        # t(k+1)
    mkm1 = jnp.concatenate([mC[:1], mC[:-1]], axis=0)
    mkm2 = jnp.concatenate([mkm1[:1], mkm1[:-1]], axis=0)
    mkp1 = jnp.concatenate([mC[1:], mC[-1:]], axis=0)
    absT = jnp.abs(rTrans)
    wCFL = jnp.abs(wFld * deltaT * grid.recip_drC[:cfg.nr, None, None])

    if scheme == ENUM_CENTERED_2ND:
        flx = mkm1 * rTrans * 0.5 * (t + tkm1)
    elif scheme == ENUM_OS7MP:
        flx = _os7mp_flux_r(cfg, grid, rTrans, wFld, t, deltaT)
    elif scheme in PPM_SCHEMES or scheme in PQM_SCHEMES:
        flx = _ppm_pqm_flux_r(cfg, grid, scheme, rTrans, wFld, t, deltaT)
    elif scheme == ENUM_CENTERED_4TH:
        # gad_c4_adv_r.F: 4th-order centered; the upwind correction is
        # only active next to the top/bottom (maskBound wall factor)
        k1 = jnp.arange(1, cfg.nr + 1,
                        dtype=tracer.dtype)[:, None, None]  # interface k
        maskPM = jnp.where((k1 <= 2.0) | (k1 >= float(cfg.nr)), 0.0, 1.0)
        maskBound = maskPM * mkm2 * mkp1
        Rjp = (tkp1 - t) * mkp1
        Rj = t - tkm1
        Rjm = (tkm1 - tkm2) * mkm1
        Rjjp = Rjp - Rj
        Rjjm = Rj - Rjm
        flx = mkm1 * (
            rTrans * ((t + tkm1) * 0.5 - (Rjjm + Rjjp) * (1.0 / 12.0))
            + absT * (1.0 / 6.0) * (Rjjm - Rjjp) * 0.5 * (1.0 - maskBound))
    elif scheme in (ENUM_UPWIND_1RST, ENUM_DST2):
        # gad_dst2u1_adv_r.F: rkSign flips the upwind direction in r
        if scheme == ENUM_UPWIND_1RST:
            wLim = 1.0
        else:
            wLim = wCFL
        flx = mkm1 * 0.5 * (rTrans * (t + tkm1)
                            + absT * wLim * (t - tkm1))
    elif scheme == ENUM_FLUX_LIMIT:
        # gad_fluxlimit_adv_r.F
        Rjp = (tkp1 - t) * mkp1
        Rj = t - tkm1
        Rjm = (tkm1 - tkm2) * mkm2
        cr_raw = jnp.where(rTrans < 0.0, Rjm, Rjp)
        sign_rj = jnp.where(Rj >= 0.0, 1.0, -1.0)
        cr = jnp.where(
            jnp.abs(Rj) * _CR_MAX <= jnp.abs(cr_raw),
            jnp.where(cr_raw >= 0.0, _CR_MAX, -_CR_MAX) * sign_rj,
            cr_raw / jnp.where(Rj == 0.0, 1.0, Rj))
        lim = _limiter(cr)
        flx = mkm1 * (rTrans * (t + tkm1) * 0.5
                      + absT * ((1.0 - lim) + wCFL * lim) * Rj * 0.5)
    elif scheme in (ENUM_DST3, ENUM_DST3_FLUX_LIMIT, ENUM_UPWIND_3RD):
        # gad_dst3_adv_r.F / gad_dst3fl_adv_r.F / gad_u3_adv_r.F
        Rjp = (t - tkp1) * mkp1
        Rj = (tkm1 - t) * mC * mkm1
        Rjm = (tkm2 - tkm1) * mkm1
        d0 = (2.0 - wCFL) * (1.0 - wCFL) * (1.0 / 6.0)
        d1 = (1.0 - wCFL * wCFL) * (1.0 / 6.0)
        if scheme == ENUM_UPWIND_3RD:
            # gad_u3_adv_r.F:36-46 — its R's run top-down (opposite of the
            # DST3 convention above): Rj unmasked, Rjm masked with m(k-2)
            Rjp3 = (tkp1 - t) * mkp1
            Rj3 = t - tkm1
            Rjm3 = (tkm1 - tkm2) * mkm2
            Rjjp = Rjp3 - Rj3
            Rjjm = Rj3 - Rjm3
            flx = mkm1 * (
                rTrans * ((t + tkm1) * 0.5
                          - (1.0 / 6.0) * (Rjjm + Rjjp) * 0.5)
                + absT * (1.0 / 6.0) * (Rjjm - Rjjp) * 0.5)
        elif scheme == ENUM_DST3:
            # gad_dst3_adv_r.F:69-73: downward-wind branch takes the
            # d1-correction from its upstream side (Rjp below, Rjm above)
            flx = (0.5 * (rTrans + absT) * (t + (d0 * Rj + d1 * Rjp))
                   + 0.5 * (rTrans - absT) * (tkm1 - (d0 * Rj + d1 * Rjm)))
        else:
            thetaP = jnp.where(
                jnp.abs(Rj) * _THETA_MAX <= jnp.abs(Rjm),
                jnp.where(Rjm * Rj >= 0.0, _THETA_MAX, -_THETA_MAX),
                Rjm / jnp.where(Rj == 0.0, 1.0, Rj))
            thetaM = jnp.where(
                jnp.abs(Rj) * _THETA_MAX <= jnp.abs(Rjp),
                jnp.where(Rjp * Rj >= 0.0, _THETA_MAX, -_THETA_MAX),
                Rjp / jnp.where(Rj == 0.0, 1.0, Rj))
            psiP = d0 + d1 * thetaP
            psiP = jnp.maximum(0.0, jnp.minimum(
                jnp.minimum(1.0, psiP),
                thetaP * (1.0 - wCFL) / (wCFL + 1.0e-20)))
            psiM = d0 + d1 * thetaM
            psiM = jnp.maximum(0.0, jnp.minimum(
                jnp.minimum(1.0, psiM),
                thetaM * (1.0 - wCFL) / (wCFL + 1.0e-20)))
            flx = (0.5 * (rTrans + absT) * (t + psiM * Rj)
                   + 0.5 * (rTrans - absT) * (tkm1 - psiP * Rj))
    else:
        flx = mkm1 * rTrans * 0.5 * (t + tkm1)
    # zero surface (k=1) and mask
    flx = flx.at[0].set(0.0)
    return flx


def diff_flux_r(cfg: Config, grid: Grid, kappaR, maskUp, tracer):
    """gad_diff_r.F: interface diffusive flux [nr,...]; zero at surface."""
    tkm1 = shift_k(tracer, -1)
    flx = (-kappaR[:cfg.nr] * maskUp * grid.rA
           * grid.recip_drC[:cfg.nr, None, None]
           * (tracer - tkm1) * cfg.rkSign)
    return flx.at[0].set(0.0)


class GadResult(NamedTuple):
    gTr: jnp.ndarray


def calc_rhs(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
             scheme: int, vert_scheme: int, diffKh: float, diffK4: float,
             kappaR, deltaT, implicit_diffusion: bool,
             calc_advection: bool = True, gm_tensor=None,
             kpp_df=None, aim_salt_hack: bool = False) -> jnp.ndarray:
    """gad_calc_rhs.F: explicit tendency of one tracer, all levels."""
    dtype = tracer.dtype
    fZon = jnp.zeros_like(tracer)
    fMer = jnp.zeros_like(tracer)

    if calc_advection:
        # advection-scheme face masks carry the OBCS interior mask
        # (gad_calc_rhs.F:264,393 maskLocW/S = maskW/S * maskInW/S)
        fZon = fZon + adv_flux_x(cfg, grid, scheme, flow.uTrans, u, tracer,
                                 deltaT, grid.maskW * grid.maskInW,
                                 wetW=grid.maskW)
        fMer = fMer + adv_flux_y(cfg, grid, scheme, flow.vTrans, v, tracer,
                                 deltaT, grid.maskS * grid.maskInS,
                                 wetS=grid.maskS)

    if diffKh != 0.0:
        fZon = fZon - (diffKh * flow.xA * grid.recip_dxC
                       * (tracer - sh(tracer, di=-1)) * grid.cosFacU)
        fMer = fMer - (diffKh * flow.yA * grid.recip_dyC
                       * (tracer - sh(tracer, dj=-1)))
    if diffK4 != 0.0:
        # gad_grad_x/y -> gad_del2 -> gad_biharm_x/y
        gx = flow.xA * grid.recip_dxC * (tracer - sh(tracer, di=-1))
        gy = flow.yA * grid.recip_dyC * (tracer - sh(tracer, dj=-1))
        del2 = (grid.recip_hFacC * grid.recip_drF[:, None, None]
                * grid.recip_rA
                * ((sh(gx, di=1) - gx) + (sh(gy, dj=1) - gy))) * grid.maskC
        fZon = fZon + (diffK4 * flow.xA * grid.recip_dxC
                       * (del2 - sh(del2, di=-1)) * grid.cosFacU)
        fMer = fMer + (diffK4 * flow.yA * grid.recip_dyC
                       * (del2 - sh(del2, dj=-1)))

    if gm_tensor is not None and gm_tensor.Kux is not None:
        from mitgcm_tpu.model import gmredi
        gx, gy = gmredi.xy_flux(cfg, grid, gm_tensor, flow.xA, flow.yA,
                                tracer)
        fZon = fZon + gx
        fMer = fMer + gy

    # vertical fluxes at interface k (index k; surface = 0)
    fVer = jnp.zeros_like(tracer)
    if calc_advection:
        af = adv_flux_r(cfg, grid, vert_scheme, flow.rTrans, w,
                        tracer, deltaT) * grid.maskInC
        if aim_salt_hack:
            # gad_calc_rhs.F:504-508: with useAIM, no water-vapor
            # vertical advective transport into the stratospheric
            # level Nr (flux at interface k=Nr forced to zero)
            af = af.at[cfg.nr - 1].set(0.0)
        fVer = fVer + af
    if not implicit_diffusion:
        fVer = fVer + diff_flux_r(cfg, grid, kappaR, flow.maskUp, tracer)
    if gm_tensor is not None:
        from mitgcm_tpu.model import gmredi
        fVer = fVer + gmredi.r_flux(cfg, grid, gm_tensor, flow.maskUp,
                                    tracer)
    if kpp_df is not None:
        # KPP nonlocal transport (gad_calc_rhs.F:655-690, KPP_GHAT)
        fVer = fVer + kpp_df
    fVerKp = jnp.concatenate([fVer[1:], jnp.zeros_like(fVer[:1])], axis=0)

    advFac = 1.0 if calc_advection else 0.0
    rAdvFac = cfg.rkSign * advFac

    divTrans = ((sh(flow.uTrans, di=1) - flow.uTrans) * advFac
                + (sh(flow.vTrans, dj=1) - flow.vTrans) * advFac
                + (flow.rTransKp - flow.rTrans) * rAdvFac)

    gTr = -(
        grid.recip_hFacC * grid.recip_drF[:, None, None] * grid.recip_rA
        * (((sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer)) * grid.maskInC
           + (fVerKp - fVer) * cfg.rkSign
           - tracer * divTrans * grid.maskInC)
    )
    return gTr


def multidim_advection(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w,
                       tracer, scheme: int, vert_scheme: int, deltaT):
    """Direction-split multi-dimensional advection
    (pkg/generic_advdiff/gad_advection.F, default non-compressible form,
    Cartesian-topology pass order X then Y then R).

    Returns gTracer = (T_advected - T)/deltaT. On the cubed sphere the
    3-pass variant with corner fills is used instead.
    """
    if cfg.onCubeFace:
        return multidim_advection_cs(cfg, grid, flow, u, v, w, tracer,
                                     scheme, vert_scheme, deltaT)
    rhc = grid.recip_hFacC
    rdrF = grid.recip_drF[:, None, None]
    rrA = grid.recip_rA
    mIn = grid.maskInC
    uT, vT = flow.uTrans, flow.vTrans

    # X pass
    af = adv_flux_x(cfg, grid, scheme, uT, u, tracer, deltaT,
                    grid.maskW * grid.maskInW, wetW=grid.maskW)
    localT = tracer - deltaT * rhc * rdrF * rrA * (
        (sh(af, di=1) - af) - tracer * (sh(uT, di=1) - uT)) * mIn
    # Y pass (on updated field; compensation still uses original tracer)
    af = adv_flux_y(cfg, grid, scheme, vT, v, localT, deltaT,
                    grid.maskS * grid.maskInS, wetS=grid.maskS)
    localT = localT - deltaT * rhc * rdrF * rrA * (
        (sh(af, dj=1) - af) - tracer * (sh(vT, dj=1) - vT)) * mIn
    # R pass on the post-horizontal field
    fVer = adv_flux_r(cfg, grid, vert_scheme, flow.rTrans, w, localT, deltaT)
    fVerKp = jnp.concatenate([fVer[1:], jnp.zeros_like(fVer[:1])], axis=0)
    localT = localT - deltaT * rhc * rdrF * rrA * (
        (fVerKp - fVer) - tracer * (flow.rTransKp - flow.rTrans)
    ) * cfg.rkSign * mIn
    return (localT - tracer) / deltaT


def is_multidim(cfg: Config, scheme: int) -> bool:
    """set_parms.F logic: non-linear schemes use the multi-dim driver when
    multiDimAdvection is on."""
    return cfg.multiDimAdvection and scheme in MULTIDIM_SCHEMES


# ----------------------------------------------------------------------
# cubed-sphere multi-dimensional advection (gad_advection.F CS branch)
# ----------------------------------------------------------------------

_CS_MASK_CACHE = {}


def _cs_pass_plan(n: int, ol: int):
    """Per-pass / per-face update masks + corner-fill and direction flags
    for the 3-pass cubed-sphere direction split (gad_advection.F:249-269,
    single tile per face so all four edges are cube-face edges).

    Returns for each pass p (0..2):
      xmask, ymask: [6*nyp, nxp] float64 update masks (1 where the X/Y
        update writes), already encoding overlapOnly/interiorOnly/full
        row-column ranges;
      fillx_pre / filly_pre: True if any face computes X (resp. Y) fluxes
        in overlap-only mode this pass (corner fill before the flux);
      fill_after: ipass==1 second corner fill (dir swapped).
    """
    key = (n, ol)
    if key in _CS_MASK_CACHE:
        return _CS_MASK_CACHE[key]
    import numpy as np
    nyp = nxp = n + 2 * ol
    plans = []
    for p in range(3):
        xm = np.zeros((6, nyp, nxp))
        ym = np.zeros((6, nyp, nxp))
        x_over_faces, y_over_faces = [], []
        for f1 in range(1, 7):          # 1-based face number = nCFace
            if p == 0:
                overlap = (f1 % 3) == 0
                interior = (f1 % 3) != 0
                do_x = f1 in (6, 1, 2)
                do_y = f1 in (3, 4, 5)
            elif p == 1:
                overlap = (f1 % 3) == 2
                interior = (f1 % 3) == 1
                do_x = f1 in (2, 3, 4)
                do_y = f1 in (5, 6, 1)
            else:
                overlap = False
                interior = True
                do_x = f1 in (5, 6)
                do_y = f1 in (2, 3)
            f = f1 - 1
            if do_x and overlap:
                x_over_faces.append(f)
            if do_y and overlap:
                y_over_faces.append(f)
            if do_x:
                if overlap:
                    any_x_overlap = True
                    xm[f, 0:ol, ol:ol + n] = 1.0
                    xm[f, ol + n:nyp, ol:ol + n] = 1.0
                elif interior:
                    xm[f, ol:ol + n, 1:nxp - 1] = 1.0
                else:
                    xm[f, :, 1:nxp - 1] = 1.0
            if do_y:
                if overlap:
                    any_y_overlap = True
                    ym[f, ol:ol + n, 0:ol] = 1.0
                    ym[f, ol:ol + n, ol + n:nxp] = 1.0
                elif interior:
                    ym[f, 1:nyp - 1, ol:ol + n] = 1.0
                else:
                    ym[f, 1:nyp - 1, :] = 1.0
        plans.append((xm.reshape(6 * nyp, nxp), ym.reshape(6 * nyp, nxp),
                      tuple(x_over_faces), tuple(y_over_faces)))
    # flux-kernel write bands (gad_*_adv_x.F: i in [1-OLx+2, sNx+OLx-1];
    # _adv_y.F: j likewise): af outside is zero — essential in the
    # stacked-face layout where a shift would otherwise read the
    # neighbouring face block
    kx = np.zeros((1, nxp))
    kx[0, 2:nxp - 1] = 1.0
    ky = np.zeros((6, nyp, 1))
    ky[:, 2:nyp - 1, :] = 1.0
    ky = ky.reshape(6 * nyp, 1)
    out = (plans, kx, ky)
    _CS_MASK_CACHE[key] = out
    return out


def multidim_advection_cs(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w,
                          tracer, scheme: int, vert_scheme: int, deltaT):
    """Cubed-sphere 3-pass direction-split advection
    (pkg/generic_advdiff/gad_advection.F:249-269 pass schedule,
    :455-575 X updates, :690-800 Y updates, :875-1075 vertical), with the
    GAD_MULTIDIM_COMPRESSIBLE volume-tracking update when
    cfg.gadMultiDimCompressible (set from the experiment's GAD_OPTIONS.h).

    All six faces advance together: per pass, each face applies exactly
    one direction (X or Y) selected by a precomputed mask, which maps the
    reference's per-tile branch structure onto one fused XLA program.
    """
    from mitgcm_tpu.parallel.cs import fill_cs_corner, fill_cs_corner_uv

    n, ol = cfg.ny, cfg.olx
    plans, kx, ky = _cs_pass_plan(n, ol)
    dtype = tracer.dtype
    kx = jnp.asarray(kx, dtype)
    ky = jnp.asarray(ky, dtype)
    mIn = grid.maskInC
    rhc = grid.recip_hFacC
    rdrF = grid.recip_drF[:, None, None]
    rrA = grid.recip_rA
    uT, vT = flow.uTrans, flow.vTrans
    compress = cfg.gadMultiDimCompressible

    maskW, maskS = fill_cs_corner_uv(grid.maskW, grid.maskS, n, ol,
                                     with_sign=False)

    localT = tracer
    if compress:
        # localVol = rA*deepFac2C*rhoFac*drF*hFacC + (1-maskC)
        localVol = (grid.rA * grid.drF[:, None, None] * grid.hFacC
                    + (1.0 - grid.maskC))

    nyp = n + 2 * ol

    def sel_fill(a, d, faces):
        # fill direction d, but only on the listed faces — the reference's
        # corner fills are per-tile, and pass-1 post-fills must PERSIST
        # into pass 2 on the faces that take the full-range update there
        if not faces:
            return a
        filled = fill_cs_corner(a, d, n, ol)
        if len(faces) == 6:
            return filled
        import numpy as _np
        m = _np.zeros((6, 1, 1))
        for f in faces:
            m[f] = 1.0
        m = jnp.asarray(_np.broadcast_to(m, (6, nyp, 1)).reshape(
            6 * nyp, 1), dtype)
        return m * filled + (1.0 - m) * a

    for p, (xm, ym, x_over_faces, y_over_faces) in enumerate(plans):
        xm = jnp.asarray(xm, dtype)
        ym = jnp.asarray(ym, dtype)
        # corner fills before the fluxes, on overlap-only faces exactly
        # as the reference sequences them per tile
        localT = sel_fill(localT, 1, x_over_faces)
        afx = adv_flux_x(cfg, grid, scheme, uT, u, localT, deltaT,
                         maskW) * kx
        if p == 0:
            localT = sel_fill(localT, 2, x_over_faces)
        localT = sel_fill(localT, 2, y_over_faces)
        afy = adv_flux_y(cfg, grid, scheme, vT, v, localT, deltaT,
                         maskS) * ky
        if p == 0:
            localT = sel_fill(localT, 1, y_over_faces)
        dafx = (sh(afx, di=1) - afx) * mIn
        duT = (sh(uT, di=1) - uT) * mIn
        dafy = (sh(afy, dj=1) - afy) * mIn
        dvT = (sh(vT, dj=1) - vT) * mIn
        if compress:
            tmpX = localT * localVol - deltaT * dafx
            volX = localVol - deltaT * duT
            tmpY = localT * localVol - deltaT * dafy
            volY = localVol - deltaT * dvT
            localT = (xm * tmpX / volX + ym * tmpY / volY
                      + (1.0 - xm - ym) * localT)
            localVol = xm * volX + ym * volY + (1.0 - xm - ym) * localVol
        else:
            updX = localT - deltaT * rhc * rdrF * rrA * (
                dafx - tracer * duT)
            updY = localT - deltaT * rhc * rdrF * rrA * (
                dafy - tracer * dvT)
            localT = xm * updX + ym * updY + (1.0 - xm - ym) * localT

    # vertical (gad_advection.F:938-1075): rTrans = w*rA*maskC(k-1),
    # zero at surface; flux kernels applied to the post-horizontal field
    mC = grid.maskC
    mkm1 = jnp.concatenate([mC[:1], mC[:-1]], axis=0)
    rT = w * grid.rA * mkm1
    rT = rT.at[0].set(0.0)
    rTKp = jnp.concatenate([rT[1:], jnp.zeros_like(rT[:1])], axis=0)
    fVer = adv_flux_r(cfg, grid, vert_scheme, rT, w, localT, deltaT)
    fVerKp = jnp.concatenate([fVer[1:], jnp.zeros_like(fVer[:1])], axis=0)
    if compress:
        tmpTrac = (localT * localVol
                   - deltaT * (fVerKp - fVer) * cfg.rkSign * mIn)
        localVol = localVol - deltaT * (rTKp - rT) * cfg.rkSign * mIn
        return ((tmpTrac - tracer * localVol)
                * rrA * rdrF * rhc / deltaT)
    localT = localT - deltaT * rhc * rdrF * rrA * (
        (fVerKp - fVer) - tracer * (rTKp - rT)) * cfg.rkSign * mIn
    return (localT - tracer) / deltaT
