"""Three-dimensional preconditioned conjugate-gradient solver for the
non-hydrostatic pressure (phi_nh).

Reference: model/src/cg3d.F (solver) + model/src/ini_cg3d.F (7-point
operator and column-tridiagonal preconditioner).  Structure mirrors
solver/cg2d.py: the iteration is a jax.lax.while_loop whose body is one
fused XLA computation — 7-point operator, a vertical tridiagonal
forward/back substitution (two lax.scan's over levels, batched over the
whole horizontal plane), and two global reductions.  On a device mesh
the dots become psum and the halo refresh a ppermute.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import shift as sh
from mitgcm_tpu.ops.stencil import cyclic_fill_halo, interior_mask


class CG3DOperator(NamedTuple):
    """aW/aS/aV: 7-point operator coefficients ([nr,ny,nx]; aV[0]=0);
    aC: main diagonal; zMC/zML/zMU: LU-factored column tridiagonal
    preconditioner (ini_cg3d.F:236-280; zMC holds the reciprocal pivots);
    cg3dNorm: normalization (ini_cg3d.F myNorm)."""
    aW: jnp.ndarray
    aS: jnp.ndarray
    aV: jnp.ndarray
    aC: jnp.ndarray
    zMC: jnp.ndarray
    zML: jnp.ndarray
    zMU: jnp.ndarray
    cg3dNorm: jnp.ndarray
    tolerance_sq: jnp.ndarray


def build_cg3d(cfg: Config, grid: Grid) -> CG3DOperator:
    """ini_cg3d.F: face transmissibilities * implicitNHPress*implicDiv2Dflow."""
    dt = grid.rA.dtype
    nr = cfg.nr
    drF = grid.drF[:, None, None]
    imask = interior_mask(grid.rA.shape, cfg.oly, cfg.olx, dt,
                          n_faces=cfg.nFaces)

    fac = cfg.implicitNHPress * cfg.implicDiv2Dflow
    aW = grid.dyG * drF * grid.hFacW * grid.recip_dxC * fac
    aS = grid.dxG * drF * grid.hFacS * grid.recip_dyC * fac
    if cfg.useOBCS:
        aW = aW * grid.maskInC * sh(grid.maskInC, di=-1)
        aS = aS * grid.maskInC * sh(grid.maskInC, dj=-1)

    # vertical faces (ini_cg3d.F:92-110): nh_Fac = 1/nh_Am2,
    # rVel2wUnit = 1 in z-coords (no implicitIntGravWave support here)
    if cfg.implicitIntGravWave:
        raise NotImplementedError("implicitIntGravWave cg3d vertical term")
    nh_fac = 1.0 / cfg.nh_Am2 if cfg.nh_Am2 != 0.0 else 0.0
    tmpFac = 1.0 / nh_fac if nh_fac > 0.0 else 0.0
    recip_drC = grid.recip_drC[:, None, None]
    aV = (grid.rA[None] * grid.maskC
          * jnp.concatenate([jnp.zeros_like(grid.maskC[:1]),
                             grid.maskC[:-1]], axis=0)
          * recip_drC[:nr] * tmpFac * fac)
    aV = aV.at[0].set(0.0)
    if cfg.useOBCS:
        aV = aV * grid.maskInC[None]

    myNorm = jnp.maximum(
        jnp.max(jnp.abs(aW) * imask[None]),
        jnp.maximum(jnp.max(jnp.abs(aS) * imask[None]),
                    jnp.max(jnp.abs(aV) * imask[None])))
    myNorm = jnp.where(myNorm != 0.0, 1.0 / myNorm, 1.0)

    aE = sh(aW, di=1)
    aN = sh(aS, dj=1)
    aU = aV
    aL = jnp.concatenate([aV[1:], jnp.zeros_like(aV[:1])], axis=0)
    aC = -(aW + aE + aN + aS + aU + aL)
    # free-surface term on the surface-level diagonal (ini_cg3d.F:170-184)
    k3 = jnp.arange(nr)[:, None, None]
    selS = (k3 == (grid.kSurfC - 1)[None]) & (grid.kSurfC <= nr)[None]
    aC = aC - jnp.where(
        selS,
        cfg.freeSurfFac * grid.recip_Bo * grid.rA
        / cfg.deltaTMom / cfg.deltaTFreeSurf, 0.0)

    aW = aW * myNorm
    aS = aS * myNorm
    aV = aV * myNorm
    aC = aC * myNorm
    if cfg.nFaces == 1:
        fill = lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)  # noqa:E731
        aW, aS, aV, aC = fill(aW), fill(aS), fill(aV), fill(aC)

    # column tridiagonal preconditioner, LU-factored (ini_cg3d.F:236-280)
    dry = aC == 0.0
    zMC = jnp.where(dry, 1.0, aC)
    zML = jnp.where(dry, 0.0, aV)
    zMU = jnp.where(
        dry, 0.0,
        jnp.concatenate([aV[1:], jnp.zeros_like(aV[:1])], axis=0))

    def fwd(carry, t):
        mc, ml, mu = t
        mc = 1.0 / (mc - ml * carry)
        mu = mu * mc
        return mu, (mc, mu)

    _, (zMCs, zMUs) = jax.lax.scan(fwd, jnp.zeros_like(zMC[0]),
                                   (zMC, zML, zMU))
    zMC = jnp.where(dry, 1.0, zMCs)
    zMU = jnp.where(dry, 0.0, zMUs)
    zML = jnp.where(dry, 0.0, zML)
    if cfg.nFaces == 1:
        zMC, zML, zMU = fill(zMC), fill(zML), fill(zMU)

    if cfg.cg3dTargetResWunit <= 0.0:
        tol = jnp.asarray(cfg.cg3dTargetResidual, dt)
    else:
        tol = (myNorm * cfg.cg3dTargetResWunit * grid.globalArea
               / cfg.deltaTMom)
    return CG3DOperator(aW=aW, aS=aS, aV=aV, aC=aC,
                        zMC=zMC, zML=zML, zMU=zMU,
                        cg3dNorm=myNorm, tolerance_sq=tol * tol)


def _apply_A(op: CG3DOperator, x):
    """7-point operator (cg3d.F:150-170 residual stencil)."""
    up = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)
    dn = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)
    aVdn = jnp.concatenate([op.aV[1:], jnp.zeros_like(op.aV[:1])], axis=0)
    return (op.aW * sh(x, di=-1) + sh(op.aW, di=1) * sh(x, di=1)
            + op.aS * sh(x, dj=-1) + sh(op.aS, dj=1) * sh(x, dj=1)
            + op.aV * up + aVdn * dn + op.aC * x)


def _apply_P(op: CG3DOperator, r):
    """Column tridiagonal solve: forward substitution down the column,
    back substitution up (cg3d.F:205-260)."""
    def down(qkm1, t):
        rk, mc, ml = t
        qk = mc * (rk - ml * qkm1)
        return qk, qk

    _, qf = jax.lax.scan(down, jnp.zeros_like(r[0]), (r, op.zMC, op.zML))

    def up(qkp1, t):
        qk, mu = t
        qk = qk - mu * qkp1
        return qk, qk

    _, qb = jax.lax.scan(up, jnp.zeros_like(r[0]),
                         (qf[::-1], op.zMU[::-1]))
    return qb[::-1]


class CG3DResult(NamedTuple):
    x: jnp.ndarray
    first_residual: jnp.ndarray
    last_residual: jnp.ndarray
    n_iters: jnp.ndarray


def cg3d(cfg: Config, grid: Grid, op: CG3DOperator, b, x0,
         psum=None, fill=None, pmax=None) -> CG3DResult:
    """Differentiable preconditioned-CG solve (same implicit-function
    custom VJP as cg2d: A symmetric, x = A^-1 b, b_bar = A^-1 x_bar)."""

    @jax.custom_vjp
    def solve(b_in, x0_in, op_in, maskC):
        return _cg3d_raw(cfg, maskC, op_in, b_in, x0_in, psum, fill, pmax)

    def solve_fwd(b_in, x0_in, op_in, maskC):
        res = _cg3d_raw(cfg, maskC, op_in, b_in, x0_in, psum, fill, pmax)
        return res, (op_in, maskC)

    def solve_bwd(res, ct):
        op_in, maskC = res
        adj = _cg3d_raw(cfg, maskC, op_in, ct.x, jnp.zeros_like(ct.x),
                        psum, fill, pmax)
        # the operator and mask are arguments, not closures, so that they
        # may be traced arguments of the jitted model; zero gradient
        return (adj.x, jnp.zeros_like(adj.x),
                jax.tree.map(jnp.zeros_like, op_in), jnp.zeros_like(maskC))

    solve.defvjp(solve_fwd, solve_bwd)
    return solve(b, x0, op, grid.maskC)


def _cg3d_raw(cfg: Config, maskC, op: CG3DOperator, b, x0,
              psum=None, fill=None, pmax=None) -> CG3DResult:
    """cg3d.F solve of A x = b with warm start x0 (= previous phi_nh)."""
    dt = b.dtype
    oly, olx = cfg.oly, cfg.olx
    imask = interior_mask(b.shape[1:], oly, olx, dt,
                          n_faces=cfg.nFaces)[None] * maskC
    if psum is None:
        psum = lambda s: s  # noqa: E731
    if pmax is None:
        pmax = lambda s: s  # noqa: E731
    if fill is None:
        fill = lambda a: cyclic_fill_halo(a, oly, olx)  # noqa: E731

    def dot(a, c):
        return psum(jnp.sum(a * c * imask))

    # normalise RHS (cg3d.F:117-147); maskC applied to b with the norm
    b = b * op.cg3dNorm * imask
    normalise = cfg.cg3dTargetResWunit <= 0.0
    rhsMax = pmax(jnp.max(jnp.abs(b)))
    if normalise:
        rhsNorm = jnp.where(rhsMax != 0.0, 1.0 / rhsMax, 1.0)
        b = b * rhsNorm
        x0 = x0 * rhsNorm

    x = fill(x0)
    r = (b - _apply_A(op, x)) * imask
    r = fill(r)
    err_sq0 = dot(r, r)
    first_res = jnp.sqrt(err_sq0)
    tol_sq = op.tolerance_sq

    def cond(carry):
        it, x, r, s, eta_nm1, err_sq = carry
        return jnp.logical_and(err_sq >= tol_sq, it < cfg.cg3dMaxIters)

    def body(carry):
        it, x, r, s, eta_nm1, err_sq = carry
        q = _apply_P(op, r)
        eta_n = dot(q, r)
        beta = eta_n / eta_nm1
        s = fill((q + beta * s) * imask)
        q = _apply_A(op, s) * imask
        alpha = eta_n / dot(s, q)
        x = (x + alpha * s) * imask
        r = fill((r - alpha * q) * imask)
        return (it + 1, x, r, s, eta_n, dot(r, r))

    carry0 = (jnp.asarray(0, jnp.int32), x * imask, r, jnp.zeros_like(r),
              jnp.asarray(1.0, dt), err_sq0)
    it, x, r, s, eta, err_sq = jax.lax.while_loop(cond, body, carry0)

    if normalise:
        x = x / rhsNorm
    x = fill(x)
    return CG3DResult(x=x, first_residual=first_res,
                      last_residual=jnp.sqrt(err_sq), n_iters=it)
