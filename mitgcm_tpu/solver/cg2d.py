"""Two-dimensional preconditioned conjugate-gradient solver.

Reference: model/src/cg2d.F (solver), model/src/ini_cg2d.F (operator and
preconditioner build). The iteration is a jax.lax.while_loop whose body is
one fused XLA computation: 5-point operator + preconditioner + three global
reductions; on a device mesh the dot products become jax.lax.psum and
the halo refresh a ppermute — replacing the reference's per-iteration
MPI_Allreduce + halo exchange (cg2d.F:243,264,295,327).

The reverse-mode derivative of a converged CG solve is another CG solve
with the same (symmetric) operator; a custom VJP below implements that
implicit-function adjoint, replacing the reference's cg2d_nsa.F / TAF
store-restore machinery.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import shift as sh
from mitgcm_tpu.ops.stencil import cyclic_fill_halo, interior_mask


class CG2DOperator(NamedTuple):
    """aW/aS/aC: 5-point operator; pW/pS/pC: preconditioner; cg2dNorm: the
    normalization factor (ini_cg2d.F myNorm)."""
    aW: jnp.ndarray
    aS: jnp.ndarray
    aC: jnp.ndarray
    pW: jnp.ndarray
    pS: jnp.ndarray
    pC: jnp.ndarray
    cg2dNorm: jnp.ndarray
    tolerance_sq: jnp.ndarray


def build_cg2d(cfg: Config, grid: Grid) -> CG2DOperator:
    """ini_cg2d.F: vertically-integrated transmissibilities + SOR-ish precond."""
    dt = grid.rA.dtype
    drF = grid.drF[:, None, None]
    imask = interior_mask(grid.rA.shape, cfg.oly, cfg.olx, dt,
                          n_faces=cfg.nFaces)

    fac = cfg.implicSurfPress * cfg.implicDiv2Dflow
    # level-by-level accumulation in the reference's k-ascending order
    # (ini_cg2d.F:88-103): aW += fac*faceArea*recip_dxC per level
    termW = grid.dyG * drF * grid.hFacW * fac * grid.recip_dxC
    termS = grid.dxG * drF * grid.hFacS * fac * grid.recip_dyC
    aW = jnp.zeros_like(grid.rA)
    aS = jnp.zeros_like(grid.rA)
    for k in range(cfg.nr):
        aW = aW + termW[k]
        aS = aS + termS[k]

    # OBCS: open the matrix only inside the OB interior (ini_cg2d.F:104-109,
    # applied before the norm); without OBCS maskInC is the wet-column mask
    # and the product is a no-op on the wet-wet faces where aW/aS live
    aW = aW * grid.maskInC * sh(grid.maskInC, di=-1)
    aS = aS * grid.maskInC * sh(grid.maskInC, dj=-1)

    myNorm = jnp.maximum(
        jnp.max(jnp.abs(aW) * imask), jnp.max(jnp.abs(aS) * imask))
    myNorm = jnp.where(myNorm != 0.0, 1.0 / myNorm, 1.0)
    aW = aW * myNorm
    aS = aS * myNorm
    # halo values: on the cubed sphere the pointwise products above are
    # already correct in the halos (every grid factor was CS-exchanged, so
    # the padded columns hold the neighbor face's local-frame
    # coefficients — the reference never exchanges aW/aS, it computes
    # them on the extended range, update_cg2d.F:67-75); a cyclic wrap
    # would OVERWRITE them with same-face data. Only the single-face
    # cyclic topology needs the wrap.
    if cfg.nFaces == 1:
        aW = cyclic_fill_halo(aW, cfg.oly, cfg.olx)
        aS = cyclic_fill_halo(aS, cfg.oly, cfg.olx)

    # main diagonal (ini_cg2d.F:182-195); deepFac2F(ksurf)=1
    freeSurfFac = cfg.freeSurfFac
    aC = -(
        aW + sh(aW, di=1) + aS + sh(aS, dj=1)
        + freeSurfFac * myNorm * grid.recip_Bo * grid.rA
        / cfg.deltaTMom / cfg.deltaTFreeSurf
    )
    if cfg.nFaces == 1:
        aC = cyclic_fill_halo(aC, cfg.oly, cfg.olx)

    aCw = sh(aC, di=-1)
    aCs = sh(aC, dj=-1)
    pC = jnp.where(aC == 0.0, 1.0, 1.0 / jnp.where(aC == 0.0, 1.0, aC))
    offFac = cfg.cg2dpcOffDFac
    pW = jnp.where(
        aC + aCw == 0.0, 0.0,
        -aW / jnp.where(aC + aCw == 0.0, 1.0, (offFac * (aCw + aC)) ** 2))
    pS = jnp.where(
        aC + aCs == 0.0, 0.0,
        -aS / jnp.where(aC + aCs == 0.0, 1.0, (offFac * (aCs + aC)) ** 2))
    if cfg.nFaces == 1:
        pC = cyclic_fill_halo(pC, cfg.oly, cfg.olx)
        pW = cyclic_fill_halo(pW, cfg.oly, cfg.olx)
        pS = cyclic_fill_halo(pS, cfg.oly, cfg.olx)

    # tolerance (ini_cg2d.F:150-162): normalised-RHS mode when
    # cg2dTargetResWunit <= 0 (the default)
    if cfg.cg2dTargetResWunit <= 0.0:
        tol = jnp.asarray(cfg.cg2dTargetResidual, dt)
    else:
        tol = (myNorm * cfg.cg2dTargetResWunit * grid.globalArea
               / cfg.deltaTMom)
    return CG2DOperator(aW=aW, aS=aS, aC=aC, pW=pW, pS=pS, pC=pC,
                        cg2dNorm=myNorm, tolerance_sq=tol * tol)


def _apply_A(op: CG2DOperator, x):
    return (op.aW * sh(x, di=-1) + sh(op.aW, di=1) * sh(x, di=1)
            + op.aS * sh(x, dj=-1) + sh(op.aS, dj=1) * sh(x, dj=1)
            + op.aC * x)


def _apply_P(op: CG2DOperator, r):
    return (op.pC * r
            + op.pW * sh(r, di=-1) + sh(op.pW, di=1) * sh(r, di=1)
            + op.pS * sh(r, dj=-1) + sh(op.pS, dj=1) * sh(r, dj=1))


class CG2DResult(NamedTuple):
    x: jnp.ndarray
    first_residual: jnp.ndarray
    last_residual: jnp.ndarray
    n_iters: jnp.ndarray


def _dot_seq_fortran(cfg: Config, v):
    """Bit-exact replica of the reference's CG dot-product summation
    order: per-tile sequential accumulation with i fastest / j outer
    (cg2d.F:161-178 errTile loops), then tile partials combined bj-outer
    / bi-inner (eesupp/src/global_sum_tile.F).

    The CG iteration amplifies last-bit differences in these reductions
    by ~1e4 per solve on stiff configs (measured: a 1e-15 relative state
    perturbation moves the converged eta by 1e-11 relative on
    tutorial_global_oce_in_p), so a tree-reduction jnp.sum caps the
    achievable digit match; this sequential form restores bit equality.
    Single-face (Cartesian/spherical) layouts only."""
    oly, olx = cfg.oly, cfg.olx
    ny, nx = cfg.ny, cfg.nx
    inter = v[oly:oly + ny, olx:olx + nx]
    sNy = cfg.sNy if (cfg.sNy and ny % cfg.sNy == 0) else ny
    sNx = cfg.sNx if (cfg.sNx and nx % cfg.sNx == 0) else nx
    nSy, nSx = ny // sNy, nx // sNx
    tiles = inter.reshape(nSy, sNy, nSx, sNx).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(nSy * nSx, sNy * sNx)

    def add(acc, x):
        return acc + x, None

    def tile_sum(row):
        s, _ = jax.lax.scan(add, jnp.zeros((), v.dtype), row)
        return s

    parts = jax.vmap(tile_sum)(tiles)
    total, _ = jax.lax.scan(add, jnp.zeros((), v.dtype), parts)
    return total


def cg2d(cfg: Config, grid: Grid, op: CG2DOperator, b, x0,
         psum=None, fill=None, pmax=None) -> CG2DResult:
    """Differentiable preconditioned-CG solve.

    Forward pass is `_cg2d_raw` below. Reverse mode uses the
    implicit-function theorem: the solve is linear in b (the RHS
    normalization cancels), and A is symmetric, so the VJP of x = A^-1 b
    is b_bar = A^-1 x_bar — one more CG solve with the same operator.
    This replaces the reference's TAF store/restore machinery around
    cg2d.F (and the cg2d_nsa.F variant built for differentiability);
    the initial guess x0 gets zero gradient (the converged solution is
    independent of it), and the residual diagnostics are non-differentiable
    auxiliaries. The operator is an argument of the rule, not a closure,
    so that it may be a traced argument of the jitted model; like the
    reference's cg2d adjoint it gets zero gradient.
    """

    @jax.custom_vjp
    def solve(b_in, x0_in, op_in):
        return _cg2d_raw(cfg, op_in, b_in, x0_in, psum, fill, pmax)

    def solve_fwd(b_in, x0_in, op_in):
        res = _cg2d_raw(cfg, op_in, b_in, x0_in, psum, fill, pmax)
        return res, op_in

    def solve_bwd(op_in, ct):
        xbar = ct.x
        adj = _cg2d_raw(cfg, op_in, xbar, jnp.zeros_like(xbar),
                        psum, fill, pmax)
        return (adj.x, jnp.zeros_like(adj.x),
                jax.tree.map(jnp.zeros_like, op_in))

    solve.defvjp(solve_fwd, solve_bwd)
    return solve(b, x0, op)


def _cg2d_raw(cfg: Config, op: CG2DOperator, b, x0,
              psum=None, fill=None, pmax=None) -> CG2DResult:
    """Solve A x = b with first guess x0 (cg2d.F).

    psum: global-sum hook (identity on one device, lax.psum under
    shard_map). fill: halo exchange hook (cyclic wrap by default).
    b, x0: halo-padded 2-D arrays. Interior-only dot products.
    """
    dt = b.dtype
    oly, olx = cfg.oly, cfg.olx
    imask = interior_mask(b.shape, oly, olx, dt, n_faces=cfg.nFaces)
    if psum is None:
        psum = lambda s: s
    if pmax is None:
        pmax = lambda s: s
    if fill is None:
        fill = lambda a: cyclic_fill_halo(a, oly, olx)

    if cfg.cg2dExactSums and cfg.nFaces == 1:
        def dot(a, c):
            return psum(_dot_seq_fortran(cfg, a * c * imask))
    else:
        def dot(a, c):
            return psum(jnp.sum(a * c * imask))

    # normalise RHS (cg2d.F:105-135)
    b = b * op.cg2dNorm
    rhsMax = pmax(jnp.max(jnp.abs(b) * imask))
    normalise = cfg.cg2dTargetResWunit <= 0.0
    if normalise:
        rhsNorm = jnp.where(rhsMax != 0.0, 1.0 / rhsMax, 1.0)
        b = b * rhsNorm
        x0 = x0 * rhsNorm

    x = fill(x0)
    r = (b - _apply_A(op, x)) * imask
    r = fill(r)
    err_sq0 = dot(r, r)
    first_res = jnp.sqrt(err_sq0)

    use_min = cfg.cg2dUseMinResSol == 1
    tol_sq = op.tolerance_sq

    def cond(carry):
        it, x, r, s, eta_nm1, err_sq, x_min, min_err = carry
        return jnp.logical_and(err_sq >= tol_sq, it < cfg.cg2dMaxIters)

    def body(carry):
        it, x, r, s, eta_nm1, err_sq, x_min, min_err = carry
        q = _apply_P(op, r) * imask
        eta_n = dot(q, r)
        beta = eta_n / eta_nm1
        s = (q + beta * s) * imask
        s = fill(s)
        q = _apply_A(op, s) * imask
        alpha = eta_n / dot(s, q)
        x = (x + alpha * s) * imask
        r = (r - alpha * q) * imask
        new_err = dot(r, r)
        if use_min:
            better = new_err < min_err
            x_min = jnp.where(better, x, x_min)
            min_err = jnp.where(better, new_err, min_err)
        r = fill(r)
        return (it + 1, x, r, s, eta_n, new_err, x_min, min_err)

    carry0 = (
        jnp.asarray(0, jnp.int32), x * imask, r, jnp.zeros_like(r),
        jnp.asarray(1.0, dt), err_sq0, x * imask, err_sq0,
    )
    it, x, r, s, eta, err_sq, x_min, min_err = jax.lax.while_loop(
        cond, body, carry0)

    if use_min:
        x = jnp.where(err_sq > min_err, x_min, x)
    if normalise:
        x = x / rhsNorm
    x = fill(x)
    return CG2DResult(
        x=x, first_residual=first_res, last_residual=jnp.sqrt(err_sq),
        n_iters=it)


def update_cg2d(cfg: Config, grid: Grid, op0: CG2DOperator,
                fill=None) -> CG2DOperator:
    """Rebuild the elliptic operator from the current (r*-scaled) hFac
    (model/src/update_cg2d.F, called when nonlinFreeSurf > 2). The
    normalisation factor and tolerance are fixed at their startup values;
    the preconditioner is refreshed every cg2dPreCondFreq steps (default
    1, so unconditionally here). Pure jnp: runs inside the jitted step.
    """
    if cfg.nFaces > 1:
        # see build_cg2d: pointwise halo values are already the correct
        # neighbor-face local-frame coefficients
        fill = lambda a: a                                      # noqa:E731
    elif fill is None:
        fill = lambda a: cyclic_fill_halo(a, cfg.oly, cfg.olx)  # noqa:E731
    drF = grid.drF[:, None, None]
    # update_cg2d.F:42-95: accumulate faceArea*recip_dxC per level, then
    # scale once by cg2dNorm*implicSurfPress*implicDiv2Dflow (this
    # ordering differs from ini_cg2d.F and is what restart runs use)
    accW = jnp.zeros_like(grid.rA)
    accS = jnp.zeros_like(grid.rA)
    for k in range(cfg.nr):
        accW = accW + (grid.dyG * drF[k] * grid.hFacW[k]) * grid.recip_dxC
        accS = accS + (grid.dxG * drF[k] * grid.hFacS[k]) * grid.recip_dyC
    fac = cfg.implicSurfPress * cfg.implicDiv2Dflow
    aW = accW * op0.cg2dNorm * fac * grid.maskInC * sh(grid.maskInC, di=-1)
    aS = accS * op0.cg2dNorm * fac * grid.maskInC * sh(grid.maskInC, dj=-1)
    aW = fill(aW)
    aS = fill(aS)
    aC = -(
        aW + sh(aW, di=1) + aS + sh(aS, dj=1)
        + cfg.freeSurfFac * op0.cg2dNorm * grid.recip_Bo * grid.rA
        / cfg.deltaTMom / cfg.deltaTFreeSurf
    )
    aC = fill(aC)
    aCw = sh(aC, di=-1)
    aCs = sh(aC, dj=-1)
    pC = jnp.where(aC == 0.0, 1.0, 1.0 / jnp.where(aC == 0.0, 1.0, aC))
    offFac = cfg.cg2dpcOffDFac
    pW = jnp.where(
        aC + aCw == 0.0, 0.0,
        -aW / jnp.where(aC + aCw == 0.0, 1.0, (offFac * (aCw + aC)) ** 2))
    pS = jnp.where(
        aC + aCs == 0.0, 0.0,
        -aS / jnp.where(aC + aCs == 0.0, 1.0, (offFac * (aCs + aC)) ** 2))
    pC = fill(pC)
    pW = fill(pW)
    pS = fill(pS)
    return CG2DOperator(aW=aW, aS=aS, aC=aC, pW=pW, pS=pS, pC=pC,
                        cg2dNorm=op0.cg2dNorm,
                        tolerance_sq=op0.tolerance_sq)
