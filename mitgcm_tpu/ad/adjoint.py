"""Adjoint / sensitivity machinery: jax.grad replaces TAF/Tapenade.

The reference's entire AD stack — source-to-source transformation
(tools/genmake2 `-tap` Tapenade pipeline), tape storage
(pkg/autodiff/autodiff_store.F + ADFirstAidKit adStack.c), 3-level
checkpoint loops (nchklev_* in code_ad/tamc.h), hand-written adjoint halo
exchanges (eesupp/src/exch_tap_b.F) — collapses here to reverse-mode
differentiation of the jitted timestep loop:

  - taping          -> XLA residual saving, shaped by jax.checkpoint
  - nchklev_1/2/3   -> nested jax.checkpoint over chunked lax.scan
  - adjoint exchange-> transpose of ppermute (automatic under shard_map)
  - adjoint of cg2d -> implicit-function custom VJP (solver/cg2d.py)
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.core.state import Forcing, State
from mitgcm_tpu.model import step as step_mod


def run_steps(cfg: Config, grid: Grid, op, state: State, forcing: Forcing,
              n_steps: int, checkpoint_chunks: Optional[int] = None,
              hooks: Optional[dict] = None, cs_fill=None, step_cost=None):
    """Run n_steps with adjoint-friendly checkpointing.

    checkpoint_chunks: number of outer checkpoint segments (the analog of
    the reference's nchklev_2 outer loop; tamc.h). None -> sqrt(n) chunking
    when n_steps > 8; each inner step is additionally rematerialized, so
    peak memory is O(chunk + n/chunk) states.

    hooks: package objects forwarded to forward_step (kpp/ggl90/vmix/
    opps/seaice/obcs); cs_fill: cubed-sphere exchange object.

    step_cost: optional f(state_after_step, myIter) -> scalar, accumulated
    over all steps (the COST_TILE hook at the end of each forward_step,
    forward_step.F:1197).  When given, returns (final_state, cost_sum).
    """
    kw = {k: v for k, v in (hooks or {}).items() if v is not None}
    if cs_fill is not None:
        kw.update(fill=cs_fill.fill, fill_uv=cs_fill.fill_uv,
                  fill_uv_cg=cs_fill.fill_uv_cg)

    def body(carry, myIter):
        new_state, _ = step_mod.forward_step(
            cfg, grid, op, carry, forcing, myIter, **kw)
        return new_state, None

    if n_steps <= 4:
        s = state
        acc = jnp.zeros((), state.theta.dtype)
        for i in range(n_steps):
            s, _ = body(s, jnp.asarray(cfg.nIter0 + i))
            if step_cost is not None:
                acc = acc + step_cost(s, cfg.nIter0 + i)
        return (s, acc) if step_cost is not None else s

    chunks = checkpoint_chunks or max(1, int(math.sqrt(n_steps)))
    chunk_len = -(-n_steps // chunks)
    # pad the iteration list to chunks*chunk_len; padded steps are no-ops
    n_pad = chunks * chunk_len
    iters = cfg.nIter0 + jnp.arange(n_pad)
    valid = jnp.arange(n_pad) < n_steps

    def body_masked(carry, inp):
        st, acc = carry
        myIter, ok = inp
        new_state, _ = step_mod.forward_step(
            cfg, grid, op, st, forcing, myIter, **kw)
        out = jax.tree.map(
            lambda a, b: jnp.where(ok, a, b), new_state, st)
        if step_cost is not None:
            acc = acc + jnp.where(ok, step_cost(out, myIter), 0.0)
        return (out, acc), None

    body_ckpt2 = jax.checkpoint(body_masked)

    def inner2(carry, inp):
        s, _ = jax.lax.scan(body_ckpt2, carry, inp)
        return s, None

    (s, acc), _ = jax.lax.scan(
        jax.checkpoint(inner2),
        (state, jnp.zeros((), state.theta.dtype)),
        (iters.reshape(chunks, chunk_len), valid.reshape(chunks, chunk_len)))
    return (s, acc) if step_cost is not None else s


# ----------------------------------------------------------------------
# control vector (pkg/ctrl analog)
# ----------------------------------------------------------------------

class Control:
    """A generic 3-D initial-condition control (xx_genarr3d analog,
    pkg/ctrl/ctrl_map_genarr.F): an additive perturbation on one state
    field, masked to wet points."""

    def __init__(self, cfg: Config, grid: Grid, field: str = "theta"):
        self.cfg, self.grid, self.field = cfg, grid, field

    def zero(self, dtype=jnp.float64):
        nyp = self.cfg.ny + 2 * self.cfg.oly
        nxp = self.cfg.nx + 2 * self.cfg.olx
        return jnp.zeros((self.cfg.nr, nyp, nxp), dtype)

    def apply(self, state: State, xx, grid: Optional[Grid] = None):
        mask = (grid if grid is not None else self.grid).maskC
        new = getattr(state, self.field) + xx * mask
        return State(**{**state.__dict__, self.field: new})

    def pack(self, xx):
        """Flat wet-point vector (ctrl_pack.F / ctrl_set_pack_xyz.F)."""
        wet = self.grid.maskC > 0
        return xx[wet]

    def unpack(self, vec):
        wet = self.grid.maskC > 0
        return self.zero(vec.dtype).at[wet].set(vec)


# ----------------------------------------------------------------------
# cost functions (pkg/cost / pkg/ecco gencost analog)
# ----------------------------------------------------------------------

def cost_boxmean_tracer(cfg: Config, grid: Grid, field: str = "theta",
                        box=None, k_range=None):
    """Volume integral of a tracer over a box at the final state — the
    tutorial_tracer_adjsens-style objective (its cost_tracer.F computes a
    volume-weighted tracer integral)."""
    oly, olx = cfg.oly, cfg.olx

    def fc(state: State, grid: Grid = grid):
        arr = getattr(state, field)
        vol = (grid.rA * grid.drF[:, None, None] * grid.hFacC)
        w = jnp.zeros_like(vol)
        j0, j1, i0, i1 = box if box else (0, cfg.ny, 0, cfg.nx)
        k0, k1 = k_range if k_range else (0, cfg.nr)
        w = w.at[k0:k1, oly + j0:oly + j1, olx + i0:olx + i1].set(1.0)
        w = w * (grid.maskC > 0)
        return jnp.sum(arr * vol * w)

    return fc


def make_objective(cfg: Config, grid: Grid, op, forcing: Forcing,
                   state0: State, control: Control, cost_fn: Callable,
                   n_steps: int):
    """J(xx): apply control, run, evaluate cost_fn(state, grid). jax.grad
    of this is the adjoint model (ADTHE_MAIN_LOOP analog).

    J is compiled with the grid, operator, forcing and initial state as
    arguments: arrays a jitted function closes over are written into the
    compiled program as literals."""

    @jax.jit
    def J(xx, grid, op, forcing, state0):
        s = control.apply(state0, xx, grid)
        s = run_steps(cfg, grid, op, s, forcing, n_steps)
        return cost_fn(s, grid)

    return partial(J, grid=grid, op=op, forcing=forcing, state0=state0)


def adjoint_gradient(objective: Callable, xx):
    """cost and dJ/dxx — the packed adjoint sensitivity field."""
    return jax.value_and_grad(objective)(xx)
