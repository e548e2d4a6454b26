"""mitgcm_tpu — an ocean/atmosphere general circulation model in JAX.

A from-scratch reimplementation of the capabilities of MITgcm (reference:
Shreyas911/MITgcm, a fork of MITgcm adding Tapenade AD support) in idiomatic
JAX: finite-volume Arakawa C-grid hydrostatic primitive equations, implicit
free surface via a preconditioned conjugate-gradient barotropic solve, the
generic tracer advection scheme family, column physics (KPP/GM-Redi/GGL90),
sea ice, and a jax.grad-based adjoint/state-estimation stack.

Design:
  - fields are jnp arrays shaped [..., ny + 2*OLy, nx + 2*OLx] (k, j, i
    ordering; x innermost, so neighbouring threads read neighbouring
    addresses and loads coalesce),
    carrying a halo ring of width (OLy, OLx) that mirrors the reference's
    tile "overlap" regions (model/inc/SIZE.h:40-62).
  - halo exchange is a cyclic wrap fill (the reference WRAPPER topology is
    logically doubly periodic; land masks enforce walls —
    eesupp/src/exch_xy_rx.template), implemented as pure array ops on one
    device and as jax.lax.ppermute neighbor pulls under shard_map.
  - the full timestep is a single jit-compiled pure function State -> State;
    adjoints come from jax.grad + jax.checkpoint instead of TAF/Tapenade.
"""

__version__ = "0.1.0"

from mitgcm_tpu.core import config  # noqa: F401
