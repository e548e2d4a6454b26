"""Distributed halo exchange: the WRAPPER on a device mesh.

Replaces the reference's eesupp EXCH engine (eesupp/src/exch_*.template:
pack edge -> MPI_Isend/Recv -> unpack, 2-phase x-then-y with corner fill)
with jax.lax.ppermute neighbor pulls inside shard_map over a 2-D device
mesh. The global tile topology is doubly periodic, exactly like the
reference WRAPPER; land masks enforce closed boundaries.

Phase 1 exchanges x-edges (full height), phase 2 exchanges y-edges
INCLUDING the freshly-filled x-halo columns, so corner halo cells are
correct after two phases — the same trick as the reference's exchange
ordering (eesupp/src/exch_rx_cube.template corner handling on the simple
Cartesian topology).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def exchange(a: jnp.ndarray, oly: int, olx: int,
             axis_y: str = "py", axis_x: str = "px") -> jnp.ndarray:
    """Fill the halo of a local padded array from mesh neighbors.

    Must be called inside shard_map with mesh axes (axis_y, axis_x).
    a: [..., ny_loc + 2*oly, nx_loc + 2*olx].
    """
    nyl = a.shape[-2] - 2 * oly
    nxl = a.shape[-1] - 2 * olx

    nx_dev = lax.axis_size(axis_x)
    ny_dev = lax.axis_size(axis_y)

    # --- phase 1: x-direction ---
    if nx_dev == 1:
        west = a[..., :, nxl:nxl + olx]
        east = a[..., :, olx:2 * olx]
        a = a.at[..., :, :olx].set(west)
        a = a.at[..., :, nxl + olx:].set(east)
    else:
        # send my east-most interior columns to my east neighbor's west halo
        east_edge = a[..., :, nxl:nxl + olx]
        west_edge = a[..., :, olx:2 * olx]
        fwd = [(i, (i + 1) % nx_dev) for i in range(nx_dev)]
        bwd = [(i, (i - 1) % nx_dev) for i in range(nx_dev)]
        from_west = lax.ppermute(east_edge, axis_x, fwd)
        from_east = lax.ppermute(west_edge, axis_x, bwd)
        a = a.at[..., :, :olx].set(from_west)
        a = a.at[..., :, nxl + olx:].set(from_east)

    # --- phase 2: y-direction (rows include x halos -> corners filled) ---
    if ny_dev == 1:
        south = a[..., nyl:nyl + oly, :]
        north = a[..., oly:2 * oly, :]
        a = a.at[..., :oly, :].set(south)
        a = a.at[..., nyl + oly:, :].set(north)
    else:
        north_edge = a[..., nyl:nyl + oly, :]
        south_edge = a[..., oly:2 * oly, :]
        fwd = [(i, (i + 1) % ny_dev) for i in range(ny_dev)]
        bwd = [(i, (i - 1) % ny_dev) for i in range(ny_dev)]
        from_south = lax.ppermute(north_edge, axis_y, fwd)
        from_north = lax.ppermute(south_edge, axis_y, bwd)
        a = a.at[..., :oly, :].set(from_south)
        a = a.at[..., nyl + oly:, :].set(from_north)
    return a


def psum_all(x, axis_y: str = "py", axis_x: str = "px"):
    """Global scalar reduction over the device mesh (replaces the
    reference's MPI_Allreduce in eesupp/src/global_sum_tile.F:182)."""
    return lax.psum(lax.psum(x, axis_x), axis_y)


def pmax_all(x, axis_y: str = "py", axis_x: str = "px"):
    """Global max (the reference's _GLOBAL_MAX_RL)."""
    return lax.pmax(lax.pmax(x, axis_x), axis_y)


def pad_local(a: jnp.ndarray, oly: int, olx: int) -> jnp.ndarray:
    """Zero-pad a local interior block out to halo-padded shape."""
    pad = [(0, 0)] * (a.ndim - 2) + [(oly, oly), (olx, olx)]
    return jnp.pad(a, pad)


def unpad_local(a: jnp.ndarray, oly: int, olx: int) -> jnp.ndarray:
    return a[..., oly:a.shape[-2] - oly, olx:a.shape[-1] - olx]
