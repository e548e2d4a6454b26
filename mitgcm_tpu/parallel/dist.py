"""Distributed runner: shard_map domain decomposition over a device mesh.

The analog of the reference's nPx x nPy process grid
(eesupp/src/ini_procs.F MPI_CART_CREATE): the horizontal domain is tiled
over a 2-D jax.sharding.Mesh ("py","px"); every field is stored as stacked
per-device halo-padded local blocks [npy, npx, ..., nyl+2oly, nxl+2olx],
so grid metrics carry their halos statically and only prognostic fields
are exchanged (lax.ppermute) each step — mirroring the reference's
one-blocking-exchange-per-step design (model/src/do_fields_blocking_exchanges.F).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.core.state import Forcing, State
from mitgcm_tpu.model import step as step_mod
from mitgcm_tpu.parallel import halo


def choose_layout(n_devices: int, ny: int, nx: int) -> Tuple[int, int]:
    """Pick (npy, npx) with npy*npx = n, each dividing the domain evenly."""
    best = None
    for npy in range(1, n_devices + 1):
        if n_devices % npy:
            continue
        npx = n_devices // npy
        if ny % npy or nx % npx:
            continue
        score = abs(npy - npx)
        if best is None or score < best[0]:
            best = (score, npy, npx)
    if best is None:
        raise ValueError(f"cannot tile {ny}x{nx} over {n_devices} devices")
    return best[1], best[2]


def tile_with_halo(a, npy: int, npx: int, oly: int, olx: int):
    """Global halo-padded array -> stacked local halo-padded blocks.

    a: [..., ny+2oly, nx+2olx] -> [npy, npx, ..., nyl+2oly, nxl+2olx].
    Local halos are copied from the (already exchanged) global array, so
    static fields never need a runtime exchange.
    """
    a = np.asarray(a)
    if a.ndim < 2:   # 1-D vertical profiles & scalars: replicate
        return np.broadcast_to(a, (npy, npx) + a.shape).copy()
    ny = a.shape[-2] - 2 * oly
    nx = a.shape[-1] - 2 * olx
    nyl, nxl = ny // npy, nx // npx
    blocks = np.empty((npy, npx) + a.shape[:-2] + (nyl + 2 * oly, nxl + 2 * olx),
                      dtype=a.dtype)
    for iy in range(npy):
        for ix in range(npx):
            blocks[iy, ix] = a[..., iy * nyl:iy * nyl + nyl + 2 * oly,
                               ix * nxl:ix * nxl + nxl + 2 * olx]
    return blocks


def untile(blocks, oly: int, olx: int):
    """Stacked local blocks -> global interior [..., ny, nx]."""
    blocks = np.asarray(blocks)
    npy, npx = blocks.shape[:2]
    core = blocks[..., oly:blocks.shape[-2] - oly, olx:blocks.shape[-1] - olx]
    rows = [np.concatenate(list(core[iy]), axis=-1) for iy in range(npy)]
    return np.concatenate(rows, axis=-2)


class DistModel:
    """Sharded model: same numerics, ppermute halos, psum reductions.

    Column-physics packages (KPP, GGL90, PP81/MY82) ride along: their
    instance objects are cloned per-shard at trace time with the local
    grid block (and local precomputed 2-D fields like KPP's kmtj)
    substituted — the schemes themselves are column-local + fixed-width
    stencils, so no extra exchanges are needed beyond the state halos."""

    def __init__(self, cfg: Config, grid: Grid, op, mesh: Mesh,
                 kpp=None, ggl90=None, vmix=None):
        self.cfg, self.mesh = cfg, mesh
        npy = mesh.shape["py"]
        npx = mesh.shape["px"]
        self.npy, self.npx = npy, npx
        t = partial(tile_with_halo, npy=npy, npx=npx,
                    oly=cfg.oly, olx=cfg.olx)
        spec = P("py", "px")
        sh = NamedSharding(mesh, spec)
        self.grid = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(t(a)), sh), grid)
        self.op = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(t(a)), sh), op)
        self.kpp, self.ggl90, self.vmix = kpp, ggl90, vmix
        put = lambda a: jax.device_put(jnp.asarray(t(a)), sh)
        self._kpp_kmtj = put(kpp.kmtj) if kpp is not None else None
        self._ggl90_klowC = put(ggl90.klowC) if ggl90 is not None else None
        self._step = None

    @classmethod
    def from_experiment(cls, exp, mesh: Mesh) -> "DistModel":
        """Shard a reference-deck Experiment (grid, cg2d operator and any
        column-physics packages) over the mesh.  Cubed-sphere decks go
        through DistCSModel (one face per device) instead."""
        if exp.cs_fill is not None:
            raise NotImplementedError(
                "cubed-sphere decks shard by face: use DistCSModel")
        if exp.seaice is not None:
            raise NotImplementedError(
                "distributed seaice on the lat-lon tiling not wired yet")
        return cls(exp.cfg, exp.grid, exp.op, mesh, kpp=exp.kpp,
                   ggl90=exp.ggl90, vmix=exp.vmix)

    def shard(self, pytree):
        t = partial(tile_with_halo, npy=self.npy, npx=self.npx,
                    oly=self.cfg.oly, olx=self.cfg.olx)
        sh = NamedSharding(self.mesh, P("py", "px"))
        return jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(t(a)), sh), pytree)

    def step_fn(self):
        if self._step is not None:
            return self._step
        cfg = self.cfg
        oly, olx = cfg.oly, cfg.olx

        def fill(a):
            return halo.exchange(a, oly, olx)

        def psum(x):
            return halo.psum_all(x)

        def pmax(x):
            return halo.pmax_all(x)

        kpp_t, ggl90_t, vmix_t = self.kpp, self.ggl90, self.vmix

        def local_step(grid_blk, op_blk, state_blk, forcing_blk,
                       aux_blk, myIter):
            import copy
            sq = lambda a: a.reshape(a.shape[2:])
            grid_l = jax.tree.map(sq, grid_blk)
            op_l = jax.tree.map(sq, op_blk)
            state_l = jax.tree.map(sq, state_blk)
            forcing_l = jax.tree.map(sq, forcing_blk)
            kpp_l = ggl90_l = vmix_l = None
            if kpp_t is not None:
                kpp_l = copy.copy(kpp_t)
                kpp_l.grid = grid_l
                kpp_l.kmtj = sq(aux_blk["kpp_kmtj"])
            if ggl90_t is not None:
                ggl90_l = copy.copy(ggl90_t)
                ggl90_l.grid = grid_l
                ggl90_l.klowC = sq(aux_blk["ggl90_klowC"])
            if vmix_t is not None:
                vmix_l = copy.copy(vmix_t)
                vmix_l.grid = grid_l
            new_state, diag = step_mod.forward_step(
                cfg, grid_l, op_l, state_l, forcing_l, myIter,
                fill=fill, psum=psum, pmax=pmax,
                kpp=kpp_l, ggl90=ggl90_l, vmix=vmix_l)
            unsq = lambda a: a.reshape((1, 1) + a.shape)
            # forc snapshots are per-shard; drop them (out_spec P())
            return jax.tree.map(unsq, new_state), diag._replace(forc=None)

        blk = P("py", "px")
        step = jax.jit(jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(blk, blk, blk, blk, blk, P()),
            out_specs=(blk, P()),
            check_vma=False,
        ))
        self._step = step
        return step

    def _aux(self):
        aux = {}
        if self._kpp_kmtj is not None:
            aux["kpp_kmtj"] = self._kpp_kmtj
        if self._ggl90_klowC is not None:
            aux["ggl90_klowC"] = self._ggl90_klowC
        return aux

    def run(self, state_blocks, forcing_blocks, n_steps: int,
            n_iter0: int = 0):
        step = self.step_fn()
        diags = []
        for i in range(n_steps):
            state_blocks, diag = step(
                self.grid, self.op, state_blocks, forcing_blocks,
                self._aux(), jnp.asarray(n_iter0 + i))
            diags.append(diag)
        return state_blocks, diags


# ---------------------------------------------------------------------------
# Cubed sphere: one face per device
# ---------------------------------------------------------------------------

class CSDistFills:
    """CS exchange hooks usable INSIDE shard_map over a "face" axis.

    Strategy: all_gather the 6 face blocks (one collective), apply the
    exact single-host CSExchange gather maps on the assembled
    [..., 6, nyp, nxp] array, then keep only this shard's face —
    bit-identical to the single-host fills by construction.  The
    gathered strips a fill actually consumes live within 2*ol cells of
    the face edges, so an edge-strip all_gather is the obvious follow-up
    optimisation; what the full-block gather costs is not measured."""

    def __init__(self, ex, axis: str = "face"):
        self.ex = ex
        self.axis = axis

    def _gather(self, a):
        return jax.lax.all_gather(a, self.axis, axis=a.ndim - 2)

    def _own(self, a):
        f = jax.lax.axis_index(self.axis)
        return jnp.take(a, f, axis=a.ndim - 3)

    def fill(self, a):
        return self._own(self.ex.fill_C(self._gather(a)))

    def fill_uv(self, u, v, with_sign=True):
        uf, vf = self.ex.fill_UV_cgrid(self._gather(u), self._gather(v),
                                       with_sign)
        return self._own(uf), self._own(vf)

    def fill_uv_cg(self, u, v, with_sign=True):
        uf, vf = self.ex.fill_UV_cg(self._gather(u), self._gather(v),
                                    with_sign)
        return self._own(uf), self._own(vf)

    def fill_z(self, a):
        return self._own(self.ex.fill_Z(self._gather(a)))


class DistCSModel:
    """Cubed-sphere sharded model: mesh axis "face" (size 6), one cube
    face per device.

    The per-shard step runs the UNMODIFIED single-face numerics: the
    local config clears nFaces to 1 and sets csLocalFace so the
    cube-corner code paths (FILL_CS_CORNER_*, corner vorticity stencils)
    still fire on the face block, while every `for f in range(nFaces)`
    face loop collapses to the one local block.  Cross-face halos ride
    CSDistFills (all_gather + the single-host CSExchange index maps);
    global reductions are lax.psum/pmax over the face axis — the
    replacement for the reference's EXCH2 cube topology +
    MPI_Allreduce (pkg/exch2/, eesupp/src/global_sum_tile.F)."""

    AXIS = "face"

    def __init__(self, exp, mesh: Mesh):
        import dataclasses as _dc
        if exp.cs_fill is None:
            raise ValueError("DistCSModel needs a cubed-sphere deck")
        cfg = exp.cfg
        if mesh.shape[self.AXIS] != cfg.nFaces:
            raise ValueError(
                f"mesh axis '{self.AXIS}' must have {cfg.nFaces} devices")
        self.cfg = cfg
        self.cfg_local = _dc.replace(cfg, nFaces=1, csLocalFace=True)
        self.mesh = mesh
        self.ex = exp.cs_fill.ex
        self.nyp = cfg.ny + 2 * cfg.oly
        self.exp = exp
        sh = NamedSharding(mesh, P(self.AXIS))
        put = lambda a: jax.device_put(self._tile(a), sh)
        self.grid = jax.tree.map(put, exp.grid)
        self.op = jax.tree.map(put, exp.op)
        self._step = None

    def _tile(self, a):
        """Global stacked [..., 6*nyp, nxp] -> [6, ..., nyp, nxp];
        profiles/scalars replicate."""
        a = np.asarray(a)
        if a.ndim >= 2 and a.shape[-2] == 6 * self.nyp:
            faces = a.reshape(a.shape[:-2] + (6, self.nyp, a.shape[-1]))
            return jnp.asarray(np.moveaxis(faces, -3, 0))
        return jnp.asarray(np.broadcast_to(a, (6,) + a.shape))

    def shard(self, pytree):
        sh = NamedSharding(self.mesh, P(self.AXIS))
        return jax.tree.map(
            lambda a: jax.device_put(self._tile(a), sh), pytree)

    def gather(self, blocks):
        """[6, ..., nyp, nxp] device blocks -> global stacked array."""
        b = np.asarray(blocks)
        return np.moveaxis(b, 0, -3).reshape(
            b.shape[1:-2] + (6 * self.nyp, b.shape[-1]))

    def step_fn(self):
        if self._step is not None:
            return self._step
        cfgl = self.cfg_local
        fills = CSDistFills(self.ex, self.AXIS)
        axis = self.AXIS
        seaice_p = None if self.exp.seaice is None else self.exp.seaice.p

        def psum(x):
            return jax.lax.psum(x, axis)

        def pmax(x):
            return jax.lax.pmax(x, axis)

        def local_step(grid_blk, op_blk, state_blk, forcing_blk, myIter):
            sq = lambda a: a.reshape(a.shape[1:])
            grid_l = jax.tree.map(sq, grid_blk)
            op_l = jax.tree.map(sq, op_blk)
            state_l = jax.tree.map(sq, state_blk)
            forcing_l = jax.tree.map(sq, forcing_blk)
            seaice_l = None
            if seaice_p is not None:
                from mitgcm_tpu.model import seaice as seaice_mod
                seaice_l = seaice_mod.SeaIce(cfgl, grid_l, seaice_p,
                                             fills=fills)
            new_state, diag = step_mod.forward_step(
                cfgl, grid_l, op_l, state_l, forcing_l, myIter,
                fill=fills.fill, psum=psum, pmax=pmax,
                fill_uv=fills.fill_uv, fill_uv_cg=fills.fill_uv_cg,
                seaice=seaice_l)
            unsq = lambda a: a.reshape((1,) + a.shape)
            return jax.tree.map(unsq, new_state), diag._replace(forc=None)

        blk = P(self.AXIS)
        step = jax.jit(jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(blk, blk, blk, blk, P()),
            out_specs=(blk, P()),
            check_vma=False,
        ))
        self._step = step
        return step

    def run(self, state_blocks, forcing_blocks, n_steps: int,
            n_iter0: int = 0):
        step = self.step_fn()
        diags = []
        for i in range(n_steps):
            state_blocks, diag = step(self.grid, self.op, state_blocks,
                                      forcing_blocks,
                                      jnp.asarray(n_iter0 + i))
            diags.append(diag)
        return state_blocks, diags
