"""Decomposition invariance: 1 device vs 2x4 mesh must agree.

The reference's distributed test is exactly this (SURVEY 4: the same
digit-matching reference is used for 1-proc and N-proc runs). ppermute
halo exchange + psum reductions must reproduce the single-device cyclic
fill bit-for-bit up to reduction ordering.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from mitgcm_tpu.model import step as step_mod
from mitgcm_tpu.parallel import dist
from mitgcm_tpu.utils import synthetic


@pytest.fixture(scope="module")
def setup():
    cfg = synthetic.gyre_config(nx=16, ny=16, nr=3, n_steps=4)
    grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=jnp.float64)
    return cfg, grid, state, forcing, op


def test_single_vs_mesh(setup):
    cfg, grid, state, forcing, op = setup
    n_steps = 4

    # single device reference
    step1 = jax.jit(lambda s, f, it: step_mod.forward_step(
        cfg, grid, op, s, f, it))
    s1 = state
    for i in range(n_steps):
        s1, diag1 = step1(s1, forcing, jnp.asarray(i))

    cpus = jax.devices("cpu")
    assert len(cpus) >= 8
    mesh = Mesh(np.array(cpus[:8]).reshape(2, 4), ("py", "px"))
    model = dist.DistModel(cfg, grid, op, mesh)
    sb = model.shard(state)
    fb = model.shard(forcing)
    sb, diags = model.run(sb, fb, n_steps=n_steps)

    eta_1 = np.asarray(s1.etaN)[cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
    eta_n = dist.untile(np.asarray(jax.device_get(sb.etaN)),
                        cfg.oly, cfg.olx)
    u_1 = np.asarray(s1.uVel)[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
    u_n = dist.untile(np.asarray(jax.device_get(sb.uVel)),
                      cfg.oly, cfg.olx)
    assert np.allclose(eta_1, eta_n, rtol=0, atol=3e-11 * max(
        1.0, float(np.max(np.abs(eta_1)))))
    assert np.allclose(u_1, u_n, rtol=0, atol=3e-11 * max(
        1.0, float(np.max(np.abs(u_1)))))
    # cg2d residual diagnostic agrees too
    r1 = float(diag1.cg2d_init_res)
    rn = float(diags[-1].cg2d_init_res)
    assert abs(r1 - rn) <= 1e-9 * max(1.0, abs(r1))


def test_kpp_physics_hooks(setup):
    """KPP rides the sharded step: per-shard clones with local grid/kmtj
    must reproduce the single-device run."""
    from mitgcm_tpu.model import kpp as kpp_mod

    cfg = synthetic.gyre_config(nx=16, ny=16, nr=8, n_steps=3)
    cfg.useKPP = True
    grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=jnp.float64)
    kpp = kpp_mod.KPP(cfg, grid, {}, options={"KPP_GHAT"})

    step1 = jax.jit(lambda s, f, it: step_mod.forward_step(
        cfg, grid, op, s, f, it, kpp=kpp))
    s1 = state
    for i in range(3):
        s1, _ = step1(s1, forcing, jnp.asarray(i))

    cpus = jax.devices("cpu")
    mesh = Mesh(np.array(cpus[:8]).reshape(2, 4), ("py", "px"))
    model = dist.DistModel(cfg, grid, op, mesh, kpp=kpp)
    sb, _ = model.run(model.shard(state), model.shard(forcing), n_steps=3)

    u_1 = np.asarray(s1.uVel)[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
    u_n = dist.untile(np.asarray(jax.device_get(sb.uVel)),
                      cfg.oly, cfg.olx)
    t_1 = np.asarray(s1.theta)[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
    t_n = dist.untile(np.asarray(jax.device_get(sb.theta)),
                      cfg.oly, cfg.olx)
    assert np.allclose(u_1, u_n, rtol=0, atol=1e-10 * max(
        1.0, float(np.max(np.abs(u_1)))))
    assert np.allclose(t_1, t_n, rtol=0, atol=1e-10 * max(
        1.0, float(np.max(np.abs(t_1)))))


def test_reference_config_cs():
    """Decomposition invariance on the CUBED SPHERE (hs94.cs-32x32x5):
    one face per device over a 6-device "face" mesh, cross-face halos by
    all_gather + the single-host CSExchange maps, reductions by psum
    over the face axis.  Tolerance is relative ~1e-9: the cube-corner
    vorticity operand grouping is face-dependent in the reference purely
    for bit-reproducible rounding, and the SPMD per-face program uses
    one grouping for all faces (same math, ulp-level difference)."""
    from tests.conftest import reference_exp
    from tests.test_hs94 import hs_forcing_uv, hs_forcing_t
    from mitgcm_tpu.core.state import State
    from mitgcm_tpu.model.experiment import Experiment

    DIR = reference_exp("hs94.cs-32x32x5")
    GRID_DIR = reference_exp("aim.5l_cs") + "/input"
    exp = Experiment.from_dir(DIR + "/input", nx=32, ny=32, nr=5,
                              grid_dir=GRID_DIR)
    cfg, grid = exp.cfg, exp.grid
    cfg.custom_forcing_uv = hs_forcing_uv
    cfg.custom_forcing_t = hs_forcing_t
    po, kap = cfg.atm_Po, cfg.atm_kappa
    rC = np.asarray(grid.rC)
    lat = np.deg2rad(np.asarray(grid.yC))
    thetaLim = 200.0 / (rC[:, None, None] / po) ** kap
    thetaEq = (315.0 - 60.0 * np.sin(lat) ** 2
               - 10.0 * np.log(rC[:, None, None] / po) * np.cos(lat) ** 2)
    theta0 = jnp.asarray(np.maximum(thetaLim, thetaEq)) * grid.maskC
    exp.state = State(**{**exp.state.__dict__, "theta": theta0})
    n_steps = 2

    step1 = exp.make_step_fn()
    s1 = exp.state
    for i in range(n_steps):
        s1, _ = step1(s1, exp.forcing, jnp.asarray(cfg.nIter0 + i))

    cpus = jax.devices("cpu")
    assert len(cpus) >= 6
    mesh = Mesh(np.array(cpus[:6]), ("face",))
    model = dist.DistCSModel(exp, mesh)
    sb, _ = model.run(model.shard(exp.state), model.shard(exp.forcing),
                      n_steps=n_steps, n_iter0=cfg.nIter0)

    for fname in ("theta", "uVel", "vVel", "etaN", "wVel"):
        a1 = np.asarray(getattr(s1, fname))
        an = model.gather(np.asarray(jax.device_get(getattr(sb, fname))))
        assert a1.shape == an.shape, fname
        scale = max(1.0, float(np.max(np.abs(a1))))
        # compare interiors (halo conventions may differ post-step)
        oly, olx = cfg.oly, cfg.olx
        nyp = cfg.ny + 2 * oly
        for f in range(6):
            a1f = a1[..., f * nyp + oly:f * nyp + oly + cfg.ny,
                     olx:olx + cfg.nx]
            anf = an[..., f * nyp + oly:f * nyp + oly + cfg.ny,
                     olx:olx + cfg.nx]
            assert np.allclose(a1f, anf, rtol=0, atol=2e-9 * scale), \
                (fname, f, float(np.max(np.abs(a1f - anf))))


def test_reference_config_latlon():
    """Decomposition invariance on a real reference deck
    (tutorial_global_oce_latlon: GM-Redi + ptracers + periodic x)."""
    from tests.conftest import reference_exp
    from mitgcm_tpu.model.experiment import Experiment

    DIR = reference_exp("tutorial_global_oce_latlon")
    exp = Experiment.from_dir(DIR + "/input", nx=90, ny=40, nr=15)
    cfg = exp.cfg
    n_steps = 3

    s1 = exp.state
    step1 = jax.jit(lambda s, f, it: step_mod.forward_step(
        cfg, exp.grid, exp.op, s, f, it))
    for i in range(n_steps):
        s1, _ = step1(s1, exp.forcing, jnp.asarray(cfg.nIter0 + i))

    cpus = jax.devices("cpu")
    npy, npx = dist.choose_layout(8, cfg.ny, cfg.nx)
    mesh = Mesh(np.array(cpus[:8]).reshape(npy, npx), ("py", "px"))
    model = dist.DistModel.from_experiment(exp, mesh)
    sb, _ = model.run(model.shard(exp.state), model.shard(exp.forcing),
                      n_steps=n_steps, n_iter0=cfg.nIter0)

    for fname in ("theta", "uVel", "etaN", "pTr"):
        a1 = np.asarray(getattr(s1, fname))
        an = np.asarray(jax.device_get(getattr(sb, fname)))
        a1i = a1[..., cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
        ani = dist.untile(an, cfg.oly, cfg.olx)
        scale = max(1.0, float(np.max(np.abs(a1i))))
        assert np.allclose(a1i, ani, rtol=0, atol=1e-9 * scale), fname


def test_dryrun_refuses_missing_devices():
    """The dry run takes the devices it is asked for or fails; it does not
    fall back to other devices."""
    import __graft_entry__ as graft
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)
    graft.dryrun_multichip(4)
