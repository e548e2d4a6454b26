"""Checkpoint/restart: 4 steps == 2 + pickup + 2 (tools/do_tst_2+2)."""

import numpy as np
import jax.numpy as jnp

from mitgcm_tpu.model import experiment as exp_mod
from mitgcm_tpu.model.experiment import Experiment
from mitgcm_tpu.utils import synthetic


def _make():
    cfg = synthetic.gyre_config(nx=16, ny=16, nr=3, n_steps=4)
    grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=jnp.float64)
    return Experiment(cfg=cfg, grid=grid, state=state, forcing=forcing,
                      op=op)


def test_2plus2(tmp_path):
    e4 = _make()
    e4.run(n_steps=4, collect_monitor=False)

    e2 = _make()
    e2.run(n_steps=2, collect_monitor=False)
    exp_mod.write_pickup(e2, str(tmp_path), myIter=2)

    e22 = _make()
    exp_mod.read_pickup(e22, str(tmp_path), myIter=2)
    assert e22.cfg.startFromPickup
    e22.run(n_steps=2, collect_monitor=False)

    ol = e4.cfg.olx
    for name in ("uVel", "vVel", "theta", "etaN", "guNm1"):
        a = np.asarray(getattr(e4.state, name))[..., ol:-ol, ol:-ol]
        b = np.asarray(getattr(e22.state, name))[..., ol:-ol, ol:-ol]
        assert np.array_equal(a, b), f"{name} differs after restart"


def test_2plus2_ab3(tmp_path):
    """AB3 restart must carry the second tendency level (*Nm2 records;
    reference write_pickup.F:149/181, read_pickup.F:285/305)."""
    def make_ab3():
        e = _make()
        e.cfg.useAB3 = True
        e.cfg.alph_AB = 0.5
        e.cfg.beta_AB = 5.0 / 12.0
        return e

    e4 = make_ab3()
    e4.run(n_steps=4, collect_monitor=False)

    e2 = make_ab3()
    e2.run(n_steps=2, collect_monitor=False)
    exp_mod.write_pickup(e2, str(tmp_path), myIter=2)

    e22 = make_ab3()
    exp_mod.read_pickup(e22, str(tmp_path), myIter=2)
    e22.run(n_steps=2, collect_monitor=False)

    ol = e4.cfg.olx
    for name in ("uVel", "vVel", "theta", "etaN", "guNm1", "guNm2"):
        a = np.asarray(getattr(e4.state, name))[..., ol:-ol, ol:-ol]
        b = np.asarray(getattr(e22.state, name))[..., ol:-ol, ol:-ol]
        assert np.array_equal(a, b), f"{name} differs after AB3 restart"


def test_pickup_roundtrip(tmp_path):
    e = _make()
    e.run(n_steps=3, collect_monitor=False)
    exp_mod.write_pickup(e, str(tmp_path), myIter=3)
    e2 = _make()
    exp_mod.read_pickup(e2, str(tmp_path), myIter=3)
    ol = e.cfg.olx
    for name in ("uVel", "vVel", "theta", "salt", "etaN", "etaH",
                 "dEtaHdt", "guNm1", "gvNm1", "gtNm1", "gsNm1"):
        a = np.asarray(getattr(e.state, name))[..., ol:-ol, ol:-ol]
        b = np.asarray(getattr(e2.state, name))[..., ol:-ol, ol:-ol]
        assert np.array_equal(a, b), name


def test_2plus2_seaice_labsea(tmp_path):
    """Seaice/CD-scheme 2+2 restart on the real lab_sea deck: pickup +
    pickup_seaice (incl. multDim TICES stack + SItracers) + pickup_cd
    must reproduce the straight 4-step run bit-for-bit."""
    import os
    from tests.conftest import reference_exp
    DIR = reference_exp("lab_sea")

    def make():
        e = Experiment.from_dir(DIR + "/input", nx=20, ny=16, nr=23)
        exp_mod.read_pickup(e, DIR + "/input", 1)
        return e

    e4 = make()
    e4.run(n_steps=4, collect_monitor=False)

    e2 = make()
    e2.run(n_steps=2, collect_monitor=False)
    exp_mod.write_pickup(e2, str(tmp_path), myIter=3)

    e22 = make()
    exp_mod.read_pickup(e22, str(tmp_path), myIter=3)
    e22.run(n_steps=2, collect_monitor=False)

    ol = e4.cfg.olx
    for name in ("uVel", "vVel", "theta", "salt", "etaN", "guNm1",
                 "uVelD", "vVelD", "etaNm1", "uIce", "vIce", "siAREA",
                 "siHEFF", "siHSNOW", "siTICES", "SItracer"):
        a = np.asarray(getattr(e4.state, name))[..., ol:-ol, ol:-ol]
        b = np.asarray(getattr(e22.state, name))[..., ol:-ol, ol:-ol]
        assert np.array_equal(a, b), f"{name} differs after restart"


def test_run_then_scan_continues():
    """run_scan picks up where run() stopped: the Adams-Bashforth history
    and the iteration counter carry over, so run(2) + run_scan(2) is the
    4-step run up to the fusion differences of one program vs four."""
    e4 = _make()
    e4.run(n_steps=4, collect_monitor=False)

    e22 = _make()
    e22.run(n_steps=2, collect_monitor=False)
    _, diags = e22.run_scan(n_steps=2)
    assert e22._cur_iter == 4
    assert np.asarray(diags.cg2d_iters).shape == (2,)

    ol = e4.cfg.olx
    for name in ("uVel", "vVel", "theta", "etaN", "guNm1"):
        a = np.asarray(getattr(e4.state, name))[..., ol:-ol, ol:-ol]
        b = np.asarray(getattr(e22.state, name))[..., ol:-ol, ol:-ol]
        rel = np.max(np.abs(a - b)) / np.max(np.abs(a))
        assert rel <= 1e-13, (name, rel)
