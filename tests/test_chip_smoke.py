"""The GPU smoke script's phases at toy sizes on the CPU.

Each phase of chip_smoke.py is a function of a device and sizes; here it
runs on the CPU, where the reference run of phase 4 is the same device
and the sharded phase runs on four virtual CPU devices (conftest.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from mitgcm_tpu.utils import compile_cache

N, NR = 16, 4


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def forward(cpu):
    return chip_smoke.phase_forward(cpu, n=N, nr=NR)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, chip_smoke.__file__],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_forward(forward):
    assert set(forward) == set(chip_smoke.FIELDS)
    assert forward["theta"].shape == (NR, N, N)
    assert forward["etaN"].shape == (N, N)
    assert all(np.isfinite(a).all() for a in forward.values())
    assert np.max(np.abs(forward["uVel"])) > 0.0


def test_phase_f32(cpu, forward):
    diffs = chip_smoke.phase_f32(cpu, forward, n=N, nr=NR)
    assert 0.0 < diffs["theta"] <= chip_smoke.TOL_F32["theta"]


def test_phase_kpp(cpu):
    out = chip_smoke.phase_forward(cpu, n=N, nr=8, kpp=True, scan=False,
                                   name="kpp_f64")
    assert np.isfinite(out["theta"]).all()


def test_phase_reference(cpu):
    # on the CPU the device under test is the reference itself
    diffs = chip_smoke.phase_reference(cpu, cpu, n=N, nr=NR)
    assert all(d == 0.0 for d in diffs.values())


def test_phase_restart(cpu):
    out = chip_smoke.phase_restart(cpu, n=N, nr=NR)
    assert out["restart_rel_diff"] == 0.0
    assert out["scan_rel_diff"] <= chip_smoke.TOL_SCAN_CONTINUATION


def test_phase_gradient(cpu):
    rows = chip_smoke.phase_gradient(cpu, n=N, nr=NR)
    assert len(rows) == 3


def test_phase_sharded():
    devices = jax.devices("cpu")[:4]
    err = chip_smoke.phase_sharded(devices, n=N, nr=NR, steps=3)
    assert set(err) == {"etaN", "uVel"}


def test_gyre_places_arrays_on_device(cpu):
    exp = chip_smoke.gyre(N, NR, jnp.float32, cpu)
    assert exp.state.theta.dtype == jnp.float32
    assert exp.state.theta.devices() == {cpu}


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.use_compile_cache() == compile_cache.cache_dir()
        assert (jax.config.jax_compilation_cache_dir
                == compile_cache.cache_dir())
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
