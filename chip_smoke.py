#!/usr/bin/env python
"""Smoke test of the ocean model's main path on NVIDIA GPUs.

    python chip_smoke.py           # phases 1-6 on one GPU
    python chip_smoke.py --four    # phase 7 only: a 2x2 mesh of four GPUs

Every phase drives the model through the entry points a user calls
(`Experiment.run` with the monitor, `Experiment.run_scan`, pickups, the
adjoint objective, `DistModel`) on the synthetic wind-driven gyre of
`utils/synthetic.py`, checks what comes out, and prints one JSON line of
its own figures. A failed check raises, so the script exits non-zero; the
last line, `{"ok": true, "device": {...}}`, is printed only when every
phase passed. Without a GPU the script exits non-zero before any phase.

The phases are functions of a device and sizes, so the tests run them on
the CPU at toy sizes; only `main()` insists on a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# f64 is the model's reference precision. The GPU and the CPU reference
# sum in different orders, and the cg2d solve amplifies last-bit
# differences about 1e4-fold per solve (solver/cg2d.py); measured on an
# H100 (700 W) at 256x256x16: 1.3e-12, with equal iteration counts.
TOL_GPU_VS_CPU_F64 = 1.0e-10
# f32 against f64 after 5 steps. The eta solve stops at a relative
# residual of 1e-7 (cg2dTargetResidual), so eta and the velocities it
# drives keep errors well above f32 rounding: measured 6e-4 on an H100
# (700 W) at 1024x1024x32 and 3e-3 on the CPU at 16x16x4. Theta moves
# little in 5 steps and agrees to f32 rounding (2e-7).
TOL_F32 = {"etaN": 1.0e-2, "uVel": 1.0e-2, "theta": 1.0e-6}
# run(2) then run_scan(2) against run(4): one program instead of four
# may fuse differently and move the last bits; measured 0 on an H100
# (700 W) at 256x256x16 and 7e-16 on the CPU at 16x16x4.
TOL_SCAN_CONTINUATION = 1.0e-13
# closed basin, no surface heat flux: the volume-mean temperature is
# conserved to rounding
TOL_THETA_DRIFT = 1.0e-9

FIELDS = ("etaN", "uVel", "vVel", "theta")


def _check(ok, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


@functools.cache
def _cards() -> tuple:
    """Each GPU's name and power limit, as a child that stays off JAX
    reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return tuple(out.strip().splitlines())


def _label(device) -> str:
    """What a figure was measured on: a GPU's name and power limit."""
    if device.platform != "gpu":
        return device.device_kind
    cards = _cards()
    return cards[device.id] if device.id < len(cards) else cards[0]


def _report(phase: str, device, **figures) -> None:
    print(json.dumps({"phase": phase, "card": _label(device), **figures},
                     default=float), flush=True)


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes")}


def _interior(exp, name):
    from mitgcm_tpu.ops.stencil import interior
    return interior(np.asarray(getattr(exp.state, name)), exp.cfg.oly,
                    exp.cfg.olx)


def _compile(bound, *args):
    """Compile a runner of Experiment for args; returns (seconds, compiled)."""
    t0 = time.perf_counter()
    compiled = bound.func.lower(*args, **bound.keywords).compile()
    return time.perf_counter() - t0, compiled


def _rel_diff(a, b) -> float:
    scale = float(np.max(np.abs(b)))
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / (scale if scale > 0 else 1.0))


def gyre(n, nr, dtype, device, kpp=False, n_steps=10):
    """The n x n x nr gyre as an Experiment whose arrays live on device."""
    import jax
    from mitgcm_tpu.model.experiment import Experiment
    from mitgcm_tpu.utils import synthetic
    cfg = synthetic.gyre_config(nx=n, ny=n, nr=nr, deltaT=600.0,
                                n_steps=n_steps)
    cfg.useKPP = kpp
    with jax.default_device(device):
        grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=dtype)
        exp = Experiment(cfg=cfg, grid=grid, state=state, forcing=forcing,
                         op=op)
        if kpp:
            from mitgcm_tpu.model import kpp as kpp_mod
            exp.kpp = kpp_mod.KPP(cfg, grid, {}, options={"KPP_GHAT"})
    return exp


def _check_solver(exp, iters, last_res, where):
    tol_sq = float(exp.op.tolerance_sq)
    for i, (it, res) in enumerate(zip(iters, last_res)):
        _check(it < exp.cfg.cg2dMaxIters,
               f"{where} step {i}: cg2d ran out of iterations ({it})")
        _check(res * res < tol_sq,
               f"{where} step {i}: cg2d residual {res} above target")


def phase_forward(device, n=1024, nr=32, dtype=None, steps=5, kpp=False,
                  scan=True, name="forward_f64"):
    """`run` with the monitor for `steps` steps, then `run_scan` for as
    many more. Checks the solver, the monitor and the heat content;
    returns the interiors of FIELDS after the `run` steps."""
    import jax
    import jax.numpy as jnp
    dtype = dtype or jnp.float64
    exp = gyre(n, nr, dtype, device, kpp=kpp)
    with jax.default_device(device):
        setup_s, compiled = _compile(exp.make_step_fn(), exp.state,
                                     exp.forcing, exp.cfg.nIter0)
        # the first step also compiles the monitor's programs
        recs = exp.run(n_steps=1)
        exp._timers = {}
        t0 = time.perf_counter()
        recs += exp.run(n_steps=steps - 1, collect_monitor=True)[1:]
        run_s = time.perf_counter() - t0
        timers = dict(exp._timers)
        after_run = {k: _interior(exp, k) for k in FIELDS}

        float_dtypes = {str(a.dtype) for a in jax.tree.leaves(exp.state)
                        if jnp.issubdtype(a.dtype, jnp.floating)}
        _check(float_dtypes == {jnp.dtype(dtype).name},
               f"{name}: state promoted to {float_dtypes}")
        _check_solver(exp, [r["cg2d_iters"] for r in recs[1:]],
                      [r["cg2d_last_res"] for r in recs[1:]], name)
        for r in recs:
            bad = [k for k, v in r.items() if not np.isfinite(v)]
            _check(not bad, f"{name}: non-finite monitor {bad} at {r['iter']}")
        theta0 = recs[0]["dynstat_theta_mean"]
        drift = [abs(r["dynstat_theta_mean"] - theta0) / abs(theta0)
                 for r in recs]

        figures = {}
        if scan:
            figures["scan_setup_s"], _ = _compile(
                exp.make_scan_fn(), exp.state, exp.forcing,
                jnp.arange(steps))
            t0 = time.perf_counter()
            _, diags = exp.run_scan(n_steps=steps)
            jax.block_until_ready(exp.state.etaN)
            figures["scan_s_per_step"] = (time.perf_counter() - t0) / steps
            _check_solver(exp, np.asarray(diags.cg2d_iters),
                          np.asarray(diags.cg2d_last_res), name + " scan")
            figures["scan_cg2d_iters"] = np.asarray(diags.cg2d_iters).tolist()
            end = exp.monitor_stats()
            drift.append(abs(end["dynstat_theta_mean"] - theta0)
                         / abs(theta0))
            bad = [k for k, v in end.items() if not np.isfinite(v)]
            _check(not bad, f"{name}: non-finite monitor {bad} after scan")
    if dtype == jnp.float64:
        _check(max(drift) < TOL_THETA_DRIFT,
               f"{name}: theta mean drifts by {max(drift)}")
    _report(name, device, size=[nr, n, n], dtype=jnp.dtype(dtype).name,
            setup_s=setup_s, timed_steps=steps - 1, run_s=run_s,
            run_s_per_step=timers["forward_step"] / (steps - 1),
            monitor_s_per_step=timers["monitor"] / (steps - 1),
            cg2d_iters=[r["cg2d_iters"] for r in recs[1:]],
            theta_mean_drift=max(drift), **figures,
            peak_bytes_in_use=_peak_bytes(device),
            step_memory=_memory(compiled))
    return after_run


def phase_f32(device, ref, n=1024, nr=32, steps=5):
    """Phase 1 in f32; compares FIELDS after `steps` with the f64 run."""
    import jax.numpy as jnp
    got = phase_forward(device, n, nr, dtype=jnp.float32, steps=steps,
                        name="forward_f32")
    diffs = {k: _rel_diff(got[k], ref[k]) for k in TOL_F32}
    _report("f32_vs_f64", device, rel_diff=diffs, tolerance=TOL_F32)
    for k, d in diffs.items():
        _check(d <= TOL_F32[k], f"f32 {k} differs from f64 by {d}")
    return diffs


def _run_fields(exp, steps, device):
    import jax
    with jax.default_device(device):
        recs = exp.run(n_steps=steps, collect_monitor=False)
    return ({k: _interior(exp, k) for k in FIELDS},
            [r["cg2d_iters"] for r in recs[1:]])


def phase_reference(device, cpu, n=256, nr=16, steps=5):
    """The gyre on `device` against the same run on the CPU, in f64."""
    import jax.numpy as jnp
    got, iters = _run_fields(gyre(n, nr, jnp.float64, device), steps,
                             device)
    ref, ref_iters = _run_fields(gyre(n, nr, jnp.float64, cpu), steps, cpu)
    diffs = {k: _rel_diff(got[k], ref[k]) for k in FIELDS}
    _report("device_vs_cpu_f64", device, size=[nr, n, n], rel_diff=diffs,
            tolerance=TOL_GPU_VS_CPU_F64, cg2d_iters=iters,
            cpu_cg2d_iters=ref_iters)
    for k, d in diffs.items():
        _check(d <= TOL_GPU_VS_CPU_F64,
               f"{k}: device differs from the CPU reference by {d}")
    return diffs


def phase_restart(device, n=256, nr=16):
    """2+2 restart through pickups, a repeated run, and run then run_scan
    against one 4-step run."""
    import jax.numpy as jnp
    from mitgcm_tpu.model import experiment as exp_mod

    def make():
        return gyre(n, nr, jnp.float64, device)

    straight, _ = _run_fields(make(), 4, device)
    again, _ = _run_fields(make(), 4, device)
    e2 = make()
    _run_fields(e2, 2, device)
    with tempfile.TemporaryDirectory() as tmp:
        exp_mod.write_pickup(e2, tmp, myIter=2)
        e22 = make()
        exp_mod.read_pickup(e22, tmp, myIter=2)
    restarted, _ = _run_fields(e22, 2, device)
    es = make()
    _run_fields(es, 2, device)
    es.run_scan(n_steps=2)
    scanned = {k: _interior(es, k) for k in FIELDS}

    def same(other):
        return all(np.array_equal(other[k], straight[k]) for k in FIELDS)

    out = {"restart_bit_identical": same(restarted),
           "repeat_bit_identical": same(again),
           "restart_rel_diff": max(_rel_diff(restarted[k], straight[k])
                                   for k in FIELDS),
           "repeat_rel_diff": max(_rel_diff(again[k], straight[k])
                                  for k in FIELDS),
           "scan_rel_diff": max(_rel_diff(scanned[k], straight[k])
                                for k in FIELDS)}
    _report("restart", device, size=[nr, n, n], **out)
    _check(out["restart_bit_identical"], f"2+2 restart differs: {out}")
    _check(out["repeat_bit_identical"], f"repeated run differs: {out}")
    _check(out["scan_rel_diff"] <= TOL_SCAN_CONTINUATION,
           f"run + run_scan differs: {out}")
    return out


def phase_gradient(device, n=512, nr=32, steps=8):
    """jax.value_and_grad of the adjoint objective, checked against
    central finite differences next to a cost box in the centre."""
    import jax
    import jax.numpy as jnp
    from mitgcm_tpu.ad import adjoint, grdchk
    exp = gyre(n, nr, jnp.float64, device, n_steps=steps)
    cfg, grid = exp.cfg, exp.grid
    c, oly, olx = n // 2, cfg.oly, cfg.olx
    box = (c, c + 4, c, c + 4)
    with jax.default_device(device):
        control = adjoint.Control(cfg, grid, field="theta")
        cost = adjoint.cost_boxmean_tracer(cfg, grid, "theta", box=box,
                                           k_range=(0, 2))
        J = adjoint.make_objective(cfg, grid, exp.op, exp.forcing,
                                   exp.state, control, cost, n_steps=steps)
        xx0 = control.zero()
        t0 = time.perf_counter()
        fc, grad = jax.value_and_grad(J)(xx0)
        grad = np.asarray(grad)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(jax.value_and_grad(J)(xx0))
        grad_s = time.perf_counter() - t0
        positions = [(1, oly + c + 1, olx + c + 1), (0, oly + c + 2, olx + c),
                     (2, oly + c - 2, olx + c + 3)]
        rows = grdchk.grdchk(J, xx0, positions, eps=1.0e-4)
    _check(np.isfinite(grad).all(), "non-finite gradient")
    inside = np.zeros(grad.shape, bool)
    inside[:, oly + box[0]:oly + box[1], olx + box[2]:olx + box[3]] = True
    interior = np.zeros(grad.shape, bool)
    interior[:, oly:-oly, olx:-olx] = True
    outside = int(np.sum((grad != 0.0) & interior & ~inside))
    _report("gradient", device, size=[nr, n, n], steps=steps, cost=float(fc),
            first_call_s=first_s, grad_s=grad_s,
            nonzero_outside_box=outside,
            grdchk=[{k: r[k] for k in ("pos", "adj_grad", "fd_grad",
                                         "rel_err")} for r in rows],
            peak_bytes_in_use=_peak_bytes(device))
    _check(outside > 100, f"sensitivity stays in the cost box ({outside})")
    for r in rows:
        _check(r["adj_grad"] != 0.0 and abs(r["rel_err"]) < 1.0e-5,
               f"grdchk disagrees: {r}")
    return rows


def phase_sharded(devices, n=1024, nr=32, steps=5):
    """DistModel on a mesh of `devices` against the single-device run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mitgcm_tpu.parallel import dist
    exp = gyre(n, nr, jnp.float64, devices[0])
    state0 = exp.state
    t0 = time.perf_counter()
    ref, _ = _run_fields(exp, steps, devices[0])
    single_s = time.perf_counter() - t0
    r1 = exp.diags[-1]["cg2d_init_res"]
    exp.state = None

    npy, npx = dist.choose_layout(len(devices), n, n)
    mesh = Mesh(np.array(devices).reshape(npy, npx), ("py", "px"))
    model = dist.DistModel(exp.cfg, exp.grid, exp.op, mesh)
    sb, fb = model.shard(state0), model.shard(exp.forcing)
    del state0
    t0 = time.perf_counter()
    sb, diags = model.run(sb, fb, n_steps=1)
    jax.block_until_ready(sb.etaN)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb, more = model.run(sb, fb, n_steps=steps - 1, n_iter0=1)
    jax.block_until_ready(sb.etaN)
    step_s = (time.perf_counter() - t0) / (steps - 1)
    on = {s.device for s in sb.etaN.addressable_shards}
    _check(on == set(devices), f"shards live on {on}")
    ol = exp.cfg.olx
    got = {k: dist.untile(np.asarray(jax.device_get(getattr(sb, k))), ol, ol)
           for k in ("etaN", "uVel")}
    err = {k: float(np.max(np.abs(got[k] - ref[k]))) for k in got}
    atol = {k: 3e-11 * max(1.0, float(np.max(np.abs(ref[k])))) for k in got}
    rn = float(more[-1].cg2d_init_res)
    _report("sharded", devices[0], size=[nr, n, n], mesh=[npy, npx],
            devices=[str(d) for d in devices], setup_s=setup_s,
            s_per_step=step_s, single_device_s=single_s, abs_diff=err,
            atol=atol, cg2d_init_res=[r1, rn],
            peak_bytes_in_use=[_peak_bytes(d) for d in devices])
    for k in got:
        _check(err[k] <= atol[k], f"sharded {k} differs by {err[k]}")
    _check(abs(r1 - rn) <= 1e-9 * max(1.0, abs(r1)),
           f"sharded cg2d residual {rn} against {r1}")
    return err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded phase, on four GPUs")
    args = parser.parse_args(argv)
    need = 4 if args.four else 1

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    from mitgcm_tpu.utils.compile_cache import use_compile_cache
    cache = use_compile_cache()

    print("\n".join(_cards()))
    _report("start", devices[0], device_kind=devices[0].device_kind,
            jax=jax.__version__, XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
            compile_cache=cache)
    t0 = time.perf_counter()
    if args.four:
        phase_sharded(devices[:4])
    else:
        gpu, cpu = devices[0], jax.devices("cpu")[0]
        ref = phase_forward(gpu)
        phase_f32(gpu, ref)
        phase_forward(gpu, kpp=True, scan=False, name="kpp_f64")
        phase_reference(gpu, cpu)
        phase_restart(gpu)
        phase_gradient(gpu)
    _report("done", devices[0], total_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
