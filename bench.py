#!/usr/bin/env python
"""Benchmark: forward-step throughput + roofline on the local accelerator.

Prints ONE JSON line.  Headline metric stays the barotropic-gyre
points*steps/s in f32 (comparable across rounds, vs the reference's
committed single-CPU timer baseline ~2.2e4 from BASELINE.md); extra keys:
  - configs: points*steps/s for the driver-designated decks in BOTH f32
    and f64 (all correctness testing is f64), plus a large
    bandwidth-bound domain (1024x1024x32 stratified gyre, f32)
  - hbm_gbps_measured: STREAM-triad measured HBM bandwidth on this chip
  - large_model_gbps_*: bytes moved per second by the large-domain step,
    from (a) XLA's cost model and (b) a field-traffic lower bound
  - roofline_frac_est: cost-model traffic / measured bandwidth

Each measurement runs in its OWN subprocess: a fresh JAX context per
deck/dtype so f32 and f64 runs cannot contaminate each other, and the
whole n-step loop is ONE compiled XLA program (run_scan; monitor off the
hot path).  Invoked with arguments, this file IS the per-measurement
worker.
"""

import json
import os
import subprocess
import sys
import time

VERIF = "/root/reference/verification"

DECKS = {
    # name -> (deck dir, n_steps, pickup iter, size kwargs)
    "barotropic_gyre_62x62x1":
        (f"{VERIF}/tutorial_barotropic_gyre/input", 200, None, {}),
    "baroclinic_gyre_62x62x15":
        (f"{VERIF}/tutorial_baroclinic_gyre/input", 100, None,
         dict(nx=62, ny=62, nr=15)),
    "global_oce_latlon_90x40x15":
        (f"{VERIF}/tutorial_global_oce_latlon/input", 60, None,
         dict(nx=90, ny=40, nr=15)),
    # the LSR while_loop dominates: keep the step count small so the f64
    # row fits the per-measurement timeout
    "lab_sea_20x16x23":
        (f"{VERIF}/lab_sea/input", 12, 1, dict(nx=20, ny=16, nr=23)),
    # EVP (aEVP, 500 fixed subcycles as one fori_loop): no tridiagonal
    # sweeps, no convergence branches
    "lab_sea_evp_20x16x23":
        (f"{VERIF}/lab_sea/input.hb87", 12, None,
         dict(nx=20, ny=16, nr=23,
              grid_dir=f"{VERIF}/lab_sea/input.hb87"
                       f"{os.pathsep}{VERIF}/lab_sea/input")),
    # the cubed-sphere flagship (p-coords ocean + seaice LSR + GGL90 +
    # exf), driver-designated target config
    "cs32x15_in_p_6x32x32x15":
        (f"{VERIF}/global_ocean.cs32x15/input.in_p", 8, None,
         dict(nx=32, ny=32, nr=15, strict_config=False,
              grid_dir=os.pathsep.join([
                  f"{VERIF}/global_ocean.cs32x15/input.in_p",
                  f"{VERIF}/global_ocean.cs32x15/input.seaice",
                  f"{VERIF}/global_ocean.cs32x15/input.icedyn",
                  f"{VERIF}/global_ocean.cs32x15/input",
                  f"{VERIF}/tutorial_held_suarez_cs/input"]))),
}


def _require_gpu():
    """Refuse to measure anywhere but on a GPU; name the device."""
    import jax
    from mitgcm_tpu.utils.compile_cache import use_compile_cache
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures on a GPU; JAX found "
                         f"{devices[0].platform}")
    use_compile_cache()
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind, "count": len(devices)}


def _time_scan(exp, n_steps, warmup=2):
    import jax
    final_state, _ = exp.run_scan(n_steps=warmup)
    jax.block_until_ready(final_state.etaN)
    t0 = time.perf_counter()
    final_state, _ = exp.run_scan(n_steps=n_steps)
    jax.block_until_ready(final_state.etaN)
    return time.perf_counter() - t0


def worker_deck(name, tag):
    device = _require_gpu()
    import jax.numpy as jnp
    from mitgcm_tpu.model.experiment import Experiment, read_pickup
    deck, n_steps, pickup, kw = DECKS[name]
    dtype = jnp.float32 if tag == "f32" else jnp.float64
    exp = Experiment.from_dir(deck, dtype=dtype, **kw)
    if pickup is not None:
        read_pickup(exp, deck, pickup)
    dt = _time_scan(exp, n_steps)
    pts = exp.cfg.nFaces * exp.cfg.nx * exp.cfg.ny * exp.cfg.nr
    print(json.dumps({"rate": pts * n_steps / dt, "device": device}))


def worker_large(nx=1024, ny=1024, nr=32, n_steps=20):
    """Large stratified gyre: HBM-bandwidth-bound on a single chip."""
    device = _require_gpu()
    import jax
    import jax.numpy as jnp
    from mitgcm_tpu.model.experiment import Experiment
    from mitgcm_tpu.utils import synthetic

    cfg = synthetic.gyre_config(nx=nx, ny=ny, nr=nr, deltaT=600.0)
    grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=jnp.float32)
    exp = Experiment(cfg=cfg, grid=grid, state=state, forcing=forcing,
                     op=op)
    dt = _time_scan(exp, n_steps, warmup=2)
    pts = nx * ny * nr
    rate = pts * n_steps / dt

    from mitgcm_tpu.model import step as step_mod

    def one(state_a, grid_a, op_a, forcing_a):
        ns, _ = step_mod.forward_step(cfg, grid_a, op_a, state_a,
                                      forcing_a, 0)
        return ns

    # (a) XLA's own cost model of one compiled forward step
    try:
        comp = jax.jit(one).lower(exp.state, exp.grid, exp.op,
                                  exp.forcing).compile()
        ca = comp.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        bytes_cost_model = float(ca.get("bytes accessed", 0.0))
    except Exception:
        bytes_cost_model = 0.0
    # (b) field-traffic lower bound: 3-D prognostics read+written once
    # (u,v,w,t,s + AB histories u,v,t,s = 9 r+w) plus ~8 scratch passes
    fld_bytes = 4 * pts
    bytes_lower_bound = fld_bytes * (2 * 9 + 8)
    step_per_s = rate / pts
    print(json.dumps({
        "rate": rate,
        "gbps_cost": bytes_cost_model * step_per_s / 1e9,
        "gbps_lb": bytes_lower_bound * step_per_s / 1e9,
        "device": device,
    }))


def worker_hbm():
    """STREAM-triad on 256 MiB operands: a = b*s + c."""
    device = _require_gpu()
    import jax
    import jax.numpy as jnp
    n = 64 * 1024 * 1024
    b = jnp.arange(n, dtype=jnp.float32)
    c = jnp.ones((n,), jnp.float32)

    reps = 200

    @jax.jit
    def triad(b, c):
        # fori_loop keeps every rep a real HBM round-trip (XLA does not
        # collapse loop-carried fmas) in ONE dispatch
        return jax.lax.fori_loop(
            0, reps, lambda i, a: a * 1.0000001 + c, b)

    a = jax.block_until_ready(triad(b, c))
    t0 = time.perf_counter()
    a = jax.block_until_ready(triad(a, c))
    dt = time.perf_counter() - t0
    print(json.dumps({"gbps": reps * 3 * 4 * n / dt / 1e9,
                      "device": device}))


def _spawn(args, x64):
    env = dict(os.environ)
    env["JAX_ENABLE_X64"] = "1" if x64 else "0"
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + args,
            capture_output=True, text=True, timeout=1800, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        line = out.stdout.strip().splitlines()[-1]
        return json.loads(line)
    except Exception as e:          # pragma: no cover - report, keep going
        return {"error": f"{type(e).__name__}"}


def main():
    results = {}
    for name in DECKS:
        for tag in ("f32", "f64"):
            r = _spawn(["deck", name, tag], x64=(tag == "f64"))
            results[f"{name}_{tag}"] = (round(r["rate"], 1)
                                        if "rate" in r
                                        else f"failed: {r.get('error')}")
    big = _spawn(["large"], x64=False)
    results["gyre_1024x1024x32_f32"] = round(big.get("rate", 0.0), 1)
    hbm = _spawn(["hbm"], x64=False).get("gbps", 1.0)

    rate_g = results.get("barotropic_gyre_62x62x1_f32")
    rate_g = rate_g if isinstance(rate_g, float) else None
    baseline = 2.2e4   # reference tutorial_barotropic_gyre (BASELINE.md)
    gbps_cost = big.get("gbps_cost", 0.0)
    print(json.dumps({
        "metric": "barotropic_gyre_points_steps_per_s",
        "value": rate_g,
        "unit": "gridpoints*steps/s",
        "vs_baseline": round(rate_g / baseline, 2) if rate_g else None,
        "configs": results,
        "hbm_gbps_measured": round(hbm, 1),
        "large_model_gbps_est": round(gbps_cost, 1),
        "large_model_gbps_lower_bound": round(big.get("gbps_lb", 0.0), 1),
        "roofline_frac_est": round(gbps_cost / hbm, 3),
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        if sys.argv[1] == "deck":
            worker_deck(sys.argv[2], sys.argv[3])
        elif sys.argv[1] == "large":
            worker_large()
        elif sys.argv[1] == "hbm":
            worker_hbm()
    else:
        main()
