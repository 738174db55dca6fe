#!/usr/bin/env python
"""Headline benchmark: MAOOAM (36-var coupled ocean-atmosphere) ensemble RK4
throughput on an NVIDIA GPU, versus the reference-design CPU baseline.

Prints exactly ONE JSON line to stdout with the headline metric, every
tier's numbers and the device it ran on:

    {"metric": ..., "value": ..., "unit": "traj-steps/s", "vs_baseline": ...,
     "tiers": {"float32": {...}, "twofloat": {...}, "float64": {...}},
     "device": {"platform": "gpu", "kind": ..., "count": ...,
                "nvidia_smi": "<name>, <power limit>"}, ...}

Tiers (all vs the same baseline):
  float32   — count-bucketed gather/row-sum kernel (the auto mode)
  twofloat  — double-float (2x f32) fused RK4 step, ~48-bit mantissa
  float64   — native float64, the fidelity oracle

FLOP accounting: the bucketed kernel's algorithmic work is ~3 flops per
nonzero per stage (no scatter matmul), i.e. 4 x 3 x nnz per traj-step; it
is gather-bound, so a matmul peak is not a meaningful ceiling for it.

Baseline protocol: the reference implementation (Climdyn/qgs) runs one Numba
trajectory per CPU process (cpu_count processes).  Numba is not installed,
so the baseline is the framework's own native C++ kernel (qgs_jax/native:
the bit-exact reference-semantics COO contraction + RK4 loop, compiled
-O3) measured per-core and scaled by cpu_count — a faithful stand-in for a
Numba-jitted scalar loop.  Falls back to the vectorized-NumPy path x5 if no
compiler is available.

Refuses to run on anything but a GPU: a CPU timing is not a device number.

Env knobs: QGS_BENCH_DTYPE in {twofloat, float32, float64} runs ONLY that
tier (and makes it the headline); unset runs all three.  QGS_BENCH_ENSEMBLE
/ QGS_BENCH_STEPS override the per-tier defaults.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


NUMBA_ADVANTAGE = 5.0          # conservative single-core Numba vs NumPy factor
ENSEMBLE = int(os.environ.get("QGS_BENCH_ENSEMBLE", 4096))
STEPS = int(os.environ.get("QGS_BENCH_STEPS", 1000))
# best-of-N timed device runs per tier; min and median are both reported
REPEATS = int(os.environ.get("QGS_BENCH_REPEATS", 3))
DTYPE = os.environ.get("QGS_BENCH_DTYPE")          # None = all tiers
HEADLINE = DTYPE or "twofloat"

# Frozen baseline protocol: ``vs_baseline`` divides by this FIXED figure so
# the ratio is comparable across rounds.  Provenance: best observed
# native-C++ single-core rate on this host (504k reference-semantics RK4
# steps/s/core, round-1 capture; round-2's shared-host capture measured
# 316k/core — contention only ever slows the baseline down, so the best
# observation is the honest per-core speed) x 2 cores = the reference
# design's full-host ensemble throughput (one Numba-equivalent process per
# core, ref ``qgs/integrators/integrator.py:77-82``).  The per-round
# re-measured figure is reported alongside as ``baseline_measured``.
BASELINE_FROZEN = 1.008e6


def _tier_sizes(tier):
    """(ensemble, steps) for a tier: the float64 tier defaults to B=256 x
    50 steps, the float32 and twofloat tiers to B=16384 x 5000 steps;
    QGS_BENCH_ENSEMBLE / QGS_BENCH_STEPS override either."""
    ens = ENSEMBLE
    steps = STEPS
    if tier == "float64":
        if "QGS_BENCH_ENSEMBLE" not in os.environ:
            ens = min(ens, 256)
        if "QGS_BENCH_STEPS" not in os.environ:
            steps = min(steps, 50)
    elif tier in ("float32", "twofloat"):
        if "QGS_BENCH_ENSEMBLE" not in os.environ:
            ens = max(ens, 16384)
        if "QGS_BENCH_STEPS" not in os.environ:
            steps = max(steps, 5000)
    return ens, steps


def build_system():
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3, 'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    return pars, f, Df, tensor


def measure_baseline(tensor, ndim, n_steps=1500):
    """Single-core native (or NumPy-fallback) RK4 steps/s, reference
    semantics.  Returns (steps_per_s, scale_factor_to_apply)."""
    from qgs_jax import native

    if native.available():
        y = np.random.default_rng(0).random(ndim) * 0.01
        # generous warmup + many repeats with max(): the 2-core host is
        # shared and contention only ever slows a run down, so the max is a
        # stable estimator of the baseline's true speed (observed spread
        # without this: 348k-515k steps/s run-to-run)
        native.rk4_integrate(tensor.tensor, y, 0.1, 20000)    # warmup
        best = 0.0
        for _ in range(8):
            t0 = time.perf_counter()
            native.rk4_integrate(tensor.tensor, y, 0.1, 20000)
            best = max(best, 20000 / (time.perf_counter() - t0))
        return best, 1.0

    from qgs_jax.models.numpy_backend import make_numpy_tendencies_fast

    fn, _ = make_numpy_tendencies_fast(tensor.tensor, tensor.jacobian_tensor)
    a = np.zeros((4, 4)); a[1, 0] = a[2, 1] = 0.5; a[3, 2] = 1.
    b = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])
    y = np.random.default_rng(0).random(ndim) * 0.01
    dt = 0.1

    def rkstep(y):
        k = []
        for i in range(4):
            ys = y
            for l in range(i):
                if a[i, l]:
                    ys = ys + dt * a[i, l] * k[l]
            k.append(fn(0., ys))
        return y + dt * (b[0] * k[0] + b[1] * k[1] + b[2] * k[2] + b[3] * k[3])

    for _ in range(50):
        y = rkstep(y)
    # best of 3 repeats — the shared-host CPU timing is noisy
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            y = rkstep(y)
        t1 = time.perf_counter()
        best = max(best, n_steps / (t1 - t0))
    return best, NUMBA_ADVANTAGE


def _build_tier(tensor, ndim, tier, ens, steps):
    """Build one tier's compiled runner; returns ``(run, y0, check)``."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.parallel.mesh import ensemble_mesh, shard_ensemble

    y0_np = np.random.default_rng(0).random((ens, ndim)) * 0.01

    if tier == "twofloat":
        # double-float (2x f32) tier: ~48-bit mantissa from f32 arithmetic
        # (see qgs_jax/ops/twofloat.py); batches go through the integrators'
        # df batch chunking (QGS_DF_BATCH_CHUNK, off by default).
        from qgs_jax.ops.twofloat import make_df_rk4_step, df_from_f64
        from qgs_jax.integrators.rk import _chunk_batched, _df_batch_chunk

        mesh = ensemble_mesh()
        step = _chunk_batched(make_df_rk4_step(tensor.tensor, 0.1),
                              _df_batch_chunk,
                              batch_devices=max(mesh.devices.size, 1))

        @jax.jit
        def run(y):
            return jax.lax.fori_loop(0, steps, lambda i, y: step(y), y)

        y0 = df_from_f64(jnp.asarray(y0_np))
        return run, y0, lambda y: bool(np.isfinite(np.asarray(y[0][:1])).all())

    from qgs_jax.ops.contraction import make_tendency_fns

    dtype = {"float64": jnp.float64, "float32": jnp.float32}[tier]
    f_batched, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                                     dtype=dtype)
    a, b, c = rk4_tableau()
    from qgs_jax.integrators.rk import _chunk_plain_step
    mesh = ensemble_mesh()
    # batches go through the integrators' batch chunking
    # (QGS_F32_BATCH_CHUNK, off by default)
    step = _chunk_plain_step(make_rk_step(f_batched, a, b, c),
                             batch_devices=max(mesh.devices.size, 1))

    @jax.jit
    def run(y):
        def body(i, y):
            return step(y, jnp.asarray(0.0, y.dtype), jnp.asarray(0.1, y.dtype))

        return jax.lax.fori_loop(0, steps, body, y)

    y0 = jnp.asarray(y0_np, dtype=dtype)
    if mesh.devices.size > 1:
        y0, _ = shard_ensemble(y0, mesh)
    return run, y0, lambda y: bool(np.isfinite(np.asarray(y[:1])).all())


def measure_device(tensor, ndim, tier):
    """One tier's steady-state ensemble throughput: best-of-N timed runs
    (chained — the state stays on the model's neighborhood) after a
    compile+warmup call.  Returns ``(times, ens, steps)``."""
    import jax

    ens, steps = _tier_sizes(tier)
    run, y0, check = _build_tier(tensor, ndim, tier, ens, steps)

    log(f"compiling {tier} ...")
    y = run(y0)
    jax.block_until_ready(y)
    times = []
    for _ in range(max(REPEATS, 1)):
        t0 = time.perf_counter()
        y = run(y)
        jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
    if not check(y):
        raise RuntimeError("non-finite state after benchmark run")
    return times, ens, steps


def device_description():
    """The device JAX runs on; raises unless it is a GPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU only; JAX found "
                         f"platform {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def main():
    from qgs_jax.utils.compile_cache import enable_compile_cache

    device = device_description()
    enable_compile_cache()
    tiers = [DTYPE] if DTYPE else ["float32", "twofloat", "float64"]

    log("building MAOOAM system ...")
    pars, f, Df, tensor = build_system()
    nnz = tensor.tensor.nnz
    log(f"ndim={pars.ndim}, tensor nnz={nnz}")

    base_core, factor = measure_baseline(tensor, pars.ndim)
    n_cores = os.cpu_count() or 1
    baseline_measured = base_core * n_cores * factor
    baseline = BASELINE_FROZEN
    kind = "native-C++" if factor == 1.0 else f"numpy x{factor} numba-est"
    log(f"baseline ({kind}): measured {base_core:,.0f} RK4 steps/s/core x "
        f"{n_cores} cores = {baseline_measured:,.0f} traj-steps/s; "
        f"frozen denominator = {baseline:,.0f}")

    n_chips = device["count"]
    tier_results = {}
    for tier in tiers:
        times, ens, steps = measure_device(tensor, pars.ndim, tier)
        value = steps * ens / min(times)              # best of N
        median = steps * ens / float(np.median(times))
        tier_results[tier] = {
            "traj_steps_per_s": value,
            "traj_steps_per_s_median": median,
            "run_times_s": [round(t, 4) for t in times],
            "vs_baseline": value / baseline,
            "mode_updates_per_s_per_chip": value * pars.ndim / n_chips,
            "ensemble": ens,
            "steps": steps,
        }
        log(f"{tier}: {value:,.0f} traj-steps/s best-of-{len(times)} "
            f"(median {median:,.0f}; {value / baseline:.1f}x frozen "
            f"baseline, B={ens})")

    headline = tier_results[HEADLINE if HEADLINE in tier_results else tiers[0]]

    # algorithmic work of the bucketed kernel: two multiplies and one add
    # per nonzero per stage, no scatter matmul
    flops_per_traj_step = 4 * 3 * nnz
    f32 = tier_results.get("float32")
    achieved_tflops = (f32["traj_steps_per_s"] * flops_per_traj_step / n_chips
                       / 1e12) if f32 else None
    report = {
        "metric": f"maooam_rk4_ensemble_throughput_{HEADLINE}",
        "value": headline["traj_steps_per_s"],
        "unit": "traj-steps/s",
        "vs_baseline": headline["vs_baseline"],
        "baseline_traj_steps_per_s": baseline,
        "baseline_protocol": "frozen (see bench.py BASELINE_FROZEN)",
        "baseline_measured_traj_steps_per_s": baseline_measured,
        "bench_repeats": REPEATS,
        "tiers": tier_results,
        "mode_updates_per_s_per_chip": headline["mode_updates_per_s_per_chip"],
        "n_chips": n_chips,
        "device": device,
        "flops_per_traj_step_f32": flops_per_traj_step,
        "flop_accounting": "algorithmic COO flops (4 stages x 3*nnz)",
        "achieved_algorithmic_tflops_f32": achieved_tflops,
    }

    print(json.dumps(report))


if __name__ == "__main__":
    main()
