#!/usr/bin/env python
"""Mode-count (resolution) throughput + utilization sweep.

Measures the RK4 ensemble hot loop across spectral truncations from the
standard MAOOAM 2,2/2,4 (ndim 36) up to 8,8/8,8 (ndim 400) and an
atmosphere-only 10,10 (ndim 420), for each device path of the contraction
kernel (``qgs_jax/ops/contraction.py``):

* ``coo``    — the round-3 flat row-grouped gather layout (kept for the
  comparison row; its (B, n1*R) intermediates are what bucketing fixed).
* ``coo_fm`` — feature-major gather variant of ``coo`` (measured
  identical: the gather plateau is layout-insensitive).
* ``coo_b``  — the count-bucketed padding-free kernel, the production
  auto mode (6.3-8.1x over ``coo`` at ndim 104-420, r04).
* ``dense``  — the matricized dense einsum ((B, n1^2) x (n1^2, n1) matmul
  at HIGHEST precision), with the tensor as a device ARGUMENT.  Work is
  O(n1^3); its achieved TFLOP/s is reported (a share of a peak needs the
  peak table keyed by ``device_kind`` that the benchmark does not have
  yet).

The quartic tiers run the rank-5 T^4 radiation tensor (ndim 38, 2,2/2,4,
symbolic-quadrature IPs): ``t4`` (auto = bucketed + pair-factored),
``t4_pairsum`` / ``t4_rowsum`` comparison rows, and ``t4_twofloat``
(the rank-general double-float kernel).  ``recompile_check`` times a
same-shape/new-parameters dispatch.

Writes the results JSON to ``QGS_RES_OUT`` (default: stdout only), appending
each point as it lands so partial sweeps survive a timeout.

Run on the GPU: ``python benchmarks/resolution_sweep.py``
Env knobs: QGS_RES_CONFIGS (comma list of config keys), QGS_RES_PATHS
(comma list in {coo,coo_fm,coo_b,dense}), QGS_RES_T4=0 to skip the quartic tier,
QGS_RES_REPEATS (default 3), QGS_RES_OUT (output JSON path).
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import json
import os
import time

import numpy as np

REPEATS = int(os.environ.get("QGS_RES_REPEATS", 3))

# (key, atm blocks, ocean blocks) — ndim grows 36 -> 754
CONFIGS = {
    "2x2_2x4": ((2, 2), (2, 4)),
    "4x4_4x4": ((4, 4), (4, 4)),
    "6x6_6x6": ((6, 6), (6, 6)),
    "8x8_8x8": ((8, 8), (8, 8)),
    "atm10x10": ((10, 10), None),
    "atm12x12": ((12, 12), None),      # ndim 600
    "atm14x13": ((14, 13), None),      # ndim 754
}

# per-ndim sizing: (B_coo, B_dense, steps_coo, steps_dense) — dense
# flops/step = 8 B n1^3, so B shrinks with ndim to keep runs O(10 s)
def sizing(ndim):
    if ndim <= 120:
        return 4096, 2048, 1000, 500
    if ndim <= 260:
        return 4096, 256, 500, 100
    # the rowsum path materializes (B, n1*R) gather intermediates — at
    # ndim 420 / R~1000, B=4096 would need ~21 GB of device memory; cap
    # the batch instead
    if ndim <= 500:
        return 1024, 128, 300, 30
    return 256, 128, 200, 10


def build(na, no):
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*na)
    if no is not None:
        pars.set_oceanic_basin_fourier_modes(*no)
        pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                         'h': 136.5, 'd': 1.1e-7})
        pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                             'hlambda': 15.06})
        pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
        pars.atemperature_params.set_insolation(103.3333, 0)
        pars.gotemperature_params.set_insolation(310., 0)
    else:
        pars.set_params({'kd': 0.1, 'kdp': 0.01, 'n': 1.5})
        pars.atemperature_params.set_thetas(0.1, 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    return pars, tensor


def build_t4():
    from qgs_jax.params.params import QgParams
    from qgs_jax.inner_products.symbolic import (
        AtmosphericSymbolicInnerProducts, OceanicSymbolicInnerProducts)
    from qgs_jax.tensors.qgtensor import QgsTensorT4

    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, T4=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    aip = AtmosphericSymbolicInnerProducts(pars, quadrature=True)
    oip = OceanicSymbolicInnerProducts(pars, quadrature=True)
    tensor = QgsTensorT4(pars, aip, oip)
    return pars, tensor


def time_loop(run, y0, repeats=REPEATS):
    """Times best-of-N chained runs; also sanity-checks the final state
    (finite, and actually different from the input — guards against a
    wedged executable returning instantly with untouched buffers)."""
    import jax

    t0 = time.perf_counter()
    y = run(y0)
    jax.block_until_ready(y)
    time_loop.last_warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        y = run(y)
        jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
    yf = np.asarray(y)
    if not np.isfinite(yf).all():
        raise RuntimeError("non-finite state after benchmark run")
    if np.array_equal(yf, np.asarray(y0)):
        raise RuntimeError("state unchanged after benchmark run")
    return times


_RUNNER_CACHE = {}


def run_dt(ndim):
    """Benchmark step size: throughput is dt-independent, but the run must
    stay finite — the small-scale modes of high truncations make dt=0.1
    RK4-unstable from ndim ~500 (observed: non-finite states at ndim 600)."""
    return 0.1 if ndim <= 500 else 0.005


def make_xla_runner(tensor, mode, dtype, steps, dt=0.1):
    """Compiled fori-loop RK4 runner with the tendency tensor threaded as a
    jit ARGUMENT (cached per structural key: a same-shape model with new
    parameter values reuses the executable — the recompile_check section
    measures exactly this)."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.ops.contraction import make_tendency_fns

    f_b, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                               mode=mode, dtype=dtype)
    a, b, c = rk4_tableau()
    apply = f_b.apply
    dt = jnp.asarray(dt, dtype)

    ck = (f_b.key, steps, float(dt))
    jitted = _RUNNER_CACHE.get(ck)
    if jitted is None:
        def run_impl(ops, y):
            stp = make_rk_step(lambda t, x: apply(ops, t, x), a, b, c)
            return jax.lax.fori_loop(0, steps,
                                     lambda i, y: stp(y, dt * 0, dt), y)

        jitted = jax.jit(run_impl)
        _RUNNER_CACHE[ck] = jitted

    ops = f_b.operands
    return lambda y: jitted(ops, y)


def coo_stats(tensor):
    """Padded-slot statistics of the auto (rowsum) layout, for the
    bandwidth-roofline accounting."""
    rows = np.bincount(np.asarray(tensor.tensor.coords[0]),
                       minlength=tensor.tensor.shape[0])
    R = int(rows.max())
    n1 = tensor.tensor.shape[0]
    return {"nnz": int(tensor.tensor.nnz), "max_row_nnz": R,
            "mean_row_nnz": float(rows.mean()), "padded_slots": n1 * R}


def bucketed_stats(tensor):
    """Slot/gather statistics of the count-bucketed layout, parsed from
    the kernel's structural key: per (group d_eff, (N_g, R_g)) bucket,
    each slot costs d_eff gathers + d_eff multiplies; pair-factored
    kernels add 2 gathers + 1 multiply per pair per evaluation."""
    import jax.numpy as jnp
    from qgs_jax.ops.contraction import make_bucketed_contraction

    c = make_bucketed_contraction(tensor.tensor, dtype=jnp.float32)
    kind, n1, n_pairs, desc, _ = c.key
    slots = sum(N * R for _, bdesc in desc for (N, R) in bdesc)
    gathers = sum(d_eff * N * R for d_eff, bdesc in desc
                  for (N, R) in bdesc) + 2 * n_pairs
    n_buckets = sum(len(bdesc) for _, bdesc in desc)
    # operand stream: V (4 B/slot) + d_eff int32 index lanes per slot
    operand_bytes = sum((1 + d_eff) * 4 * N * R for d_eff, bdesc in desc
                       for (N, R) in bdesc)
    return {"bucketed_slots": int(slots),
            "bucketed_gather_ops": int(gathers),
            "bucketed_n_buckets": int(n_buckets),
            "bucketed_operand_bytes": int(operand_bytes),
            "bucketed_n_pairs": int(n_pairs)}


def point(config, path, ndim, stats, B, steps, times, platform, extra=None):
    el = min(times)
    steps_s = steps * B / el
    rec = {"config": config, "path": path, "ndim": ndim, **stats,
           "ensemble": B, "steps": steps,
           "run_times_s": [round(t, 4) for t in times],
           "traj_steps_per_s": steps_s,
           "mode_updates_per_s": steps_s * ndim}
    if extra:
        rec.update(extra)
    if path == "dense":
        n1 = ndim + 1
        flops = 8.0 * n1 ** 3            # 4 stages x 2 n1^3 MACs... per traj-step
        achieved = steps_s * flops / 1e12
        rec["useful_flops_per_traj_step"] = flops
        rec["achieved_tflops"] = achieved
    if path in ("coo", "coo_fm", "t4_rowsum", "t4_pairsum"):
        # flat rowsum layouts materialize (B, n1*R) gather intermediates —
        # a device-memory stream: ~3 padded slots of 4 bytes per output
        # element per stage
        slots = stats.get("padded_slots", stats["nnz"])
        traffic = 4 * 3 * slots * 4.0    # bytes per traj-step per member
        rec["algorithmic_flops_per_traj_step"] = 4 * 3 * stats["nnz"]
        rec["gather_traffic_bytes_per_traj_step"] = traffic
        rec["achieved_gather_gbps"] = steps_s * traffic / 1e9
    if path in ("coo_b", "t4"):
        # bucketed/pair-factored kernels: per-bucket gather->mul->reduce
        # chains fuse, so the bytes a member moves are bounded, not known:
        #   * gather work: d_eff gathers per slot;
        #   * device-memory traffic BOUNDS: at least one state read +
        #     operand stream + one output write per evaluation (lower), at
        #     most one state staging per bucket fusion (upper).
        bs = {k: v for k, v in stats.items() if k.startswith("bucketed_")}
        if bs:
            g_ops = 4.0 * bs["bucketed_gather_ops"]        # per traj-step
            rec["gather_ops_per_traj_step"] = g_ops
            rec["mults_per_traj_step"] = g_ops             # one mul/gather
            state_bytes = 4.0 * (ndim + 1) * 4             # per member/stage
            out_bytes = 4.0 * (ndim + 1) * 4
            opb = 4.0 * bs["bucketed_operand_bytes"] / B   # amortized over B
            lower = state_bytes + out_bytes + opb
            upper = (state_bytes * bs["bucketed_n_buckets"]
                     + out_bytes * bs["bucketed_n_buckets"] + opb)
            rec["hbm_bytes_per_traj_step_lower"] = lower
            rec["hbm_bytes_per_traj_step_upper"] = upper
            rec["achieved_gather_gops"] = steps_s * g_ops / 1e9
            rec["achieved_hbm_gbps_lower"] = steps_s * lower / 1e9
            rec["achieved_hbm_gbps_upper"] = steps_s * upper / 1e9
    return rec


def main():
    import jax
    import jax.numpy as jnp

    from qgs_jax.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (platform {jax.devices()[0].platform!r})")
    enable_compile_cache()

    cfg_keys = os.environ.get("QGS_RES_CONFIGS",
                              ",".join(CONFIGS)).split(",")
    paths = os.environ.get("QGS_RES_PATHS",
                           "coo,coo_fm,coo_b,dense").split(",")
    out_path = os.environ.get("QGS_RES_OUT")
    platform = jax.devices()[0].platform

    results = []

    def flush():
        doc = {"metric": "resolution_sweep", "platform": platform,
               "device_kind": jax.devices()[0].device_kind,
               "repeats": REPEATS, "points": results}
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(doc, fh, indent=1)
        return doc

    for key in cfg_keys:
        na, no = CONFIGS[key]
        t0 = time.time()
        pars, tensor = build(na, no)
        ndim = pars.ndim
        stats = {**coo_stats(tensor), **bucketed_stats(tensor)}
        B_coo, B_dense, st_coo, st_dense = sizing(ndim)
        print(f"[{key}] ndim={ndim} nnz={stats['nnz']} "
              f"(built in {time.time()-t0:.0f}s)", flush=True)
        rng = np.random.default_rng(0)

        for pkey, mode in (("coo", "rowsum"), ("coo_fm", "rowsum_fm"),
                           ("coo_b", "bucketed")):
            if pkey not in paths:
                continue
            try:
                run = make_xla_runner(tensor, mode, jnp.float32, st_coo,
                                      dt=run_dt(ndim))
                y0 = jnp.asarray(rng.random((B_coo, ndim)) * 0.01,
                                 jnp.float32)
                times = time_loop(run, y0)
                results.append(point(
                    key, pkey, ndim, stats, B_coo, st_coo, times, platform,
                    extra={"first_dispatch_s":
                           round(time_loop.last_warmup_s, 2)}))
                print(f"  {pkey:<6}: "
                      f"{results[-1]['traj_steps_per_s']:14,.0f} "
                      f"traj-steps/s", flush=True)
            except Exception as err:
                results.append({"config": key, "path": pkey, "ndim": ndim,
                                "error": str(err)[:300]})
                print(f"  {pkey:<6}: FAILED ({str(err)[:120]})", flush=True)
            flush()

        if "dense" in paths:
            try:
                run = make_xla_runner(tensor, "dense", jnp.float32,
                                      st_dense, dt=run_dt(ndim))
                y0 = jnp.asarray(rng.random((B_dense, ndim)) * 0.01,
                                 jnp.float32)
                times = time_loop(run, y0)
                results.append(point(
                    key, "dense", ndim, stats, B_dense, st_dense, times,
                    platform,
                    extra={"first_dispatch_s":
                           round(time_loop.last_warmup_s, 2)}))
                p = results[-1]
                print(f"  dense : {p['traj_steps_per_s']:14,.0f} traj-steps/s"
                      f"  ({p['achieved_tflops']:.1f} TF)", flush=True)
            except Exception as err:
                results.append({"config": key, "path": "dense", "ndim": ndim,
                                "error": str(err)[:300]})
                print(f"  dense : FAILED ({str(err)[:120]})", flush=True)
            flush()


    if os.environ.get("QGS_RES_T4", "1") != "0":
        try:
            t0 = time.time()
            pars, tensor = build_t4()
            stats = {**coo_stats(tensor), **bucketed_stats(tensor)}
            stats["rank"] = int(tensor.tensor.rank)
            from qgs_jax.ops.contraction import make_pairsum_contraction
            stats["n_pairs"] = int(make_pairsum_contraction(
                tensor.tensor).operands["pair_a"].shape[0])
            print(f"[t4] ndim={pars.ndim} rank-5 nnz={stats['nnz']} "
                  f"n_pairs={stats['n_pairs']} "
                  f"(built in {time.time()-t0:.0f}s)", flush=True)
            rng = np.random.default_rng(0)
            y0 = jnp.asarray(rng.random((4096, pars.ndim)) * 0.01,
                             jnp.float32)
            # 'auto' now selects the pair-factored kernel for rank 5
            # (VERDICT r03 #6); 't4_rowsum' is the round-3 kernel for the
            # speedup column
            for pkey, mode in (("t4", "auto"), ("t4_pairsum", "pairsum"),
                               ("t4_rowsum", "rowsum")):
                try:
                    run = make_xla_runner(tensor, mode, jnp.float32, 1000)
                    times = time_loop(run, y0)
                    results.append(point("t4_2x2_2x4", pkey, pars.ndim,
                                         stats, 4096, 1000, times, platform))
                    print(f"  {pkey:<10}: "
                          f"{results[-1]['traj_steps_per_s']:14,.0f} "
                          f"traj-steps/s", flush=True)
                except Exception as err:
                    results.append({"config": "t4_2x2_2x4", "path": pkey,
                                    "error": str(err)[:300]})
                    print(f"  {pkey:<10}: FAILED ({str(err)[:120]})",
                          flush=True)
                flush()

            # twofloat tier on the quartic tendencies (rank-general df
            # kernel, VERDICT r03 Missing #3)
            try:
                from qgs_jax.ops.twofloat import (df_from_f64,
                                                  make_df_rk4_step)
                step = make_df_rk4_step(tensor.tensor, 0.1)
                steps_df = 500

                @jax.jit
                def run_df(y):
                    return jax.lax.fori_loop(0, steps_df,
                                             lambda i, y: step(y), y)

                B_df = 2048
                y0df = df_from_f64(jnp.asarray(
                    rng.random((B_df, pars.ndim)) * 0.01))
                yd = run_df(y0df)
                jax.block_until_ready(yd)
                times = []
                for _ in range(REPEATS):
                    t1 = time.perf_counter()
                    yd = run_df(yd)
                    jax.block_until_ready(yd)
                    times.append(time.perf_counter() - t1)
                if not np.isfinite(np.asarray(yd[0])).all():
                    raise RuntimeError("non-finite state")
                results.append(point("t4_2x2_2x4", "t4_twofloat", pars.ndim,
                                     stats, B_df, steps_df, times, platform))
                print(f"  t4_twofloat: "
                      f"{results[-1]['traj_steps_per_s']:14,.0f} "
                      f"traj-steps/s", flush=True)
            except Exception as err:
                results.append({"config": "t4_2x2_2x4", "path": "t4_twofloat",
                                "error": str(err)[:300]})
                print(f"  t4_twofloat: FAILED ({str(err)[:120]})", flush=True)
        except Exception as err:
            results.append({"config": "t4_2x2_2x4", "path": "t4",
                            "error": str(err)[:300]})
            print(f"  t4    : FAILED ({str(err)[:120]})", flush=True)
        flush()

    if os.environ.get("QGS_RES_RECOMPILE", "1") != "0":
        # same-shape / new-parameters dispatch: with the tensor as a device
        # argument, the second model must reuse the first's compiled scan
        # instead of compiling again
        try:
            from qgs_jax.ops.contraction import make_tendency_fns
            na, no = CONFIGS["6x6_6x6"]
            timing = {}
            runs = []
            for tag, kd in (("first_model", 0.0290), ("second_model", 0.0350)):
                t0 = time.time()
                pars, tensor = build(na, no)        # rebuild (fresh params)
                if kd != 0.0290:
                    # perturb a physics parameter; same sparsity layout
                    pars.set_params({'kd': kd, 'kdp': kd})
                    from qgs_jax.models.tendencies import create_tendencies
                    _, _, tensor = create_tendencies(pars,
                                                     return_qgtensor=True)
                build_s = time.time() - t0
                run = make_xla_runner(tensor, "dense", jnp.float32, 50)
                y0 = jnp.asarray(np.random.default_rng(0)
                                 .random((64, pars.ndim)) * 0.01, jnp.float32)
                t0 = time.time()
                jax.block_until_ready(run(y0))
                timing[tag] = {"host_build_s": round(build_s, 2),
                               "first_dispatch_s": round(time.time() - t0, 3)}
                runs.append(np.asarray(run(y0)))
            timing["results_differ"] = bool(
                not np.allclose(runs[0], runs[1]))
            results.append({"config": "6x6_6x6", "path": "recompile_check",
                            "ndim": pars.ndim, **timing})
            print(f"  recompile_check: first {timing['first_model']}, "
                  f"second {timing['second_model']}", flush=True)
        except Exception as err:
            results.append({"config": "6x6_6x6", "path": "recompile_check",
                            "error": str(err)[:300]})
            print(f"  recompile_check: FAILED ({str(err)[:120]})", flush=True)
        flush()

    print(json.dumps(flush()))


if __name__ == "__main__":
    main()
