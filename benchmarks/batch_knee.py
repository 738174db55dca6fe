#!/usr/bin/env python
"""Batch-scaling benchmark: throughput vs ensemble size, both precisions.

The integrators split per-device batches larger than a chunk threshold
into sequential ``lax.map`` chunks inside the time step
(``QGS_DF_BATCH_CHUNK`` for the double-float kernels, ``QGS_F32_BATCH_CHUNK``
for the single-float ones; 0 disables chunking, see
``qgs_jax/integrators/rk.py``).  This benchmark times the chunked step
(with the threshold in force) against the unchunked one at B = 2048..16384
(double-float) and B = 8192..65536 (float32), so the card says whether
chunking wins anywhere.

Run on the GPU: ``python benchmarks/batch_knee.py``
Env: QGS_KNEE_OUT (JSON path), QGS_KNEE_STEPS (default 400),
QGS_KNEE_CHUNKED_ONLY=1 to skip the unchunked comparison rows,
QGS_KNEE_SKIP_F32=1 / QGS_KNEE_SKIP_DF=1 to run one section only.
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import json
import os
import time
from functools import partial

import numpy as np

STEPS = int(os.environ.get("QGS_KNEE_STEPS", 400))
BATCHES = (2048, 4096, 8192, 16384)
BATCHES_F32 = (8192, 16384, 32768, 65536)


def _measure(runners, make_y0, batches, get_probe):
    """Best-of-3 steady-state timing of each (variant, B) ``run(y)``
    point (operand threading, if any, is closed over by the runner)."""
    import jax

    points = []
    for B in batches:
        y0 = make_y0(B)
        for name, run in runners.items():
            y = run(y0)
            jax.block_until_ready(y)
            best = None
            for _ in range(3):
                t0 = time.perf_counter()
                y = run(y)
                jax.block_until_ready(y)
                el = time.perf_counter() - t0
                best = el if best is None else min(best, el)
            if not np.isfinite(np.asarray(get_probe(y))).all():
                raise RuntimeError("non-finite state")
            steps_s = STEPS * B / best
            points.append({"variant": name, "ensemble": B, "steps": STEPS,
                           "traj_steps_per_s": steps_s,
                           "s_per_run": round(best, 4)})
            print(f"  {name:9s} B={B:6d}: {steps_s:14,.0f} traj-steps/s",
                  flush=True)
    return points


def _knee_checks(points, batches, top_b):
    """Monotone-in-B (3% noise band) + top-B-within-10%-of-peak checks."""
    by = {(p["variant"], p["ensemble"]): p["traj_steps_per_s"]
          for p in points}
    checks = {}
    if ("chunked", top_b) in by:
        peak = max(v for (n, b), v in by.items() if n == "chunked")
        checks["monotone_chunked"] = all(
            by[("chunked", batches[i + 1])] >= by[("chunked", batches[i])]
            * 0.97 for i in range(len(batches) - 1))
        checks[f"b{top_b}_within_10pct_of_peak"] = (
            by[("chunked", top_b)] >= 0.9 * peak)
    return checks


def main():
    import jax
    import jax.numpy as jnp

    from qgs_jax.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (platform {jax.devices()[0].platform!r})")
    enable_compile_cache()
    # the chunk sizes under test (the integrators default to no chunking)
    os.environ.setdefault("QGS_DF_BATCH_CHUNK", "4096")
    os.environ.setdefault("QGS_F32_BATCH_CHUNK", "16384")

    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.ops.twofloat import df_from_f64, make_df_rk4_step_dynamic
    from qgs_jax.integrators.rk import _chunk_df_apply

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    ndim = pars.ndim

    rng = np.random.default_rng(0)
    comparison = os.environ.get("QGS_KNEE_CHUNKED_ONLY") != "1"
    doc = {"metric": "batch_knee", "ndim": ndim,
           "platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind,
           "device_count": jax.device_count()}

    if os.environ.get("QGS_KNEE_SKIP_DF") != "1":
        step = make_df_rk4_step_dynamic(tensor.tensor)
        apply_raw = step.apply
        dt0 = jnp.asarray(0.0, jnp.float64)
        dt = jnp.asarray(0.1, jnp.float64)

        variants = {"chunked": _chunk_df_apply(apply_raw)}
        if comparison:
            variants["unchunked"] = apply_raw
        runners = {}
        for name, ap in variants.items():
            def run_impl(ops, y, ap=ap):
                return jax.lax.fori_loop(
                    0, STEPS, lambda i, y: ap(ops, y, dt0, dt), y)
            # operands stay jit ARGUMENTS (not baked constants); the
            # runner binds them at call time
            runners[name] = partial(jax.jit(run_impl), step.operands)

        print("double-float tier:", flush=True)
        points = _measure(
            runners,
            lambda B: df_from_f64(jnp.asarray(rng.random((B, ndim)) * 0.01)),
            BATCHES, lambda y: y[0])
        doc.update({
            "points": points,
            "checks": _knee_checks(points, BATCHES, 16384),
            "chunk": int(os.environ["QGS_DF_BATCH_CHUNK"])})

    if os.environ.get("QGS_KNEE_SKIP_F32") != "1":
        from qgs_jax.ops.contraction import make_tendency_fns
        from qgs_jax.integrators.rk import (make_rk_step, rk4_tableau,
                                            _chunk_plain_step)

        f_b, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                                   dtype=jnp.float32)
        base = make_rk_step(f_b, *rk4_tableau())
        dt0f = jnp.asarray(0.0, jnp.float32)
        dtf = jnp.asarray(0.1, jnp.float32)

        variants = {"chunked": _chunk_plain_step(base)}
        if comparison:
            variants["unchunked"] = base
        runners = {}
        for name, st in variants.items():
            def run_impl(y, st=st):
                return jax.lax.fori_loop(
                    0, STEPS, lambda i, y: st(y, dt0f, dtf), y)
            runners[name] = jax.jit(run_impl)

        print("float32 tier:", flush=True)
        points = _measure(
            runners,
            lambda B: jnp.asarray(rng.random((B, ndim)) * 0.01, jnp.float32),
            BATCHES_F32, lambda y: y)
        doc.update({
            "f32_points": points,
            "f32_checks": _knee_checks(points, BATCHES_F32, 65536),
            "f32_chunk": int(os.environ["QGS_F32_BATCH_CHUNK"])})
    out = os.environ.get("QGS_KNEE_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
