#!/usr/bin/env python
"""Profile ~20 MAOOAM RK4 steps on the GPU and reduce the trace to device
kernels per step and the device idle share.

    python benchmarks/trace_rk4.py [--out DIR] [--steps 20] [--batch 4096]

Runs the integrator's scan (``integrate_runge_kutta``, write_steps=0) in
float64 and the double-float step loop, each warmed up first, then traced
once with ``jax.profiler``.  The reduction reads the ``.xplane.pb`` file:
kernel events are those on the device plane's ``Stream`` lines; busy time
is the union of their intervals; the idle share is ``1 - busy / wall``
with ``wall`` the host time of the traced call (dispatch to ready).
Refuses to run without a GPU.
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import argparse
import collections
import glob
import json
import os
import time

import numpy as np


def union_ns(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(path, n_steps, wall_s, device_prefix="/device:GPU"):
    """Kernel count, busy time and idle share of one trace file."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    lines_seen, intervals = [], []
    by_name = collections.Counter()
    for plane in pd.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen.append(f"{plane.name}:{line.name}:{len(events)}")
            if not line.name.startswith("Stream"):
                continue
            for ev in events:
                intervals.append((ev.start_ns, ev.end_ns))
                by_name[ev.name] += ev.duration_ns
    busy_ns = union_ns(intervals)
    span_ns = (max(e for _, e in intervals) - min(s for s, _ in intervals)
               if intervals else 0.0)
    return {
        "lines": lines_seen,
        "kernels": len(intervals),
        "kernels_per_step": len(intervals) / n_steps,
        "busy_s": busy_ns * 1e-9,
        "device_span_s": span_ns * 1e-9,
        "wall_s": wall_s,
        "idle_share_of_wall": 1.0 - busy_ns * 1e-9 / wall_s,
        "idle_share_of_span": (1.0 - busy_ns / span_ns) if span_ns else None,
        "top_kernels_ns": by_name.most_common(8),
    }


def main():
    import jax
    import jax.numpy as jnp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="traces")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=4096)
    args = parser.parse_args()

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (platform {jax.devices()[0].platform!r})")

    from qgs_jax.utils.compile_cache import enable_compile_cache
    from qgs_jax.integrators.rk import integrate_runge_kutta
    from qgs_jax.ops.twofloat import df_from_f64, make_df_rk4_step
    from chip_smoke import Model, maooam_params, make_ics, card_description

    enable_compile_cache()
    model = Model(maooam_params())
    ic = make_ics(model.ndim, args.batch, 0)
    step = make_df_rk4_step(model.qgt.tensor, 0.1)
    df_run = jax.jit(lambda y: jax.lax.fori_loop(
        0, args.steps, lambda i, y: step(y), y))
    y_df = df_from_f64(jnp.asarray(ic))
    runs = {
        "f64_integrator_scan": lambda: integrate_runge_kutta(
            model.f.batched, 0., args.steps * 0.1, 0.1, ic,
            write_steps=0)[1],
        "twofloat_step_loop": lambda: df_run(y_df),
    }
    report = {"card": card_description(), "steps": args.steps,
              "batch": args.batch, "ndim": model.ndim}
    for name, run in runs.items():
        jax.block_until_ready(run())                  # compile + warm up
        out_dir = os.path.join(args.out, name)
        with jax.profiler.trace(out_dir):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run())
            wall = time.perf_counter() - t0
        leaves = jax.tree_util.tree_leaves(out)
        if not all(np.isfinite(np.asarray(x)).all() for x in leaves):
            raise RuntimeError(f"{name}: non-finite state")
        path = sorted(glob.glob(os.path.join(
            out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        report[name] = reduce_trace(path, args.steps, wall)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
