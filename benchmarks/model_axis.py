#!/usr/bin/env python
"""Model-axis (mode-space tensor-parallel) mesh benchmark at high ndim.

Runs the 8,8/8,8 MAOOAM truncation (ndim 400 — the regime where model
parallelism matters) over 2-D ``(ensemble, model)`` meshes
(``qgs_jax/parallel/sharded_tendency.py``), comparing the two model-axis
kernels at model = 1 / 2 / 4 (/ 8) and fixed global batch:

* **bucketed** (default): output rows of the count-bucketed gather kernel
  partitioned across the model axis — disjoint rows, no psum, one
  all_gather of the compact per-device row block;
* **dense**: the matricized tensor's reduction axis sharded, one psum per
  RK stage, plus the chunked-psum overlap variant (``overlap_chunks``).

The mesh is the 8-virtual-device CPU host platform: all configurations
share the host's cores, so wall-clock compares PROGRAM overhead
(collective count/schedule), not interconnect speed — the point is an
artifact showing that the 2-D layouts compile, run, agree with the
replicated oracle, and that the psum cost share is quantified.  The same
programs run unchanged on a multi-GPU host.

Run: ``python benchmarks/model_axis.py`` (forces CPU + 8 virtual devices).
Env: QGS_MODEL_AXIS_CONFIG (default 8x8_8x8), QGS_MODEL_AXIS_OUT (JSON).
"""

import os
import sys as _sys
import pathlib as _pathlib

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import json
import time

import numpy as np

CONFIGS = {
    "2x2_2x4": ((2, 2), (2, 4)),
    "6x6_6x6": ((6, 6), (6, 6)),
    "8x8_8x8": ((8, 8), (8, 8)),
}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.parallel.sharded_tendency import make_sharded_tendency
    from qgs_jax.parallel.distributed import make_global_array, gather_to_host

    key = os.environ.get("QGS_MODEL_AXIS_CONFIG", "8x8_8x8")
    na, no = CONFIGS[key]

    t0 = time.time()
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*na)
    pars.set_oceanic_basin_fourier_modes(*no)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    ndim = pars.ndim
    print(f"[{key}] ndim={ndim} built in {time.time()-t0:.0f}s", flush=True)

    a, b, c = rk4_tableau()
    B = 64
    STEPS = 3
    rng = np.random.default_rng(0)
    ic = (rng.random((B, ndim)) * 0.01).astype(np.float32)

    # replicated single-device oracle (dense path, same arithmetic)
    from qgs_jax.ops.contraction import make_tendency_fns
    f_dense, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                                   mode="dense", dtype=jnp.float32)
    step_ref = jax.jit(make_rk_step(f_dense, a, b, c))
    y_ref = np.asarray(step_ref(jnp.asarray(ic), jnp.asarray(0.0, jnp.float32),
                                jnp.asarray(0.1, jnp.float32)))

    devices = np.array(jax.devices())
    results = []
    for kern, model, chunks in [("bucketed", 1, 1), ("bucketed", 2, 1),
                                ("bucketed", 4, 1), ("bucketed", 8, 1),
                                ("dense", 1, 1), ("dense", 2, 1),
                                ("dense", 4, 1), ("dense", 4, 4)]:
        ens = devices.size // model
        mesh = Mesh(devices.reshape(ens, model), ("ensemble", "model"))
        f_sh = make_sharded_tendency(tensor.tensor, mesh, dtype=jnp.float32,
                                     overlap_chunks=chunks, kernel=kern)
        step = jax.jit(make_rk_step(f_sh, a, b, c))
        x = make_global_array(ic, mesh, P("ensemble", None))
        dt0 = jnp.asarray(0.0, jnp.float32)
        dt = jnp.asarray(0.1, jnp.float32)

        y = step(x, dt0, dt)
        jax.block_until_ready(y)
        err = float(np.abs(gather_to_host(y) - y_ref).max())

        best = None
        for _ in range(3):
            yy = x
            t1 = time.perf_counter()
            for _ in range(STEPS):
                yy = step(yy, dt0, dt)
            jax.block_until_ready(yy)
            el = (time.perf_counter() - t1) / STEPS
            best = el if best is None else min(best, el)

        results.append({"kernel": kern,
                        "mesh": {"ensemble": ens, "model": model},
                        "overlap_chunks": chunks, "ndim": ndim,
                        "global_batch": B, "s_per_rk4_step": best,
                        "max_err_vs_replicated": err})
        print(f"  {kern:8s} ensemble={ens} model={model} chunks={chunks}: "
              f"{best*1e3:8.1f} ms/step  err={err:.2e}", flush=True)
        assert err < 1e-4, err
    # the headline comparison: bucketed row-sharding must beat the dense
    # psum path at every model-axis width (it attaches the measured-fastest
    # kernel to a cheaper collective)
    by = {(r["kernel"], r["mesh"]["model"], r["overlap_chunks"]):
          r["s_per_rk4_step"] for r in results}
    for model in (2, 4):
        speedup = by[("dense", model, 1)] / by[("bucketed", model, 1)]
        print(f"  bucketed vs dense @ model={model}: {speedup:.1f}x",
              flush=True)

    doc = {"metric": "model_axis_mesh", "config": key, "ndim": ndim,
           "platform": "cpu-virtual-8dev", "physical_cores": os.cpu_count(),
           "note": ("all meshes share the same physical cores; this "
                    "artifact verifies the 2-D program + quantifies "
                    "schedule overhead, not interconnect bandwidth"),
           "points": results}
    out = os.environ.get("QGS_MODEL_AXIS_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
