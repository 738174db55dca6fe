#!/usr/bin/env python
"""Compile latency of the heaviest program: the double-float TGLS at
ndim 228 (6x6_6x6).

Program size scales with the bucket-ladder size (one gather/reduce
subgraph per bucket per group per tensor; the DP-placed ladder of
``QGS_BUCKET_MAX``, default 16, keeps results bit-identical).  Compilation
is set-up time that users feel on every new shape.

NOTE: the measurement is only meaningful against a COLD persistent cache
for this program shape — the script reports whether the first dispatch
plausibly hit the cache (sub-second) and stamps the active ladder size.

Run on the GPU: ``python benchmarks/compile_latency.py``
Env: QGS_COMPILE_OUT (JSON path), QGS_BUCKET_MAX (ladder size under test).
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import json
import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from qgs_jax.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (platform {jax.devices()[0].platform!r})")
    enable_compile_cache()

    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.rk import integrate_runge_kutta_tgls_df
    from qgs_jax.ops.contraction import default_max_buckets

    t0 = time.time()
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(6, 6)
    pars.set_oceanic_basin_fourier_modes(6, 6)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    build_s = time.time() - t0
    print(f"ndim={pars.ndim} built in {build_s:.0f}s; "
          f"ladder size = {default_max_buckets()}", flush=True)

    rng = np.random.default_rng(0)
    B, n_tg = 4, 4
    ic = rng.random((B, pars.ndim)) * 0.01
    tg = rng.random((n_tg, pars.ndim)) * 1e-4

    t0 = time.time()
    _, traj, fmat = integrate_runge_kutta_tgls_df(
        tensor.tensor, tensor.jacobian_tensor, 0., 0.5, 0.1, ic, tg,
        write_steps=0)
    jax.block_until_ready(fmat)
    first = time.time() - t0
    assert np.isfinite(np.asarray(fmat)).all()

    t0 = time.time()
    _, traj, fmat = integrate_runge_kutta_tgls_df(
        tensor.tensor, tensor.jacobian_tensor, 0., 0.5, 0.1, ic, tg,
        write_steps=0)
    jax.block_until_ready(fmat)
    steady = time.time() - t0

    doc = {"metric": "df_tgls_compile_latency", "ndim": pars.ndim,
           "platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind,
           "bucket_ladder_size": default_max_buckets(),
           "host_build_s": round(build_s, 1),
           "first_dispatch_s": round(first, 1),
           "steady_dispatch_s": round(steady, 3),
           "likely_cache_hit": first < 20.0}
    out = os.environ.get("QGS_COMPILE_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
