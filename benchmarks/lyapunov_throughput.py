#!/usr/bin/env python
"""Lyapunov-toolbox throughput: batched Benettin BLV + CLV tiers across
spectral resolutions.

The reference computes Lyapunov vectors one trajectory per OS process with
per-step Python/Numba QR (ref ``qgs/toolbox/lyapunov.py:396-513``); here
the whole ensemble propagates its fundamental matrices in one batched
``lax.scan`` and a batched QR re-orthonormalizes all members at once on
device.

BLV tiers (per resolution):

* ``f32``      — everything in float32 (the raw-throughput tier; exponents
                 carry ~1e-5-level arithmetic noise).
* ``twofloat`` — tangent propagation in double-float (2x float32) with the
                 platform's window QR (``qgs_jax.utils.backend``): ~f64
                 exponent accuracy.
* ``float64``  — native f64 oracle (small ensemble, MAOOAM scale only).

CLV tiers (MAOOAM scale): Ginelli f32, Ginelli twofloat, subspace f32 —
the full CLV menu of the reference (ref ``lyapunov.py:1175,1293``).

Each tier reports an exponent-accuracy column: the mean-exponent deviation
from the f64 oracle on identical ICs over a short span (where chaotic
divergence between tiers stays bounded).

Resolutions: MAOOAM 2,2/2,4 (ndim 36), 4,4/4,4 (ndim 104) and 6,6/6,6
(ndim 228) — the latter two stress the count-bucketed direct tangent
kernel (``make_bucketed_tangent``).

Run on the GPU: ``python benchmarks/lyapunov_throughput.py``
Env knobs: QGS_LYAP_ENSEMBLE (default 256), QGS_LYAP_WINDOWS (default 200),
QGS_LYAP_TIERS (comma list, default "f32,twofloat,float64"),
QGS_LYAP_CONFIGS (comma list of {2x2_2x4,4x4_4x4,6x6_6x6}),
QGS_LYAP_CLV=0 to skip the CLV tiers, QGS_LYAP_ACCURACY=0 to skip the
accuracy cross-checks, QGS_LYAP_OUT (output JSON path).
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import json
import os
import time

import numpy as np

CONFIGS = {
    "2x2_2x4": ((2, 2), (2, 4)),
    "4x4_4x4": ((4, 4), (4, 4)),
    "6x6_6x6": ((6, 6), (6, 6)),
}

# per-ndim sizing: (B, windows) — the fundamental-matrix blocks are
# (B, n, n), so the batch shrinks as ndim grows
def sizing(ndim, B_base, wind_base):
    if ndim <= 40:
        return B_base, wind_base
    if ndim <= 120:
        return max(B_base // 4, 16), max(wind_base // 2, 20)
    return max(B_base // 16, 8), max(wind_base // 4, 20)


def build(key):
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    na, no = CONFIGS[key]
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
    return pars, f, Df, tensor


def main():
    import jax
    import jax.numpy as jnp

    from qgs_jax.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (platform {jax.devices()[0].platform!r})")
    enable_compile_cache()

    from qgs_jax.integrators.rk import integrate_runge_kutta
    from qgs_jax.ops.contraction import make_tendency_fns
    from qgs_jax.toolbox.lyapunov import (compute_backward_lyapunovs,
                                          compute_clvs_ginelli,
                                          compute_clvs_subspace)

    B_base = int(os.environ.get("QGS_LYAP_ENSEMBLE", 256))
    wind_base = int(os.environ.get("QGS_LYAP_WINDOWS", 200))
    tiers = os.environ.get("QGS_LYAP_TIERS", "f32,twofloat,float64").split(",")
    cfg_keys = os.environ.get("QGS_LYAP_CONFIGS", ",".join(CONFIGS)).split(",")
    out_path = os.environ.get("QGS_LYAP_OUT")
    dt, mdt = 0.1, 0.1

    doc = {"metric": "lyapunov_toolbox_throughput", "dt": dt, "mdt": mdt,
           "platform": None, "device_kind": None, "configs": {}}

    def flush():
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(doc, fh, indent=1)

    for key in cfg_keys:
        t_build = time.time()
        pars, f, Df, tensor = build(key)
        ndim = pars.ndim
        tensors = (tensor.tensor, tensor.jacobian_tensor)
        B, n_windows = sizing(ndim, B_base, wind_base)
        print(f"[{key}] ndim={ndim} B={B} windows={n_windows} "
              f"(built in {time.time()-t_build:.0f}s)", flush=True)

        doc["platform"] = jax.devices()[0].platform
        doc["device_kind"] = jax.devices()[0].device_kind

        rng = np.random.default_rng(0)
        ic64 = rng.random((B, ndim)) * 0.01
        _, ic64 = integrate_runge_kutta(f.batched, 0., 100., dt, ic64,
                                        write_steps=0)
        ic64 = np.atleast_2d(np.asarray(ic64))

        f32b, j32b = make_tendency_fns(tensor.tensor,
                                       tensor.jacobian_tensor,
                                       dtype=jnp.float32)

        results = {}
        cfg_doc = {"ndim": ndim, "nnz": int(tensor.tensor.nnz),
                   "tiers": results}
        doc["configs"][key] = cfg_doc

        def run_tier(tier, B_t, windows):
            span = (0., dt, dt + windows * dt, dt, mdt)
            if tier == "f32":
                args = dict(f=f32b, fjac=j32b,
                            ic=np.asarray(ic64[:B_t], np.float32),
                            tensors=tensors)
            elif tier == "twofloat":
                args = dict(f=f.batched, fjac=Df.batched, ic=ic64[:B_t],
                            precision="twofloat", tensors=tensors)
            else:
                args = dict(f=f.batched, fjac=Df.batched, ic=ic64[:B_t],
                            tensors=tensors)

            def run():
                out = compute_backward_lyapunovs(
                    args["f"], args["fjac"], *span, args["ic"],
                    write_steps=0, precision=args.get("precision"),
                    tensors=args.get("tensors"))
                jax.block_until_ready(out[1])
                return out

            run()                               # compile + warmup
            best, out = None, None
            for _ in range(3):
                t0 = time.perf_counter()
                out = run()
                el = time.perf_counter() - t0
                best = el if best is None else min(best, el)
            return best, out

        for tier in tiers:
            if tier == "float64" and ndim > 40:
                continue                    # the f64 oracle runs at MAOOAM scale
            B_t = min(B, 16) if tier == "float64" else B
            windows = min(n_windows, 50) if tier == "float64" else n_windows
            try:
                elapsed, out = run_tier(tier, B_t, windows)
            except Exception as err:
                results[tier] = {"error": str(err)[:300]}
                print(f"  {tier:>9}: FAILED ({str(err)[:120]})", flush=True)
                flush()
                continue
            windows_s = windows * B_t / elapsed
            m = np.asarray(out[2], np.float64)
            lead = m.reshape(B_t, ndim)[:, 0].mean()
            results[tier] = {
                "qr_windows_per_s_x_ensemble": windows_s,
                "tangent_substeps_per_s_x_ensemble": windows_s * round(dt / mdt),
                "ensemble": B_t, "windows": windows,
                "elapsed_s_best_of_3": elapsed,
                "mean_leading_exponent": float(lead),
            }
            print(f"  {tier:>9}: B={B_t:4d} x {windows} windows: "
                  f"{windows_s:12,.0f} QR-windows/s x ensemble "
                  f"({elapsed:.2f}s)", flush=True)
            flush()

        # exponent accuracy vs the f64 oracle, identical ICs, short span
        if os.environ.get("QGS_LYAP_ACCURACY", "1") != "0":
            B_a = min(B, 4)
            span_t = 40 if ndim <= 40 else 10
            span = (0., 5., 5. + span_t, dt, mdt)
            try:
                _, _, e64, _ = compute_backward_lyapunovs(
                    f.batched, Df.batched, *span, ic64[:B_a], write_steps=1)
                _, _, edf, _ = compute_backward_lyapunovs(
                    f.batched, Df.batched, *span, ic64[:B_a], write_steps=1,
                    precision="twofloat", tensors=tensors)
                _, _, e32, _ = compute_backward_lyapunovs(
                    f32b, j32b, *span, np.asarray(ic64[:B_a], np.float32),
                    write_steps=1)
                m64 = np.asarray(e64).mean(-1)
                err_df = float(np.abs(m64 - np.asarray(edf).mean(-1)).max())
                err_32 = float(np.abs(
                    m64 - np.asarray(e32, np.float64).mean(-1)).max())
                cfg_doc["accuracy"] = {
                    "span_time_units": span_t, "ensemble": B_a,
                    "max_mean_exp_err_twofloat_vs_f64": err_df,
                    "max_mean_exp_err_f32_vs_f64": err_32}
                print(f"  accuracy ({span_t} tu): twofloat-f64 {err_df:.2e},"
                      f" f32-f64 {err_32:.2e}", flush=True)
            except Exception as err:
                cfg_doc["accuracy"] = {"error": str(err)[:300]}
            flush()

        # CLV tiers at every resolution (the subspace tier's intersection
        # is batched matmuls on the device, so it scales with the Benettin
        # passes; the recorded (B, n, n, T) vector blocks bound the batch
        # as ndim grows — the same memory-in-trajectory-length constraint
        # the reference documents)
        if os.environ.get("QGS_LYAP_CLV", "1") != "0":
            if ndim <= 40:
                B_c, w_c = min(B, 64), min(n_windows, 100)
            elif ndim <= 120:
                B_c, w_c = 16, 50
            else:
                B_c, w_c = 4, 50
            span = (0., 5 * dt, 5 * dt + w_c * dt,
                    5 * dt + (w_c + 20) * dt, dt, mdt)

            def time_clv(fn):
                fn()
                best = None
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    best = min(best or 9e9, time.perf_counter() - t0)
                return best

            clv_tiers = {
                "clv_ginelli_f32": lambda: compute_clvs_ginelli(
                    f32b, j32b, *span, np.asarray(ic64[:B_c], np.float32),
                    write_steps=0, tensors=tensors),
                "clv_ginelli_twofloat": lambda: compute_clvs_ginelli(
                    f.batched, Df.batched, *span, ic64[:B_c],
                    write_steps=0, precision="twofloat", tensors=tensors),
                "clv_subspace_f32": lambda: compute_clvs_subspace(
                    f32b, j32b, *span, np.asarray(ic64[:B_c], np.float32),
                    write_steps=1, tensors=tensors),
            }
            for name, mk in clv_tiers.items():
                def runner(mk=mk):
                    out = mk()
                    jax.block_until_ready(out[3])
                try:
                    best = time_clv(runner)
                except Exception as err:
                    results[name] = {"error": str(err)[:300]}
                    print(f"  {name:>9}: FAILED ({str(err)[:120]})",
                          flush=True)
                    flush()
                    continue
                results[name] = {
                    "qr_windows_per_s_x_ensemble": w_c * B_c / best,
                    "ensemble": B_c, "windows": w_c,
                    "elapsed_s_best_of_3": best,
                }
                print(f"  {name:>21}: B={B_c:4d} x {w_c} windows: "
                      f"{w_c * B_c / best:12,.0f} QR-windows/s x ensemble "
                      f"({best:.2f}s)", flush=True)
                flush()

    flush()
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
