#!/usr/bin/env python
"""Run the ensemble RK4 / tangent-linear / Lyapunov path on an NVIDIA GPU
and check every phase against the repository's plain references.

    python chip_smoke.py           # phases 0-6 on one card
    python chip_smoke.py --four    # the four-card mesh phase, and nothing else

Every phase prints one line: the card (``nvidia-smi`` name and power
limit), its wall time, its sizes and its worst error beside the tolerance
it is held to.  A failed check raises; nothing is caught.  The last line is
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
before the first phase and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DT = 0.1


class SmokeFailure(RuntimeError):
    """A phase's result fell outside its tolerance."""


class Phase:
    """One phase's checks and sizes, printed as one line."""

    def __init__(self, name):
        self.name = name
        self.t0 = time.perf_counter()
        self.sizes = {}
        self.checks = []
        self.info = {}

    def check(self, label, err, tol, why):
        """Record ``err <= tol`` (NaN fails); raise when it does not hold."""
        err = float(err)
        self.checks.append((label, err, tol, why))
        if not err <= tol:
            raise SmokeFailure(f"{self.name}: {label} error {err:.3e} is "
                               f"above its tolerance {tol:.1e} ({why})")

    def line(self, card):
        wall = time.perf_counter() - self.t0
        sizes = " ".join(f"{k}={v}" for k, v in self.sizes.items())
        checks = "; ".join(f"{lab} {err:.3e} <= {tol:.1e} [{why}]"
                           for lab, err, tol, why in self.checks)
        info = " ".join(f"{k}={v}" for k, v in self.info.items())
        worst = max((e / t for _, e, t, _ in self.checks if t > 0),
                    default=0.0)
        return (f"{self.name} | card: {card} | wall {wall:.2f} s | {sizes} "
                f"| worst err/tol {worst:.3e} | {checks} | {info}")


def card_description():
    """``nvidia-smi``'s name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = (ln.strip() for ln in out.stdout.splitlines())
    return "; ".join(ln for ln in lines if ln)


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _allclose_excess(got, ref, rtol, atol):
    """Worst ``|got - ref| - rtol |ref|``: ``np.allclose(got, ref, rtol,
    atol)`` holds exactly when this is <= atol."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) - rtol * np.abs(ref)))


def maooam_params(atmosphere=(2, 2), ocean=(2, 4)):
    """The coupled ocean-atmosphere model with the parameters of
    ``bench.py``: MAOOAM 2x2 atmosphere / 2x4 ocean (ndim 36) by default,
    and the ``6x6_6x6`` point of ``benchmarks/resolution_sweep.py``
    (ndim 228) with ``atmosphere=ocean=(6, 6)``."""
    from qgs_jax.params.params import QgParams

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*atmosphere)
    pars.set_oceanic_basin_fourier_modes(*ocean)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


def make_ics(ndim, batch, seed):
    return np.random.default_rng(seed).random((batch, ndim)) * 0.01


class Model:
    """One model built through the user entry point, shared by the phases."""

    def __init__(self, pars, seed=0):
        from qgs_jax.models.tendencies import create_tendencies

        self.pars = pars
        self.ndim = pars.ndim
        self.f, self.Df, self.qgt = create_tendencies(pars,
                                                      return_qgtensor=True)
        self.seed = seed


# ---------------------------------------------------------------------------
# host references (plain NumPy, independent of the device path)
# ---------------------------------------------------------------------------

def host_rk4(model, ic, n_steps, fast=False):
    """``n_steps`` RK4 steps of each member on the host with
    ``models/numpy_backend.py`` (the scalar loop keeps the reference
    summation order; ``fast`` uses its vectorised twin for large tensors)."""
    from qgs_jax.models import numpy_backend as nb

    make = nb.make_numpy_tendencies_fast if fast else nb.make_numpy_tendencies
    fn, _ = make(model.qgt.tensor, model.qgt.jacobian_tensor)
    _, y = nb.integrate_runge_kutta_numpy(fn, 0., n_steps * DT, DT, ic,
                                          write_steps=0)
    return np.asarray(y).reshape(np.shape(ic))


def _host_tgls_step(fn, Dfn, y, M, h):
    """One RK4 step of the coupled (trajectory, fundamental matrix) system,
    the stage structure of ``integrators/rk.py:make_tgls_step``."""
    a = [[], [0.5], [0., 0.5], [0., 0., 1.]]
    b = [1 / 6, 1 / 3, 1 / 3, 1 / 6]
    k, km = [], []
    for i in range(4):
        ys, Ms = y.copy(), M.copy()
        for l, al in enumerate(a[i]):
            if al:
                ys = ys + h * al * k[l]
                Ms = Ms + h * al * km[l]
        k.append(fn(0., ys))
        km.append(Dfn(0., ys) @ Ms)
    for i in range(4):
        y = y + h * b[i] * k[i]
        M = M + h * b[i] * km[i]
    return y, M


def host_tgls(model, ic, n_steps):
    """Host fundamental matrices after ``n_steps`` steps, one member each."""
    from qgs_jax.models.numpy_backend import make_numpy_tendencies_fast

    fn, Dfn = make_numpy_tendencies_fast(model.qgt.tensor,
                                         model.qgt.jacobian_tensor)
    out = []
    for y in ic:
        M = np.eye(model.ndim)
        for _ in range(n_steps):
            y, M = _host_tgls_step(fn, Dfn, y, M, DT)
        out.append(M)
    return np.stack(out)


def host_backward_lyapunov(model, ic, n_pre, n_rec, seed=0):
    """Benettin QR on the host, window = one RK4 step of length ``DT``:
    the exponent stream ``compute_backward_lyapunovs`` records (its first
    entry is the zero carry-in, as there)."""
    from qgs_jax.models.numpy_backend import make_numpy_tendencies_fast

    fn, Dfn = make_numpy_tendencies_fast(model.qgt.tensor,
                                         model.qgt.jacobian_tensor)
    n = model.ndim
    Q0 = np.linalg.qr(np.random.default_rng(seed).random((n, n)))[0]
    out = []
    for y in ic:
        Q = Q0.copy()
        exps = [np.zeros(n)]
        for w in range(n_pre + n_rec):
            y, M = _host_tgls_step(fn, Dfn, y, Q, DT)
            Q, R = np.linalg.qr(M)
            if w >= n_pre:
                exps.append(np.log(np.abs(np.diag(R))) / DT)
        out.append(np.stack(exps, axis=-1))
    return np.stack(out)                                 # (B, n, n_rec + 1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_flagship(model, batch=4096, n_cmp=8, steps_cmp=100,
                   steps_time=5000):
    """Phase 1: float64 ensemble through ``RungeKuttaIntegrator``."""
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator

    ph = Phase("phase 1 flagship f64")
    ph.sizes = dict(ndim=model.ndim, B=batch, steps=f"{steps_cmp}+"
                    f"{steps_time}", write_steps=10, dtype="float64")
    ic = make_ics(model.ndim, batch, model.seed)
    integ = RungeKuttaIntegrator()
    integ.set_func(model.f)
    integ.integrate(0., steps_cmp * DT, DT, ic=ic, write_steps=10)
    _, traj = integ.get_trajectories()
    y64 = traj[..., -1]
    ref = host_rk4(model, ic[:n_cmp], steps_cmp)
    # tests/test_trajectory.py::test_trajectory_matches_reference_semantics
    ph.check("vs numpy_backend (allclose excess over rtol 1e-9)",
             _allclose_excess(y64[:n_cmp], ref, 1e-9, 0.0), 1e-11,
             "tests/test_trajectory.py rtol=1e-9 atol=1e-11")

    def run():
        integ.integrate(0., steps_time * DT, DT, ic=ic, write_steps=10)
        return integ.get_trajectories()[1]

    traj, first = _timed(run)
    traj, steady = _timed(run)
    if not np.isfinite(traj).all():
        raise SmokeFailure("phase 1: non-finite trajectory")
    ph.info = dict(first_call_s=f"{first:.3f}", steady_s=f"{steady:.3f}",
                   traj_steps_per_s=f"{batch * steps_time / steady:.6e}",
                   note="steady time includes the record transfer to host")
    return ph, y64


def phase_f32(model, y64, batch=4096, steps_cmp=100):
    """Phase 2: float32 tendencies (``create_tendencies(dtype=float32)``)
    through the same run, and the f32 Jacobian matmul's precision."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.ops.contraction import make_coo_jacobian

    ph = Phase("phase 2 f32 tier")
    ph.sizes = dict(ndim=model.ndim, B=batch, steps=steps_cmp,
                    dtype="float32")
    f32, _ = create_tendencies(model.pars, dtype=jnp.float32)
    ic = make_ics(model.ndim, batch, model.seed).astype(np.float32)
    integ = RungeKuttaIntegrator()
    integ.set_func(f32)
    integ.integrate(0., steps_cmp * DT, DT, ic=ic, write_steps=10)
    _, traj = integ.get_trajectories()
    if traj.dtype != np.float32:
        raise SmokeFailure(f"phase 2: trajectory came back as {traj.dtype}")
    scale = float(np.max(np.abs(y64)))
    ph.check("trajectory vs f64 (max abs / max|x|)",
             _max_abs(traj[..., -1], y64) / scale, 1e-4,
             "f32 rounding 6e-8 per op grown over 100 steps; the CPU "
             "reads 6.4e-6")

    jt = model.qgt.jacobian_tensor
    x = make_ics(model.ndim, 64, model.seed + 1)
    xx = np.concatenate([np.ones((64, 1)), x], axis=1)
    j64 = np.asarray(jax.jit(make_coo_jacobian(jt, jnp.float64))(
        jnp.asarray(xx)))
    j32 = np.asarray(jax.jit(make_coo_jacobian(jt, jnp.float32))(
        jnp.asarray(xx, jnp.float32)))
    jscale = float(np.max(np.abs(j64)))
    ph.check("Jacobian matmul (HIGHEST) vs f64, max abs / max|J|",
             _max_abs(j32, j64) / jscale, 1e-6,
             "true f32 products sit at ~1e-7; a reduced-precision "
             "product (DEFAULT read 2.1e-4 on an H100) must fail this bound")
    jdef = np.asarray(jax.jit(make_coo_jacobian(
        jt, jnp.float32, precision=jax.lax.Precision.DEFAULT))(
        jnp.asarray(xx, jnp.float32)))
    ph.info = dict(jacobian_default_precision_rel_err=
                   f"{_max_abs(jdef, j64) / jscale:.3e}")
    return ph


def _loop_runner(step, n_steps):
    import jax

    @jax.jit
    def run(y):
        return jax.lax.fori_loop(0, n_steps, lambda i, y: step(y), y)

    return run


def phase_twofloat(model, y64, batch=4096, steps_cmp=100, batch_time=16384,
                   steps_time=1000, df_tol=1e-12):
    """Phase 3: the double-float tier against native float64, and the
    'fast' / 'strict' accumulation modes timed beside the f64 step.
    ``df_tol`` is the tier's 1e-12 promise; XLA:CPU strips the EFT
    barriers, so a CPU rehearsal passes a looser bound."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.ops.twofloat import df_from_f64, df_to_f64, make_df_rk4_step
    from qgs_jax.utils.backend import backend_policy

    ph = Phase("phase 3 twofloat tier")
    ph.sizes = dict(ndim=model.ndim, B=batch, steps=steps_cmp,
                    B_time=batch_time, steps_time=steps_time)
    ic = make_ics(model.ndim, batch, model.seed)
    integ = RungeKuttaIntegrator(precision="twofloat")
    integ.set_func(model.f)
    integ.integrate(0., steps_cmp * DT, DT, ic=ic, write_steps=10)
    ydf = integ.get_trajectories()[1][..., -1]
    why = "absolute; the double-float tier's promise"
    ph.check(f"integrator twofloat "
             f"(accumulate={backend_policy().accumulate}) vs f64",
             _max_abs(ydf, y64), df_tol, why)

    tensor = model.qgt.tensor
    y_big = jnp.asarray(make_ics(model.ndim, batch_time, model.seed + 2))
    times = {}
    for mode in ("fast", "strict"):
        step = make_df_rk4_step(tensor, DT, accumulate=mode)
        out = _loop_runner(step, steps_cmp)(df_from_f64(jnp.asarray(ic)))
        ph.info[f"{mode}_vs_f64"] = f"{_max_abs(df_to_f64(out), y64):.3e}"
        run = _loop_runner(step, steps_time)
        y0 = df_from_f64(y_big)
        _timed(run, y0)
        times[mode] = _timed(run, y0)[1]
    f64_step = make_rk_step(model.f.batched, *rk4_tableau())
    dt64 = jnp.asarray(DT)
    run = _loop_runner(lambda y: f64_step(y, dt64 * 0, dt64), steps_time)
    _timed(run, y_big)
    times["f64"] = _timed(run, y_big)[1]
    n = batch_time * steps_time
    ph.info.update({f"{k}_s": f"{v:.4f} ({n / v:.6e} traj-steps/s)"
                    for k, v in times.items()})
    return ph


def phase_tangent(model, batch_tgls=256, n_cmp=4, steps=100, batch_lyap=64,
                  n_pre=10, n_rec=20, batch_clv=16, df_tol=1e-9):
    """Phase 4: tangent-linear integration, Benettin exponents in f64 and
    double-float, the window QR methods, and the f32 subspace CLVs
    (``df_tol`` bounds the double-float exponents, as in phase 3)."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.ops.twofloat import df_from_f64
    from qgs_jax.toolbox.lyapunov import (compute_backward_lyapunovs,
                                          compute_clvs_subspace,
                                          make_window_step_df)

    ph = Phase("phase 4 tangent + Lyapunov")
    ph.sizes = dict(ndim=model.ndim, B_tgls=batch_tgls, steps=steps,
                    B_lyap=batch_lyap, windows=f"{n_pre}+{n_rec}",
                    B_clv=batch_clv)
    n = model.ndim
    # start on the attractor's neighbourhood: 200 time units from the ICs
    from qgs_jax.integrators.rk import integrate_runge_kutta
    ic0 = make_ics(n, max(batch_tgls, batch_lyap, batch_clv), model.seed)
    _, ic = integrate_runge_kutta(model.f.batched, 0., 200., DT, ic0,
                                  write_steps=0)
    ic = np.asarray(ic)

    tg = RungeKuttaTglsIntegrator()
    tg.set_func(model.f, model.Df)
    tg.integrate(0., steps * DT, DT, ic=ic[:batch_tgls], tg_ic=np.eye(n),
                 write_steps=0)
    _, _, fmat = tg.get_trajectories()
    ref = host_tgls(model, ic[:n_cmp], steps)
    fscale = float(np.max(np.abs(ref)))
    ph.check("fundamental matrix vs host (max abs / max|M|)",
             _max_abs(fmat[:n_cmp], ref) / fscale, 1e-9,
             "f64 rounding grown by the tangent flow; the trajectory "
             "gate's rtol 1e-9")

    t0, tw, t1 = 0., n_pre * DT, (n_pre + n_rec) * DT
    icl = ic[:batch_lyap]
    _, _, e64, _ = compute_backward_lyapunovs(
        model.f.batched, model.Df.batched, t0, tw, t1, DT, DT, icl)
    _, _, edf, _ = compute_backward_lyapunovs(
        model.f.batched, model.Df.batched, t0, tw, t1, DT, DT, icl,
        precision="twofloat",
        tensors=(model.qgt.tensor, model.qgt.jacobian_tensor))
    eh = host_backward_lyapunov(model, icl[:n_cmp], n_pre, n_rec)
    ph.check("BLV exponents f64 vs host", _max_abs(e64[:n_cmp], eh), 1e-9,
             "per-window log|diag R| from f64 QR on both sides")
    ph.check("BLV exponents twofloat vs f64", _max_abs(edf, e64), df_tol,
             "double-float tangent flow, the platform's window QR")

    # the two window QR methods of the double-float tier, timed on one card
    Q0 = np.linalg.qr(np.random.default_rng(0).random((n, n)))[0]
    y0 = df_from_f64(jnp.asarray(icl))
    M0 = df_from_f64(jnp.asarray(np.broadcast_to(Q0, (batch_lyap, n, n))))
    logs, qr_times = {}, {}
    for method in ("householder", "mixed"):
        window = make_window_step_df(model.qgt.tensor,
                                     model.qgt.jacobian_tensor, DT, DT,
                                     qr_method=method)

        @jax.jit
        def run(y, M, window=window):
            def body(carry, _):
                carry, R = window(carry, 0.0)
                return carry, jnp.log(jnp.abs(jnp.diagonal(
                    R, axis1=-2, axis2=-1))) / DT

            return jax.lax.scan(body, (y, M), None, length=n_rec)[1]

        _timed(run, y0, M0)
        logs[method], qr_times[method] = _timed(run, y0, M0)
    ph.check("window-mean exponents householder vs mixed",
             _max_abs(logs["householder"].mean(0), logs["mixed"].mean(0)),
             2e-8, "tests/test_twofloat.py::test_cholqr_df bound")

    # f32 subspace CLVs: the production intersection against one run with
    # every matmul at HIGHEST precision, and both against f64
    f32, Df32 = create_tendencies(model.pars, dtype=jnp.float32)
    icc = ic[:batch_clv]
    spans = (0., 5 * DT, 10 * DT, 15 * DT)
    out32, t32 = _timed(lambda: compute_clvs_subspace(
        f32.batched, Df32.batched, *spans, DT, DT, icc.astype(np.float32)))
    with jax.default_matmul_precision("highest"):
        outhi, thi = _timed(lambda: compute_clvs_subspace(
            f32.batched, Df32.batched, *spans, DT, DT,
            icc.astype(np.float32)))
    out64 = compute_clvs_subspace(model.f.batched, model.Df.batched, *spans,
                                  DT, DT, icc)
    c32, chi, c64 = (np.asarray(o[3], np.float64) for o in
                     (out32, outhi, out64))
    norms = np.linalg.norm(c32, axis=-3)
    ph.check("f32 CLV column norms |1 - |v||", np.max(np.abs(norms - 1.0)),
             1e-4, "unit vectors to f32 rounding")

    def misalign(a, b):
        cos = np.abs(np.sum(a * b, axis=-3))
        return 1.0 - cos

    ma_hi = misalign(c32, chi)
    ma_64 = misalign(c32, c64)
    ph.check("f32 CLVs vs the same run under default_matmul_precision"
             "('highest'), max 1 - |cos|", ma_hi.max(), 100 * 2.0 ** -23,
             "the intersection's polish tolerance; a DEFAULT-precision "
             "matmul in the f32 path shows here")
    ph.info = dict(
        qr_per_window_max_diff=(
            f"{_max_abs(logs['householder'], logs['mixed']):.3e}"),
        householder_s=f"{qr_times['householder']:.4f}",
        mixed_s=f"{qr_times['mixed']:.4f}",
        clv_f32_s=f"{t32:.3f}", clv_f32_highest_s=f"{thi:.3f}",
        clv_f32_vs_f64_misalign=(
            f"max {ma_64.max():.3e} median {np.median(ma_64):.3e}"),
        blv_twofloat_vs_f64=f"{_max_abs(edf, e64):.3e}")
    return ph


def phase_high_truncation(model, batch=1024, n_cmp=2, steps=200):
    """Phase 5: the ndim-228 truncation through the same bucketed path, in
    float64 and float32, with the step program's memory."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.models.tendencies import create_tendencies

    ph = Phase("phase 5 high truncation")
    ph.sizes = dict(ndim=model.ndim, nnz=model.qgt.tensor.nnz, B=batch,
                    steps=steps)
    ic = make_ics(model.ndim, batch, model.seed)
    rates = {}
    finals = {}
    for name, f, ic_ in (("f64", model.f, ic),
                         ("f32", create_tendencies(model.pars,
                                                   dtype=jnp.float32)[0],
                          ic.astype(np.float32))):
        integ = RungeKuttaIntegrator()
        integ.set_func(f)

        def run():
            integ.integrate(0., steps * DT, DT, ic=ic_, write_steps=0)
            return integ.get_trajectories()[1]

        _, first = _timed(run)
        finals[name], steady = _timed(run)
        rates[name] = (f"first {first:.3f} s, steady {steady:.3f} s "
                       f"({batch * steps / steady:.6e} traj-steps/s)")
    ref = host_rk4(model, ic[:n_cmp], steps, fast=True)
    ph.check("f64 vs numpy_backend (allclose excess over rtol 1e-9)",
             _allclose_excess(finals["f64"][:n_cmp], ref, 1e-9, 0.0), 1e-11,
             "tests/test_trajectory.py rtol=1e-9 atol=1e-11")
    scale = float(np.max(np.abs(finals["f64"])))
    ph.check("f32 vs f64 (max abs / max|x|)",
             _max_abs(finals["f32"], finals["f64"]) / scale, 1e-3,
             "f32 rounding grown by the flow over 200 steps; the CPU "
             "reads 7.1e-5 on 4 members")

    step = make_rk_step(model.f.batched, *rk4_tableau())
    x = jnp.asarray(ic)
    compiled = jax.jit(step).lower(x, jnp.asarray(0.0),
                                   jnp.asarray(DT)).compile()
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    ph.info = dict(rates_f64=rates["f64"], rates_f32=rates["f32"],
                   step_memory_analysis=(
                       None if mem is None else
                       f"args {mem.argument_size_in_bytes} out "
                       f"{mem.output_size_in_bytes} temp "
                       f"{mem.temp_size_in_bytes} code "
                       f"{mem.generated_code_size_in_bytes}"),
                   peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    return ph


class _Outcomes:
    """pytest plugin counting the outcomes of the tests it runs."""

    def __init__(self):
        self.passed, self.not_passed = 0, []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed or report.skipped:
            self.not_passed.append(f"{report.nodeid} {report.outcome}")


def phase_card_tests():
    """Phase 6: the ``gpu``-marked tests, in this process."""
    import pytest

    ph = Phase("phase 6 card tests")
    # tests/conftest.py forces the CPU unless this names another device
    os.environ["QGS_TEST_DEVICE"] = "gpu"
    outcomes = _Outcomes()
    # the gpu-marked tests live in one file: collecting the whole suite
    # would import test modules whose plotting dependencies the card's
    # machine need not have
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[outcomes])
    ph.sizes = dict(marker="gpu", passed=outcomes.passed)
    ph.check("pytest -m gpu exit code", int(rc), 0, "every card test passes")
    if not outcomes.passed or outcomes.not_passed:
        raise SmokeFailure(f"phase 6: {outcomes.passed} passed, not passed: "
                           f"{outcomes.not_passed}")
    return ph


def phase_four(maooam, high, devices, batch=16384, steps=100):
    """Phase 7: the default integrators sharded over four cards against one
    card, and the row-partitioned model-axis kernel on a (2, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from qgs_jax.integrators.integrator import (RungeKuttaIntegrator,
                                                RungeKuttaTglsIntegrator)
    from qgs_jax.ops.contraction import make_tendency_fns
    from qgs_jax.parallel.mesh import ensemble_mesh
    from qgs_jax.parallel.sharded_tendency import make_sharded_tendency

    ph = Phase("phase 7 four cards")
    ph.sizes = dict(devices=len(devices), ndim=maooam.ndim, B=batch,
                    steps=steps, model_axis_ndim=high.ndim)
    four, one = ensemble_mesh(devices), ensemble_mesh(devices[:1])
    ic = make_ics(maooam.ndim, batch, maooam.seed)
    shardings = {}
    results = {}
    for name, mesh in (("four", four), ("one", one)):
        integ = RungeKuttaIntegrator(mesh=mesh)
        integ.set_func(maooam.f)
        integ.integrate(0., steps * DT, DT, ic=ic, write_steps=10)
        shardings[f"traj_{name}"] = integ._recorded_traj.sharding
        tg = RungeKuttaTglsIntegrator(mesh=mesh)
        tg.set_func(maooam.f, maooam.Df)
        tg.integrate(0., 10 * DT, DT, ic=ic, tg_ic=np.eye(maooam.ndim),
                     write_steps=0)
        shardings[f"fmat_{name}"] = tg._recorded_fmatrix.sharding
        results[name] = (integ.get_trajectories()[1],
                         tg.get_trajectories()[2])
    for key in ("traj_four", "fmat_four"):
        if len(shardings[key].device_set) != len(devices):
            raise SmokeFailure(f"phase 7: {key} lives on "
                               f"{len(shardings[key].device_set)} devices")
    ph.check("ensemble trajectory, 4 cards vs 1",
             _max_abs(results["four"][0], results["one"][0]), 1e-12,
             "same per-member arithmetic on every card")
    ph.check("TGLS fundamental matrix, 4 cards vs 1",
             _max_abs(results["four"][1], results["one"][1]), 1e-12,
             "same per-member arithmetic on every card")

    mesh22 = Mesh(np.asarray(devices).reshape(2, 2), ("ensemble", "model"))
    f_sh = make_sharded_tendency(high.qgt.tensor, mesh22)
    f_ref, _ = make_tendency_fns(high.qgt.tensor, high.qgt.jacobian_tensor)
    x = make_ics(high.ndim, 256, high.seed)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh22, P("ensemble", None)))
    got = jax.jit(lambda x: f_sh(0., x))(xs)
    want = jax.jit(lambda x: f_ref(0., x))(jnp.asarray(x))
    shardings["model_axis_out"] = got.sharding
    ph.check("model-axis tendency (2, 2) vs unsharded (max abs / max|f|)",
             _max_abs(got, want) / float(np.max(np.abs(want))), 1e-12,
             "same row reductions; bit-identical on the CPU mesh")
    ph.info = {k: str(v) for k, v in shardings.items()}
    return ph


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def environment(n_cards):
    """Phase 0: describe the machine; refuse anything but GPUs."""
    import jax
    from qgs_jax.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    print(f"phase 0 environment | jax {jax.__version__} | devices {devices}",
          flush=True)
    if devices[0].platform != "gpu":
        print(f"phase 0: JAX found no GPU (platform "
              f"{devices[0].platform!r}); this script runs on the card only",
              file=sys.stderr)
        sys.exit(2)
    if len(devices) < n_cards:
        print(f"phase 0: {n_cards} cards needed, {len(devices)} visible",
              file=sys.stderr)
        sys.exit(2)
    cache = enable_compile_cache()
    card = card_description()
    specs = {m: importlib.util.find_spec(m) is not None
             for m in ("sympy", "matplotlib", "portpicker")}
    print(f"phase 0 environment | card: {card} | device_kind "
          f"{devices[0].device_kind} | count {len(devices)} | installed "
          f"{specs} | compile cache {cache}", flush=True)
    return card, devices


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)

    card, devices = environment(4 if args.four else 1)
    if args.four:
        maooam = Model(maooam_params())
        high = Model(maooam_params((6, 6), (6, 6)))
        print(phase_four(maooam, high, devices[:4]).line(card), flush=True)
    else:
        maooam = Model(maooam_params())
        ph, y64 = phase_flagship(maooam)
        print(ph.line(card), flush=True)
        print(phase_f32(maooam, y64).line(card), flush=True)
        print(phase_twofloat(maooam, y64).line(card), flush=True)
        print(phase_tangent(maooam).line(card), flush=True)
        high = Model(maooam_params((6, 6), (6, 6)))
        print(phase_high_truncation(high).line(card), flush=True)
        print(phase_card_tests().line(card), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
