#!/usr/bin/env python
"""Long-horizon trajectory-fidelity report (the BASELINE.json fidelity gate
beyond short-horizon allclose).

Chaos precludes pointwise comparison over >= 1e5 RK4 steps, so fidelity is
gated on *climate statistics*: an ensemble is integrated over the same
window with (a) the device twofloat path and (b) the native f64 oracle
(bit-exact reference semantics, ``qgs_jax/native``), and the per-variable
climate means/stds and the dominant spectral peak must agree to within the
window's own sampling error.

Two phases:

1. MAOOAM (36-var coupled) climate statistics over ``--steps`` (default
   1.2e5) RK4 steps x ``--ensemble`` members.  Tolerances (recorded here,
   asserted by ``tests/test_fidelity_longrun.py``):
     |mean_dev - mean_oracle|  <=  0.1 * pooled std (per variable)
     std ratio in [0.8, 1.25]  (variables with std > 1e-3 * max std)
     PSD peak of the dominant atmospheric mode within one Welch bin.
2. qgs_rp smoke configuration end-to-end on device: the reference README's
   "less than a minute" run (~1.1M steps at dt=0.1 incl. transient, ref
   ``README.md:68-91``), checked finite + statistically stationary.
"""

import argparse
import os
import sys
import pathlib
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def build_maooam():
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

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
    return pars, tensor


def attractor_ensemble(tensor, ndim, n_members, transient_steps=200_000,
                       spacing_steps=20_000, dt=0.1):
    """Decorrelated on-attractor ICs from one long native f64 trajectory."""
    from qgs_jax import native

    rng = np.random.default_rng(42)
    y = rng.random(ndim) * 0.01
    y, _ = native.rk4_integrate(tensor.tensor, y, dt, transient_steps)
    ics = []
    for _ in range(n_members):
        y, _ = native.rk4_integrate(tensor.tensor, y, dt, spacing_steps)
        ics.append(y.copy())
    return np.asarray(ics)


def run_oracle(tensor, ics, n_steps, write_steps, dt=0.1):
    """Native f64 reference-semantics trajectories, (B, n_rec, ndim)."""
    from qgs_jax import native

    recs = []
    for ic in ics:
        _, rec = native.rk4_integrate(tensor.tensor, ic, dt, n_steps,
                                      write_steps=write_steps)
        recs.append(rec)
    return np.asarray(recs)


def run_device_twofloat(tensor, ics, n_steps, write_steps, dt=0.1):
    """Device twofloat trajectories, (B, n_rec, ndim)."""
    from qgs_jax.integrators.rk import integrate_runge_kutta_df

    t, traj = integrate_runge_kutta_df(tensor.tensor, 0., n_steps * dt, dt,
                                       ics, write_steps=write_steps,
                                       squeeze=False)
    return np.moveaxis(np.asarray(traj), -1, 1)      # (B, n_rec, ndim)


def climate_stats(recs, burn_frac=0.1):
    """Pooled per-variable mean/std over (ensemble x time), after burn-in."""
    burn = int(recs.shape[1] * burn_frac)
    flat = recs[:, burn:, :].reshape(-1, recs.shape[-1])
    return flat.mean(axis=0), flat.std(axis=0)


def psd_peak(recs, var=0, dt_rec=1.0):
    """Dominant nonzero-frequency Welch-bin of one variable (pooled)."""
    x = recs[:, :, var]
    x = x - x.mean(axis=1, keepdims=True)
    n = x.shape[1]
    psd = np.abs(np.fft.rfft(x, axis=1)) ** 2
    psd = psd.mean(axis=0)
    freqs = np.fft.rfftfreq(n, d=dt_rec)
    k = 1 + int(np.argmax(psd[1:]))
    return freqs[k], k


def compare_climate(oracle, device, verbose=True):
    """Return a dict of fidelity metrics between the two stat sets."""
    mo, so = climate_stats(oracle)
    md, sd = climate_stats(device)
    pooled = np.maximum(so, 1e-12)
    mean_dev = np.abs(md - mo) / pooled
    active = so > 1e-3 * so.max()
    std_ratio = sd[active] / so[active]
    fo, ko = psd_peak(oracle)
    fd, kd = psd_peak(device)
    metrics = {
        "max_mean_dev_in_std": float(mean_dev.max()),
        "max_std_ratio": float(std_ratio.max()),
        "min_std_ratio": float(std_ratio.min()),
        "psd_peak_oracle_bin": int(ko),
        "psd_peak_device_bin": int(kd),
    }
    if verbose:
        print(f"  mean deviation (units of pooled std): max "
              f"{metrics['max_mean_dev_in_std']:.4f}")
        print(f"  std ratio (active vars): [{metrics['min_std_ratio']:.4f}, "
              f"{metrics['max_std_ratio']:.4f}]")
        print(f"  PSD dominant bin: oracle {ko} vs device {kd}")
    return metrics


def check_metrics(metrics, mean_tol=0.1, std_lo=0.8, std_hi=1.25, psd_bins=1):
    """The recorded tolerances of the fidelity gate."""
    assert metrics["max_mean_dev_in_std"] <= mean_tol, metrics
    assert std_lo <= metrics["min_std_ratio"], metrics
    assert metrics["max_std_ratio"] <= std_hi, metrics
    assert abs(metrics["psd_peak_device_bin"]
               - metrics["psd_peak_oracle_bin"]) <= psd_bins, metrics


def maooam_climate_phase(n_steps, ensemble, write_steps=10):
    print(f"MAOOAM climate fidelity: {ensemble} members x {n_steps:,} steps")
    pars, tensor = build_maooam()
    ics = attractor_ensemble(tensor, pars.ndim, ensemble)
    t0 = time.perf_counter()
    oracle = run_oracle(tensor, ics, n_steps, write_steps)
    print(f"  native f64 oracle: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    device = run_device_twofloat(tensor, ics, n_steps, write_steps)
    print(f"  device twofloat:   {time.perf_counter() - t0:.1f}s")
    metrics = compare_climate(oracle, device)
    check_metrics(metrics)
    print("  PASS (tolerances: mean dev <= 0.1 std, std ratio in "
          "[0.8, 1.25], PSD peak within 1 bin)")
    return metrics


def qgs_rp_smoke_phase():
    """The reference's 1.1M-step qgs_rp configuration, end-to-end on device
    (ref ``qgs_rp.py:77-134``: 20-var RP atmosphere, transient 1e5 time
    units + 1e4 run at dt=0.1 written every 5 steps)."""
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator

    print("qgs_rp smoke run (~1.1M RK4 steps on device)")
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    # twofloat tier (the production device path); the transient is chunked
    # into 1e5-step segments so no single device kernel runs long enough to
    # trip the worker's execution watchdog
    integ = RungeKuttaIntegrator(precision="twofloat")
    integ.set_func(f)
    rng = np.random.default_rng(21217)
    y0 = rng.random(pars.ndim) * 0.01
    t0 = time.perf_counter()
    for _ in range(10):
        integ.integrate(0., 10_000., 0.1, ic=y0, write_steps=0)
        _, y0 = integ.get_trajectories()
    integ.integrate(0., 10_000., 0.1, ic=y0, write_steps=5)
    t, traj = integ.get_trajectories()
    elapsed = time.perf_counter() - t0
    steps = 1_000_000 + 100_000
    assert np.all(np.isfinite(traj)), "non-finite state in qgs_rp smoke run"
    # stationarity: first/second-half climate of psi_a_1 agree
    half = traj.shape[-1] // 2
    m1, m2 = traj[0, :half].mean(), traj[0, half:].mean()
    s = traj[0].std()
    assert abs(m1 - m2) <= 0.5 * s, (m1, m2, s)
    print(f"  {steps:,} steps in {elapsed:.1f}s "
          f"({steps / elapsed:,.0f} steps/s), psi_a_1 range "
          f"[{traj[0].min():.4f}, {traj[0].max():.4f}] — PASS")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120_000)
    p.add_argument("--ensemble", type=int, default=8)
    p.add_argument("--skip-rp", action="store_true")
    args = p.parse_args()
    maooam_climate_phase(args.steps, args.ensemble)
    if not args.skip_rp:
        qgs_rp_smoke_phase()
