#!/usr/bin/env python
"""Lyapunov spectrum and covariant vectors of the RP atmosphere."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.toolbox.lyapunov import LyapunovsEstimator, CovariantLyapunovsEstimator

# The RP atmosphere again -- small enough (20 variables) that the full
# Lyapunov spectrum and all covariant vectors are cheap.
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)
f, Df = create_tendencies(pars)

integrator = RungeKuttaIntegrator()
integrator.set_func(f)
rng = np.random.default_rng(1)
integrator.integrate(0., 2.e4, 0.1, ic=rng.random(pars.ndim) * 0.1, write_steps=0)
_, ic = integrator.get_trajectories()

# Backward Lyapunov vectors/exponents by the Benettin QR algorithm: the
# fundamental matrix is propagated over sub-intervals of fine step mdt and
# re-orthonormalized with a (natively batched) QR; exponents are the time
# averages of log|diag R|.  The positive part of the spectrum plus the
# Kaplan-Yorke count characterize the attractor's chaos.
est = LyapunovsEstimator()
est.set_func(f, Df)
est.compute_lyapunovs(0., 1000., 5000., 0.1, 0.1, ic, write_steps=10)
t, traj, exps, vecs = est.get_lyapunovs()
spectrum = exps.mean(axis=-1)
print("Backward Lyapunov spectrum (per time unit):")
print(np.array2string(np.sort(spectrum)[::-1], precision=4))
print("Kaplan-Yorke dimension estimate:",
      (np.cumsum(np.sort(spectrum)[::-1]) > 0).sum())

# Covariant Lyapunov vectors by the Ginelli et al. (2007) method
# (method=0; backward R storage + backward substitution, optional
# noise_pert regularization for degenerate spectra).  method=1 computes
# the same vectors by intersecting BLV/FLV subspaces -- the two are
# cross-validated in tests/test_lyapunov.py.
cest = CovariantLyapunovsEstimator()
cest.set_func(f, Df)
cest.compute_clvs(0., 500., 1500., 2000., 0.1, 0.1, ic, write_steps=10)
_, _, cexps, cvecs = cest.get_clvs()
print("CLV mean exponents:", np.array2string(cexps.mean(axis=-1), precision=4))
