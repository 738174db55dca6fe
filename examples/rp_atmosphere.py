#!/usr/bin/env python
"""Reinhold-Pierrehumbert atmosphere: attractor run + scalar variable
series + streamfunction snapshot."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.diagnostics.variables import VariablesDiagnostic
from qgs_jax.diagnostics.streamfunctions import MiddleAtmosphericStreamfunctionDiagnostic

# Configure the Reinhold & Pierrehumbert (1982) setup: a two-layer
# quasi-geostrophic channel atmosphere at 50N, truncated at wavenumber 2 in
# both directions (10 spatial modes -> 20 variables), with a mountain/valley
# orography of height 0.2 (in units of the scale height) and Newtonian
# cooling toward an equator-to-pole radiative-equilibrium gradient of 0.2.
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)

# Compile the model: the Galerkin tendency tensor is assembled once on the
# host and closed over jit-compiled contraction kernels; f and Df are the
# tendency and Jacobian callables (the framework's central API contract).
f, Df = create_tendencies(pars)
integrator = RungeKuttaIntegrator()
integrator.set_func(f)

# Spin up from a random state for 2e4 time units so transients decay onto
# the chaotic attractor, then record 1000 time units every 5 steps.  Both
# runs execute as single compiled scans on the accelerator.
rng = np.random.default_rng(21217)
integrator.integrate(0., 2.e4, 0.1, ic=rng.random(pars.ndim) * 0.1, write_steps=0)
_, y0 = integrator.get_trajectories()
integrator.integrate(0., 1000., 0.1, ic=y0, write_steps=5)
t, traj = integrator.get_trajectories()

# The scalar-variable diagnostic plots raw spectral coefficients; psi_a_1
# (the zonal-flow mode) visibly switches between the model's flow regimes.
vd = VariablesDiagnostic([0, 1, 2], pars, dimensional=False)
vd(t, traj)
vd.plot()
plt.savefig("rp_variables.png", dpi=100)

# Reconstruct the 500 hPa geopotential height field on a lat-lon grid from
# the spectral coefficients (one matmul against the gridded basis) with the
# orography underlaid.
psi = MiddleAtmosphericStreamfunctionDiagnostic(pars, geopotential=True)
psi(t, traj)
psi.plot(time_index=-1)
plt.savefig("rp_psi.png", dpi=100)
print("wrote rp_variables.png, rp_psi.png")
