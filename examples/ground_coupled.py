#!/usr/bin/env python
"""Atmosphere coupled to a land/ground component with heat exchange and
orography (the MAOSOAM-like configuration)."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.diagnostics.temperatures import GroundTemperatureAnomalyDiagnostic

# Atmosphere over land (the MAOSOAM-like configuration of Li et al. 2018,
# ref qgs/model/li_model.rst): the ground adds orography and a motionless
# temperature anomaly field exchanging heat with the atmosphere -- no
# dynamic equation for a ground "flow".  gtemperature_params=True selects
# the ground-temperature container at construction.
pars = QgParams(gtemperature_params=True)
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.set_ground_channel_fourier_modes()       # ground shares the atm basis
pars.ground_params.set_orography(0.2, 1)
pars.gotemperature_params.set_params({'gamma': 1.6e7})

print(f"ndim = {pars.ndim}  (psi_a x{pars.nmod[0]}, theta_a x{pars.nmod[0]}, "
      f"deltaT_g x{pars.nmod[1]})")

# The ground shares the atmospheric channel basis, so the only new block
# in the tendency tensor is the heat-exchange coupling.
f, Df = create_tendencies(pars)
integrator = RungeKuttaIntegrator()
integrator.set_func(f)
rng = np.random.default_rng(0)
integrator.integrate(0., 1.e4, 0.1, ic=rng.random(pars.ndim) * 0.05, write_steps=0)
_, y0 = integrator.get_trajectories()
integrator.integrate(0., 500., 0.1, ic=y0, write_steps=10)
t, traj = integrator.get_trajectories()

# Ground temperature anomaly reconstructed on the grid, in Kelvin.
dT = GroundTemperatureAnomalyDiagnostic(pars)
field = dT(t, traj)
print("ground temperature anomaly range (K):",
      float(field.min()), "to", float(field.max()))
