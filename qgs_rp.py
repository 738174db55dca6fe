#!/usr/bin/env python
"""
Reinhold & Pierrehumbert (1982) model run
=========================================

End-to-end driver for the 2-layer channel QG atmosphere truncated at
wavenumber 2 with simple orography (a mountain and a valley) — the
qgs-jax equivalent of the reference's ``qgs_rp.py`` entry script.

The transient spin-up and the attractor trajectory each run as a single
compiled ``lax.scan`` on the accelerator (no chunked host loop needed).
"""

import sys
import time

import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.models.tendencies import create_tendencies

np.random.seed(21217)

if __name__ == "__main__":
    # Time parameters
    dt = 0.1
    write_steps = 5              # save the model state every n steps
    transient_time = 1.e5        # transient time to the attractor
    integration_time = 1.e4      # integration time on the attractor
    filename = "evol_fields.dat"

    T = time.perf_counter()

    print("Model qgs-jax (atmosphere + orography configuration)")
    print("====================================================\n")
    print("Initialization ...")

    # Model parameters with non-default specs
    model_parameters = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    # Mode truncation at wavenumber 2 in both x and y
    model_parameters.set_atmospheric_channel_fourier_modes(2, 2)
    # Increase the orography depth and the meridional temperature gradient
    model_parameters.ground_params.set_orography(0.2, 1)
    model_parameters.atemperature_params.set_thetas(0.2, 0)
    model_parameters.print_params()

    # Create the tendencies (host precompute + jit-compiled contraction)
    f, Df = create_tendencies(model_parameters)

    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)

    # Random initial condition -> transient to the attractor (single scan)
    ic = np.random.rand(model_parameters.ndim) * 0.1
    print("Starting the transient time integration...")
    integrator.integrate(0., transient_time, dt, ic=ic, write_steps=0)
    _, y = integrator.get_trajectories()

    # Trajectory on the attractor
    print("Starting the time evolution ...")
    integrator.integrate(0., integration_time, dt, ic=y, write_steps=write_steps)
    t, traj = integrator.get_trajectories()

    print(f"Evolution finished, writing to file {filename}")
    np.savetxt(filename, np.concatenate([t[None, :], traj]).T)

    print("Time clock:")
    print(f"{time.perf_counter() - T:.2f} seconds")
