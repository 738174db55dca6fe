#!/usr/bin/env python
"""
MAOOAM coupled ocean-atmosphere model run
=========================================

End-to-end driver for the 36-variable coupled ocean-atmosphere model
(De Cruz, Demaeyer & Vannitsem 2016) — the qgs-jax equivalent of the
reference's ``qgs_maooam.py`` entry script.

The multi-million-step transient runs as one compiled scan on the
accelerator; set ``QGS_ENSEMBLE`` to integrate an ensemble of perturbed
initial conditions sharded across the available devices.
"""

import os
import time

import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.models.tendencies import create_tendencies

np.random.seed(210217)

if __name__ == "__main__":
    # Time parameters
    dt = 0.1
    write_steps = 100
    transient_time = 3.e6
    integration_time = 5.e5
    filename = "evol_fields.dat"
    ensemble = int(os.environ.get("QGS_ENSEMBLE", "1"))

    T = time.perf_counter()

    print("Model qgs-jax (atmosphere + ocean (MAOOAM) configuration)")
    print("=========================================================\n")
    print("Initialization ...")

    model_parameters = QgParams()
    model_parameters.set_atmospheric_channel_fourier_modes(2, 2)
    model_parameters.set_oceanic_basin_fourier_modes(2, 4)
    model_parameters.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5,
                                 'r': 1.e-7, 'h': 136.5, 'd': 1.1e-7})
    model_parameters.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                                     'hlambda': 15.06})
    model_parameters.gotemperature_params.set_params({'gamma': 5.6e8,
                                                      'T0': 301.46})
    model_parameters.atemperature_params.set_insolation(103.3333, 0)
    model_parameters.gotemperature_params.set_insolation(310., 0)
    model_parameters.print_params()

    f, Df = create_tendencies(model_parameters)

    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)

    ic = np.random.rand(model_parameters.ndim) * 0.01
    if ensemble > 1:
        ic = ic[None, :] + 1e-4 * np.random.randn(ensemble, model_parameters.ndim)

    print("Starting the transient time integration...")
    integrator.integrate(0., transient_time, dt, ic=ic, write_steps=0)
    _, y = integrator.get_trajectories()

    print("Starting the time evolution ...")
    integrator.integrate(0., integration_time, dt, ic=y, write_steps=write_steps)
    t, traj = integrator.get_trajectories()

    print(f"Evolution finished, writing to file {filename}")
    if traj.ndim == 2:
        np.savetxt(filename, np.concatenate([t[None, :], traj]).T)
    else:
        np.save(filename.replace(".dat", ".npy"), traj)

    print("Time clock:")
    print(f"{time.perf_counter() - T:.2f} seconds")
