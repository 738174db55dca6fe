#!/usr/bin/env python
"""Sharded ensemble integration + ensemble-mean observables."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.integrators.statistics import TrajectoriesStatistics

pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)
f, Df = create_tendencies(pars)

# Ensembles are batched arrays sharded across the device mesh -- the
# replacement of the reference's one-OS-process-per-trajectory pools.
# Nothing here changes between one card and several.
integrator = RungeKuttaIntegrator(number_of_dimensions=pars.ndim)
integrator.set_func(f)

# initialize() spins ONE long transient, perturbs the converged state into
# 32 members, and reconverges them briefly -- much cheaper than 32 long
# transients.  compute_stats averages arbitrary observables over the
# ensemble in chunked batches (num=2 splits the members into 2 batches).
stats = TrajectoriesStatistics()
stats.set_integrator(integrator)
# one long transient + perturbed reconvergence for the rest of the ensemble
stats.initialize(2000., 0.1, number_of_trajectories=32, reconvergence_time=100.)

stats.set_func_list([
    lambda traj: traj,                       # ensemble-mean trajectory
    lambda traj: traj ** 2,                  # second moment
])
stats.compute_stats(0., 200., 0.1, write_steps=10, num=2)
mean_traj, second_moment = stats.get_stats()
variance = second_moment - mean_traj ** 2
print("ensemble variance of psi_a_1 over time:")
print(np.array2string(variance[0], precision=5))

# How the ensemble is laid out on hardware: the IC batch is sharded over
# the mesh's 'ensemble' axis (here the virtual/actual device count), and
# the whole time loop is ONE compiled lax.scan per device — no queues, no
# worker processes, no pickling.
import jax

from qgs_jax.parallel.mesh import ensemble_mesh

mesh = ensemble_mesh()
print("devices:", jax.device_count(), " mesh:", dict(mesh.shape))
print("members per device:", 32 // max(jax.device_count(), 1))

# Ensemble-spread growth is the practical measure of predictability: plot
# the variance of the leading streamfunction mode against time (the
# members were identical up to the reconvergence perturbation, so the
# spread reflects attractor-scale decorrelation).
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

tt = np.arange(variance.shape[-1]) * 1.0      # write stride units
fig, ax = plt.subplots(figsize=(7, 3.2))
ax.semilogy(tt, np.maximum(variance[0], 1e-12))
ax.set_xlabel("record index (every 1 time unit)")
ax.set_ylabel(r"ensemble var($\psi_{a,1}$)")
ax.set_title("ensemble spread growth on the attractor")
fig.tight_layout()
plt.savefig("ensemble_spread.png", dpi=100)
print("wrote ensemble_spread.png")
