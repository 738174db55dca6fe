#!/usr/bin/env python
"""Multi-process distributed ensembles: the ('ensemble', 'model') device mesh."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


# In a multi-host job every host runs THIS SAME script and
# `qgs_jax.parallel.distributed.initialize()` wires the processes together.
# This walkthrough builds the same SPMD programs on a virtual 8-device CPU
# mesh (the standard single-process stand-in), then spawns a genuine
# 2-process `jax.distributed` run at the end.
import os

os.environ.setdefault("JAX_ENABLE_X64", "true")
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", "cpu")
# the env var above is ineffective when jax was already imported at
# interpreter start — set x64 through the config API too, mirroring the
# platform handling
jax.config.update("jax_enable_x64", True)
print(f"{jax.process_count()} process(es), {jax.device_count()} devices")


# The production mesh layout is `host_chip_mesh(model_axis_size)`: a 2-D
# ('ensemble', 'model') mesh in which each model group lives inside one
# host — its per-stage model-axis collective (one all_gather for the
# default bucketed row-partitioned kernel; psum for the dense
# comparison kernel) stays on the host's NVLink — while the ensemble axis
# spans hosts, so the only cross-host traffic is the
# embarrassingly-parallel ensemble sharding.  The reference's parallel
# layer is a single-node pool of OS processes fed by queues (ref
# ``qgs/integrators/integrator.py:77-142``); this is its multi-host
# replacement: one SPMD program, no queues, no pickling.
import numpy as np

from qgs_jax.parallel.distributed import (host_chip_mesh, make_global_array,
                                          gather_to_host)

mesh = host_chip_mesh(model_axis_size=2)
print("mesh axes:", dict(mesh.shape))


# Build the flagship coupled ocean-atmosphere (MAOOAM) model as usual --
# nothing about the model construction knows about the mesh.
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


# Hand the mesh to the ensemble integrator: the member axis is sharded over
# the 'ensemble' mesh axis and every device integrates its members in the
# same jitted scan.  In a multi-process run each process feeds the same
# host array and owns its local shards (`make_global_array`).
from qgs_jax.integrators.integrator import RungeKuttaIntegrator

B = 8
ic = np.random.default_rng(7).random((B, pars.ndim)) * 0.01
integ = RungeKuttaIntegrator(mesh=mesh)
integ.set_func(f)
integ.integrate(0., 100., 0.1, ic=ic, write_steps=100)
t, traj = integ.get_trajectories()
print("trajectories:", traj.shape, "finite:", bool(np.isfinite(traj).all()))


# The model axis shards the tendency contraction itself over the
# spectral modes: each device holds a slice of the tensor's rows and the
# RK stage results are re-assembled across the model group (disjoint
# output rows -> one all_gather, no psum).  This is the layout
# that pays off at high resolution, where one card cannot hold the dense
# work of a single trajectory.
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from qgs_jax.parallel.sharded_tendency import make_sharded_tendency
from qgs_jax.integrators.rk import make_rk_step, rk4_tableau

f_sh = make_sharded_tendency(tensor.tensor, mesh)
a, b, c = rk4_tableau()
step = jax.jit(make_rk_step(f_sh, a, b, c))
x = make_global_array(ic, mesh, P('ensemble', None))
y = step(x, jnp.asarray(0.0), jnp.asarray(0.1))
y_ref = make_rk_step(f.batched, a, b, c)(jnp.asarray(ic),
                                         jnp.asarray(0.0), jnp.asarray(0.1))
err = float(np.abs(gather_to_host(y) - np.asarray(y_ref)).max())
print(f"mode-sharded RK4 step vs replicated: max |diff| = {err:.2e}")


# Finally, the real thing: spawn TWO OS processes, each a separate JAX
# process with its own virtual devices, wired through
# `jax.distributed.initialize` + Gloo collectives — exactly the program
# shape of a 2-host job.  With model_axis_size=2 each process's two
# devices form a model group (the mode-space collective stays intra-process,
# i.e. intra-host) while the ensemble axis spans the processes —
# the full 2-D production mesh layout, now exercised cross-process too.
from qgs_jax.parallel.distributed import run_multiprocess_selftest

for line in run_multiprocess_selftest(num_processes=2, local_devices=2,
                                      model_axis_size=2):
    print(line)
