#!/usr/bin/env python
"""Dynamic 0-th order temperature scheme: T_a0 and T_o0 become prognostic
variables and the tendency tensor becomes rank-5 (linear radiation terms)."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.rk import integrate_runge_kutta

# With dynamic_T=True the reference temperatures T_a0 / T_o0 stop being
# fixed parameters and become prognostic 0-th order variables; the
# radiation terms then mix up to four state variables and the tendency
# tensor becomes rank 5 (kept sparse -- only the (i,0,0,0,m) pattern
# exists).  Quartic inner products require the symbolic basis mode.
pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, dynamic_T=True)
pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')

print("variables:", pars.ndim, "->", pars.var_string[:3], "...",
      pars.var_string[-3:])

f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
print("tensor rank:", tensor.tensor.rank, " nnz:", tensor.tensor.nnz)

# Start the 0-th order temperatures near their expected nondimensional
# magnitudes and integrate; variables_range gives each block's index span.
rng = np.random.default_rng(0)
x0 = rng.random(pars.ndim) * 0.01
vr = pars.variables_range
x0[vr[0]] = 0.1      # T_a0 starting value (nondimensional)
x0[vr[2]] = 0.12     # T_o0

t, y = integrate_runge_kutta(f.batched, 0., 100., 0.01, x0, write_steps=100)
print("T_a0 series:", np.array2string(np.asarray(y)[vr[0], :8], precision=5))
print("final state finite:", bool(np.isfinite(np.asarray(y)).all()))

# The prognostic temperatures approach a radiative equilibrium set by the
# insolation/emissivity balance; watch them relax while the baroclinic
# flow equilibrates on the attractor.
t, traj = integrate_runge_kutta(f.batched, 0., 500., 0.01, x0, write_steps=100)
traj = np.asarray(traj)
fig, ax = plt.subplots(figsize=(7, 3.5))
ax.plot(t, traj[vr[0]], label="$T_{a,0}$")
ax.plot(t, traj[vr[2]], label="$T_{o,0}$")
ax.set_xlabel("time (nondim)"); ax.set_ylabel("nondim temperature")
ax.set_title("prognostic 0-th order temperatures")
ax.legend()
fig.tight_layout()
plt.savefig("dynT_temperatures.png", dpi=100)

# The tangent-linear system of the rank-5 model: the Jacobian tensor
# gathers the state at its two trailing coordinates, and the toolbox's
# direct tangent contraction handles it without materializing J — one
# tangent step along the trajectory as a smoke check.
import jax.numpy as jnp
from qgs_jax.ops.contraction import make_direct_tangent

hom = make_direct_tangent(tensor.jacobian_tensor)
x_end = traj[:, -1]
xx = jnp.concatenate([jnp.ones(1), jnp.asarray(x_end)])[None, :]
dm = jnp.eye(pars.ndim)[None, :, :4]             # four tangent directions
J = np.asarray(Df.batched(0., jnp.asarray(x_end)[None, :]))[0]
direct = np.asarray(hom(xx, dm))[0]
print("direct-tangent vs dense-Jacobian product:",
      float(np.abs(direct - J @ np.asarray(dm[0])).max()))
print("wrote dynT_temperatures.png")
