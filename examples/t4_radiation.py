#!/usr/bin/env python
"""Full quartic T^4 longwave radiation scheme (implies dynamic 0-th order
temperatures): the quartic inner products are computed on the sorted-index
simplex and the tendency tensor is rank 5."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.rk import (integrate_runge_kutta,
                                    integrate_runge_kutta_df)

# T4=True activates the full quartic Stefan-Boltzmann T^4 law without
# linearization (implies dynamic 0-th order temperatures).  The quartic
# coefficient families are computed once on the sorted-index simplex and
# scattered to all index permutations; on device the rank-5 tensor stays
# in COO form (a dense (ndim+1)^5 array would not fit at scale).
pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, T4=True)
pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')

f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
print("T4 tensor rank:", tensor.tensor.rank, " nnz:", tensor.tensor.nnz)

# On device the quartic contraction runs through the PAIR-FACTORED gather
# kernel: the four per-entry state gathers x_j x_k x_l x_m are rewritten
# as two gathers of precomputed pair products p = x_a * x_b drawn from a
# shared pair alphabet — for this tensor a few hundred pairs serve
# thousands of rank-5 entries, halving the dominant gather traffic.
from qgs_jax.ops.contraction import make_pairsum_contraction

pair_kernel = make_pairsum_contraction(tensor.tensor)
print("rank-5 entries:", tensor.tensor.nnz,
      "-> shared pair alphabet:", pair_kernel.operands["pair_a"].shape[0])

# Integrate from a small perturbation with the 0-th order temperatures
# started near their expected nondimensional magnitudes (variables_range
# gives each block's index span).
rng = np.random.default_rng(0)
x0 = rng.random(pars.ndim) * 0.01
vr = pars.variables_range
x0[vr[0]] = 0.1     # T_a0
x0[vr[2]] = 0.12    # T_o0

t, y = integrate_runge_kutta(f.batched, 0., 50., 0.01, x0, write_steps=0)
print("state after 5000 steps finite:", bool(np.isfinite(np.asarray(y)).all()))

# The 0-th order temperatures relax toward radiative-convective
# equilibrium while the flow variables stay chaotic — plot both.
t, traj = integrate_runge_kutta(f.batched, 0., 200., 0.01, x0, write_steps=50)
traj = np.asarray(traj)
fig, axs = plt.subplots(1, 2, figsize=(11, 3.5))
axs[0].plot(t, traj[vr[0]], label="$T_{a,0}$")
axs[0].plot(t, traj[vr[2]], label="$T_{o,0}$")
axs[0].set_xlabel("time (nondim)"); axs[0].set_title("0-th order temperatures")
axs[0].legend()
axs[1].plot(t, traj[0], label=r"$\psi_{a,1}$")
axs[1].plot(t, traj[vr[0] + 1], label=r"$\theta_{a,1}$")
axs[1].set_xlabel("time (nondim)"); axs[1].set_title("flow variables")
axs[1].legend()
fig.tight_layout()
plt.savefig("t4_series.png", dpi=100)

# Precision: the double-float (2x float32) tier runs the SAME rank-5
# tendencies through its rank-general pair-factored kernel — matching
# the float64 trajectory to ~1e-12 over thousands of steps at near-f32
# device throughput (the reference runs these kernels at full f64,
# qgs/functions/sparse_mul.py:85-158).
_, y64 = integrate_runge_kutta(f.batched, 0., 10., 0.01,
                               x0[None, :], write_steps=0)
_, ydf = integrate_runge_kutta_df(tensor.tensor, 0., 10., 0.01,
                                  x0[None, :], write_steps=0, squeeze=False)
err = float(np.abs(np.asarray(ydf) - np.asarray(y64)).max())
print(f"twofloat vs f64 after 1000 quartic RK4 steps: {err:.2e}")
print("wrote t4_series.png")
