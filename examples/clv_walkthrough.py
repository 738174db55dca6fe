#!/usr/bin/env python
"""Covariant Lyapunov vectors, in depth: spectrum, local exponents,
physical structure and near-tangencies on the RP atmosphere (counterpart
of the reference's ``notebooks/lyapunov`` deep dives)."""

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
from qgs_jax.toolbox.lyapunov import (LyapunovsEstimator,
                                      CovariantLyapunovsEstimator)

# The RP atmosphere (20 variables): small enough that every Lyapunov
# object -- the full spectrum, all covariant vectors, their angles -- is
# cheap to compute and visualize.
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.4, 1)
pars.atemperature_params.set_thetas(0.2, 0)
f, Df = create_tendencies(pars)

integrator = RungeKuttaIntegrator()
integrator.set_func(f)
rng = np.random.default_rng(3)
integrator.integrate(0., 5000., 0.1, ic=rng.random(pars.ndim) * 0.01,
                     write_steps=0)
_, ic = integrator.get_trajectories()
ic = np.atleast_2d(np.asarray(ic))


# First the asymptotic picture: the backward Lyapunov spectrum by the
# Benettin QR algorithm.  The spectrum of this configuration has a
# positive pair (chaos), a near-zero exponent (the flow direction), and a
# dissipative tail whose sum equals the mean phase-space contraction.
est = LyapunovsEstimator()
est.set_func(f, Df)
est.compute_lyapunovs(0., 200., 1200., 0.1, 0.1, ic, write_steps=1)
_, _, bexps, _ = est.get_lyapunovs()
spectrum = np.sort(np.asarray(bexps).mean(axis=-1))[::-1]
print("Backward Lyapunov spectrum:", np.array2string(spectrum, precision=4))


# Covariant Lyapunov vectors by the Ginelli method: a forward Benettin
# pass stores (Q, R) over the window [ta, tb], a backward triangular-solve
# pass from tc converges the covariant coefficients.  Unlike the
# orthonormal BLVs, CLVs are norm-1 but mutually *oblique* -- they are the
# intrinsic stable/unstable directions of the tangent dynamics, invariant
# under time reversal and covariant with the flow.
cest = CovariantLyapunovsEstimator()
cest.set_func(f, Df)
cest.compute_clvs(0., 300., 400., 700., 0.1, 0.1, ic, write_steps=1)
t, traj, cexps, clvs = cest.get_clvs()
traj = np.asarray(traj)
cexps = np.asarray(cexps)
clvs = np.asarray(clvs)
print("CLV mean exponents:   ",
      np.array2string(np.sort(cexps.mean(-1))[::-1][:6], precision=4),
      "(leading 6)")


# Figure 1: asymptotic spectrum (BLV) vs the time-mean of the CLV local
# exponents -- the two estimates must agree, and do.
fig, ax = plt.subplots(figsize=(7, 3.5))
ax.bar(np.arange(1, pars.ndim + 1) - 0.2, spectrum, 0.4, label="BLV (Benettin)")
ax.bar(np.arange(1, pars.ndim + 1) + 0.2, np.sort(cexps.mean(-1))[::-1], 0.4,
       label="CLV (Ginelli, time-mean local)")
ax.axhline(0, color='k', lw=0.5)
ax.set_xlabel("index")
ax.set_ylabel("Lyapunov exponent (1/timeunit)")
ax.legend()
fig.tight_layout()
plt.savefig("clv_spectrum.png", dpi=90)


# Figure 2: the LOCAL exponents fluctuate wildly along the attractor --
# predictability is state-dependent.  The leading CLV's local exponent
# swings far beyond its mean.
lead = np.argmax(cexps.mean(-1))
fig, ax = plt.subplots(figsize=(8, 3))
ax.plot(t, cexps[lead], lw=0.7)
ax.axhline(cexps[lead].mean(), color='r', ls='--',
           label=f"mean = {cexps[lead].mean():.3f}")
ax.set_xlabel("time")
ax.set_ylabel(r"local $\lambda_1(t)$")
ax.legend()
fig.tight_layout()
plt.savefig("clv_local_exponent.png", dpi=90)


# Figure 3: a CLV is a physical perturbation pattern.  Its psi-components
# are spectral coefficients of a perturbation streamfunction: evaluate
# them on the grid next to the background flow.  The leading CLV localizes
# on the active regions of the background jet -- the optimal error
# pattern of the day.
from qgs_jax.diagnostics.util import create_grid_basis

nx, ny = 120, 60
X, Y = np.meshgrid(np.linspace(0, 2 * np.pi / pars.scale_params.n, nx),
                   np.linspace(0, np.pi, ny))
Fgrid = create_grid_basis(pars.atmospheric_basis, X, Y)
natm = pars.nmod[0]

k = clvs.shape[-1] // 2                               # mid-window snapshot
psi_bg = np.tensordot(traj[:natm, k], Fgrid, axes=(0, 0))
psi_v1 = np.tensordot(clvs[:natm, lead, k], Fgrid, axes=(0, 0))

fig, axs = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
cs = axs[0].contourf(X, Y, psi_bg, 15, cmap="RdBu_r")
fig.colorbar(cs, ax=axs[0], label=r"$\psi_a$ (background)")
cs = axs[1].contourf(X, Y, psi_v1, 15, cmap="PuOr")
axs[1].contour(X, Y, psi_bg, 8, colors='k', linewidths=0.4)
fig.colorbar(cs, ax=axs[1], label=r"CLV$_1$ $\psi$-pattern")
axs[1].set_xlabel("x")
for ax in axs:
    ax.set_ylabel("y")
fig.tight_layout()
plt.savefig("clv_pattern.png", dpi=90)


# Figure 4: CLVs are oblique, and near-tangencies (angles collapsing to
# zero) mark violations of hyperbolicity -- the events the Ginelli
# noise_pert regularization is built for.  Histogram of the angle between
# the two leading CLVs along the window:
ang = np.degrees(np.arccos(np.clip(np.abs(
    np.einsum('nt,nt->t', clvs[:, lead], clvs[:, lead + 1])), 0, 1)))
fig, ax = plt.subplots(figsize=(6, 3))
ax.hist(ang, bins=40, color="#46658c")
ax.set_xlabel(r"angle between CLV$_1$ and CLV$_2$ (deg)")
ax.set_ylabel("count")
fig.tight_layout()
plt.savefig("clv_angles.png", dpi=90)
print(f"min CLV1-CLV2 angle along the window: {ang.min():.2f} deg "
      f"(near-tangency events below ~10 deg: {(ang < 10).sum()})")


# The defining COVARIANCE property, checked numerically: pushing CLV_j(t)
# through one step of the tangent flow lands it on span(CLV_j(t + dt)).
from qgs_jax.integrators.rk import make_tgls_step, rk4_tableau
import jax.numpy as jnp

a, b, c = rk4_tableau()
step = make_tgls_step(f.batched, Df.batched, a, b, c)
y = jnp.asarray(traj[:, k][None])
V = jnp.asarray(clvs[:, :, k][None])
_, V2 = step((y, V), jnp.asarray(0.0), jnp.asarray(0.1))
V2 = np.array(V2)[0]
V2 /= np.linalg.norm(V2, axis=0)
align = [abs(np.dot(V2[:, j], clvs[:, j, k + 1])) for j in range(4)]
print("covariance check |<M CLV_j(t), CLV_j(t+dt)>| (leading 4):",
      np.array2string(np.array(align), precision=6))
