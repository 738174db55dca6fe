#!/usr/bin/env python
"""The three accelerator precision tiers side by side: float32, double-float
(two-float32 with error-free transformations), and float64."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import time

import jax
import jax.numpy as jnp
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.ops.contraction import make_tendency_fns
from qgs_jax.ops.twofloat import make_df_rk4_step, df_from_f64, df_to_f64
from qgs_jax.integrators.rk import make_rk_step, rk4_tableau

# This example measures the three tiers qgs-jax offers on the MAOOAM
# model and their error against the f64 oracle after 200 steps.  The
# rates it prints are those of the device it runs on; on a CPU they say
# nothing about a GPU.
pars = QgParams()
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.set_oceanic_basin_fourier_modes(2, 4)
f, Df, tensor = create_tendencies(pars, return_qgtensor=True)

B, N = 1024, 200
rng = np.random.default_rng(0)
x = rng.random((B, pars.ndim)) * 0.05
a, b, c = rk4_tableau()

results = {}

# float64 (the reference precision)
step64 = make_rk_step(f.batched, a, b, c)
run64 = jax.jit(lambda y: jax.lax.fori_loop(
    0, N, lambda i, y: step64(y, jnp.asarray(0.0, y.dtype), jnp.asarray(0.1, y.dtype)), y))
y = run64(jnp.asarray(x)); y.block_until_ready()
t0 = time.perf_counter(); y64 = run64(jnp.asarray(x)); y64.block_until_ready()
results['float64'] = (N * B / (time.perf_counter() - t0), 0.0)

# float32
f32, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor, dtype=jnp.float32)
step32 = make_rk_step(f32, a, b, c)
run32 = jax.jit(lambda y: jax.lax.fori_loop(
    0, N, lambda i, y: step32(y, jnp.asarray(0.0, y.dtype), jnp.asarray(0.1, y.dtype)), y))
y = run32(jnp.asarray(x, jnp.float32)); y.block_until_ready()
t0 = time.perf_counter(); y32 = run32(jnp.asarray(x, jnp.float32)); y32.block_until_ready()
err32 = np.abs(np.asarray(y32, np.float64) - np.asarray(y64)).max()
results['float32'] = (N * B / (time.perf_counter() - t0), err32)

# Double-float ("twofloat"): each value is an (hi, lo) pair of float32
# whose sum represents a ~48-bit-mantissa number; sums/products use
# error-free transformations (Knuth two-sum, Dekker product): f64-quality
# trajectories from float32 arithmetic.
stepdf = make_df_rk4_step(tensor.tensor, 0.1)
rundf = jax.jit(lambda y: jax.lax.fori_loop(0, N, lambda i, y: stepdf(y), y))
ydf = rundf(df_from_f64(jnp.asarray(x))); ydf[0].block_until_ready()
t0 = time.perf_counter(); ydf = rundf(df_from_f64(jnp.asarray(x))); ydf[0].block_until_ready()
errdf = np.abs(np.asarray(df_to_f64(ydf)) - np.asarray(y64)).max()
results['twofloat'] = (N * B / (time.perf_counter() - t0), errdf)

print(f"{'tier':<10} {'traj-steps/s':>15} {'max err vs f64 after 200 steps':>32}")
for k, (rate, err) in results.items():
    print(f"{k:<10} {rate:>15,.0f} {err:>32.3e}")


# The same tiers exist for the OTHER hot path: tangent-linear propagation
# and the Lyapunov toolbox.  precision='twofloat' runs the Benettin
# machinery with double-float tangent propagation and the platform's
# window QR (see qgs_jax.utils.backend): exponents track the f64 oracle,
# where plain f32 drifts at ~1e-5.
from qgs_jax.toolbox.lyapunov import LyapunovsEstimator

ic = np.asarray(df_to_f64(ydf))[:1]

est64 = LyapunovsEstimator()
est64.set_func(f, Df)
est64.compute_lyapunovs(0., 10., 40., 0.1, 0.1, ic, write_steps=1)
m64 = est64.get_lyapunovs()[2].mean(-1)

estdf = LyapunovsEstimator(precision='twofloat')
estdf.set_func(f, Df)
estdf.compute_lyapunovs(0., 10., 40., 0.1, 0.1, ic, write_steps=1)
mdf = estdf.get_lyapunovs()[2].mean(-1)

print("\nLyapunov spectrum, f64 vs twofloat tier (leading 5):")
print("  f64     :", np.array2string(m64[:5], precision=6))
print("  twofloat:", np.array2string(mdf[:5], precision=6))
print(f"  max |diff| = {np.abs(m64 - mdf).max():.2e}")
