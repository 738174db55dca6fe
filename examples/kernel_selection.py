#!/usr/bin/env python
"""Contraction-kernel selection: how the tendency contraction maps onto
the device, and how to steer it."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np
import jax.numpy as jnp

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.ops.contraction import make_tendency_fns

# Every qgs model reduces to ONE sparse tensor contraction per tendency
# evaluation: dx_i/dt = sum_jk T[i,j,k] x_j x_k (rank 5 for the quartic
# schemes).  The device kernel that evaluates it is selectable — build
# the MAOOAM system and look at the alternatives.
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
f, Df, qgt = create_tendencies(pars, return_qgtensor=True)
T, JT = qgt.tensor, qgt.jacobian_tensor
print(f"ndim {pars.ndim}, tensor nnz {T.nnz}")

# The default ('auto' = 'bucketed') is the count-bucketed gather kernel:
# output rows grouped by their EXACT nonzero count — no padding slots —
# and entries grouped by how many state gathers they need (constants and
# linear terms gather once, bilinear terms twice).  Which kernel is
# fastest on a GPU at each resolution is not measured yet.
modes = {}
for mode in ("bucketed", "rowsum", "coo", "dense"):
    modes[mode], _ = make_tendency_fns(T, JT, mode=mode)
rng = np.random.default_rng(0)
x = rng.random((4, pars.ndim)) * 0.05
ref = np.asarray(modes["bucketed"](0., jnp.asarray(x)))
for mode, fn in modes.items():
    err = np.abs(np.asarray(fn(0., jnp.asarray(x))) - ref).max()
    print(f"  mode {mode:>9}: max deviation from bucketed {err:.2e}")

# The tensor buffers are jit ARGUMENTS, not baked constants: each kernel
# is a Contraction whose device buffers live in an `.operands` pytree,
# and compiled executables are cached by the structural `.key`.  Two
# models with the same resolution share one executable — changing a
# physics parameter costs a dispatch, not a fresh compile.
fb = modes["bucketed"]
print("structural key:", fb.key[0], "...")
import jax
n_bufs = len(jax.tree_util.tree_leaves(fb.operands))
print("operand buffers threaded through jit:", n_bufs)

pars.set_params({'kd': 0.035, 'kdp': 0.035})
f2, _, qgt2 = create_tendencies(pars, return_qgtensor=True)
f2b, _ = make_tendency_fns(qgt2.tensor, qgt2.jacobian_tensor)
print("same-shape model shares the compiled apply:",
      f2b.apply is fb.apply)

# The dense path matricizes the tensor into one (B, n1^2) x (n1^2, n1)
# matmul at HIGHEST precision, with the tensor (~2 GB at ndim 754)
# shipped as a device argument.
fd = modes["dense"]
T2T = fd.operands["T2T"]
print(f"dense operand: {T2T.shape} ({T2T.size * 4 / 1e6:.1f} MB f64/f32)")

# Rank-5 quartic tensors (dynamic_T / T4) additionally factor their four
# per-entry gathers through a shared PAIR alphabet p = x_a * x_b — a few
# hundred pairs serve thousands of entries.  See the maooam_T4 notebook
# for the quartic model itself.
print("kernel menu: auto | bucketed | pairsum | rowsum | rowsum_fm | "
      "coo | dense")
