#!/usr/bin/env python
"""Generate notebooks/introduction_qgs_jax.ipynb (unexecuted; run
tools/run_notebooks.py afterwards).  Counterpart of the reference's
``notebooks/introduction_qgs.ipynb``, teaching the accelerator-specific
surface: precision tiers, kernel modes, device meshes, compile-cache
behavior."""

import json
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]


def md(src):
    return {"cell_type": "markdown", "metadata": {}, "source": src}


def code(src):
    return {"cell_type": "code", "metadata": {}, "source": src,
            "outputs": [], "execution_count": None}


CELLS = [
    md("""# Introduction to qgs-jax

qgs-jax is a JAX rebuild of the [qgs](https://github.com/Climdyn/qgs)
reduced-order climate model framework: the same model family (2-layer QG
channel atmosphere, coupled MAOOAM ocean, ground/heat-exchange variants,
dynamic-T and T^4 radiation), the same parameter/diagnostics/toolbox API —
re-designed around JAX/XLA.  This notebook teaches the four concepts that
make it different from the reference:

1. **batched-first integration** — the ensemble is one array, not a worker
   pool;
2. **precision tiers** — `float32`, `twofloat` (double-float: ~48-bit
   mantissa from f32 arithmetic), and `float64`;
3. **kernel modes** — interchangeable device implementations of the tendency
   contraction;
4. **device meshes** — scaling by `(ensemble, model)` sharding instead of
   process pools.

Model physics itself is covered in `docs/model_description.md` and the
per-scheme chapters; the per-coefficient derivations are in
`docs/model/coefficient_families.md`."""),
    code("import sys\nsys.path.insert(0, \"..\")"),
    code("""import os

os.environ.setdefault("JAX_ENABLE_X64", "true")
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# this walkthrough runs on a virtual 8-device CPU mesh — the standard
# single-process stand-in; on a GPU host, drop these overrides and the
# same code runs unchanged on the cards jax.devices() reports
print(jax.devices())"""),
    md("""## 1. Batched-first integration

The reference parallelizes ensembles with a pool of worker processes; here
the ensemble is a leading array axis and ONE compiled program integrates
every member (`vmap`-free: the kernels are written batched).  Build the
coupled MAOOAM model exactly as in the reference and integrate 32
trajectories at once."""),
    code("""import numpy as np
from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator

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
f, Df = create_tendencies(pars)

rng = np.random.default_rng(0)
ic = rng.random((32, pars.ndim)) * 0.01

integ = RungeKuttaIntegrator()
integ.set_func(f)
integ.integrate(0., 100., 0.1, ic=ic, write_steps=100)
t, traj = integ.get_trajectories()
print("ensemble trajectory block:", np.asarray(traj).shape,
      " (members, ndim, records)")"""),
    md("""## 2. Precision tiers

qgs-jax exposes three tiers (throughputs measured on the GPU are in the
README's Performance section):

| tier | arithmetic | accuracy |
|---|---|---|
| `float32` | f32, HIGHEST-precision matmuls | ~1e-7 rel |
| `twofloat` | double-float (2x f32, error-free transforms) | ~1e-12 abs vs f64 |
| `float64` | native f64 | reference |

Select the tier per integrator call:"""),
    code("""import jax.numpy as jnp
from qgs_jax.ops.contraction import make_tendency_fns
from qgs_jax.integrators.rk import integrate_runge_kutta

ic1 = np.asarray(traj)[:, :, -1]          # continue from the spun-up state
f64v, _, tensor = create_tendencies(pars, return_qgtensor=True)

out = {}
# float64 (ambient) and twofloat: integrator precision switch
for precision in ("float64", "twofloat"):
    r = RungeKuttaIntegrator(precision=precision)
    r.set_func(f)
    r.integrate(0., 10., 0.1, ic=ic1.astype(np.float64), write_steps=0)
    _, y = r.get_trajectories()
    out[precision] = np.asarray(y)

# float32: an AMBIENT-dtype choice — float32 kernels + float32 ICs
f32, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                           dtype=jnp.float32)
_, y32 = integrate_runge_kutta(f32, 0., 10., 0.1,
                               ic=ic1.astype(np.float32), write_steps=0)
out["float32"] = np.asarray(y32)

for tier in ("float32", "twofloat"):
    err = np.abs(out[tier] - out["float64"]).max()
    print(f"{tier:9s} vs float64 after 10 time-units: max abs dev {err:.2e}")"""),
    md("""(On CPU — this notebook's backend — the XLA backend partially strips the
error-free-transform barriers, so the twofloat deviation here is larger
than on the GPU; the ordering between tiers is the same.)

## 3. Kernel modes

Everything the model computes reduces to sparse tensor contractions
`f_i = T[i,j,k] x_j x_k`.  `qgs_jax.ops.contraction` ships interchangeable
device kernels, and `make_tendency_fns(mode=...)` selects one:

* `'bucketed'` (**auto**): rows grouped by nonzero count, zero padding
  eliminated, each bucket's gather, multiply and reduction fused;
* `'dense'`: one matricized `(B, n1^2) x (n1^2, n1)` matmul;
* `'coo'`, `'rowsum'`, `'rowsum_fm'`, `'pairsum'`: scatter-matmul and flat
  gather layouts, kept as comparison rows.

See `notebooks/kernel_selection.ipynb` for the full menu.  All kernels share
one contract: tensors are **jit arguments, not baked constants**, and
executables are cached by a *structural key* — a new parameter set of the
same resolution reuses the compiled program:"""),
    code("""import jax.numpy as jnp
from qgs_jax.ops.contraction import make_tendency_fns

f2, Df2, tensor = create_tendencies(pars, return_qgtensor=True)
fb, jb = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor)
fd, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                          mode="dense")
x = jnp.asarray(ic1)
print("bucketed vs dense kernel max dev:",
      float(jnp.abs(fb(0., x) - fd(0., x)).max()))
print("structural key (shared by every same-shape model):")
print(" ", fb.key)"""),
    md("""## 4. Device meshes

Scaling is by `jax.sharding` over a named `Mesh`, not process pools:

* the **`ensemble` axis** shards trajectories (data parallelism — what the
  reference's pool did, minus the processes);
* the **`model` axis** shards the contraction itself (mode-space tensor
  parallelism — the axis the reference cannot scale).  The default
  model-axis kernel partitions the bucketed kernel's output rows: rows are
  disjoint, so the only collective is one `all_gather` of the compact
  per-device row block — no psum.

The same program runs on this notebook's 8 virtual CPU devices, one GPU,
or the four cards of a host."""),
    code("""from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from qgs_jax.parallel.sharded_tendency import make_sharded_tendency
from qgs_jax.integrators.rk import make_rk_step, rk4_tableau

mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("ensemble", "model"))
f_sh = make_sharded_tendency(tensor.tensor, mesh)

a, b, c = rk4_tableau()
step = jax.jit(make_rk_step(f_sh, a, b, c))
x = jax.device_put(jnp.asarray(ic1), NamedSharding(mesh, P("ensemble", None)))
y = step(x, jnp.asarray(0.0), jnp.asarray(0.1))
print("sharded RK4 step on mesh", dict(mesh.shape), "->", y.shape)
print("matches the unsharded kernel:",
      bool(jnp.allclose(y, jax.jit(make_rk_step(f2.batched, a, b, c))(
          jnp.asarray(ic1), jnp.asarray(0.0), jnp.asarray(0.1)),
          rtol=1e-10, atol=1e-12)))"""),
    md("""The ensemble estimators (`RungeKuttaIntegrator`,
`LyapunovsEstimator`, ...) all accept `mesh=` directly; multi-host runs
add `qgs_jax.parallel.distributed.initialize()` — see
`notebooks/distributed_ensembles.ipynb`.

## 5. Compile-cache behavior

* Everything under `jit` is traced once per **shape**: the first call for a
  new (batch, ndim, steps) combination compiles, later calls replay at full
  speed.  The entry scripts keep a persistent cache
  (`JAX_COMPILATION_CACHE_DIR`, else `.jax_cache/`) that survives process
  restarts.
* A new **parameter set** at the same resolution is NOT a new shape:
  tensors are operands, so there is no recompile.
* Program size scales with the bucket-ladder size; `QGS_BUCKET_MAX`
  (default 16, DP-placed thresholds, bit-identical results) trades a few
  percent of padded slots against compile latency at high resolution.
* Batch chunking (`QGS_DF_BATCH_CHUNK`, `QGS_F32_BATCH_CHUNK`) is off by
  default: on the H100 it never beat the unchunked step.

## 6. Where to go next

* `simple_run.ipynb`, `maooam_run.ipynb` — the model configurations.
* `precision_tiers.ipynb` — the tier menu in depth.
* `kernel_selection.ipynb` — kernel modes and how to select one.
* `model_lyapunov.ipynb`, `clv_walkthrough.ipynb` — the Lyapunov toolbox.
* `distributed_ensembles.ipynb` — multi-process meshes.
* `docs/` — model derivations, technical description, API site."""),
]


def main():
    nb = {
        "cells": CELLS,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    out = REPO / "notebooks" / "introduction_qgs_jax.ipynb"
    out.write_text(json.dumps(nb, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
