"""
qgs-jax: a reduced-order spectral climate model framework on JAX
===============================================================

A from-scratch JAX/XLA implementation of the capabilities of the
Climdyn/qgs framework (2-layer QG channel atmosphere, optionally coupled to
a shallow-water ocean — MAOOAM — or to a land/ground component).

Architecture:

* **Host setup pipeline** (NumPy/SymPy): parameters -> Fourier basis ->
  inner products -> sparse tendency tensor.  One-time O(ndim^3..5) work.
* **Device compute path** (JAX/XLA, on a GPU or the CPU): the tendency
  tensor is closed over by jit-compiled contraction kernels feeding
  ``lax.scan`` Runge-Kutta integrators, tangent-linear/adjoint propagators
  and the Lyapunov toolbox.
* **Scaling**: ensembles of trajectories are sharded across a
  ``jax.sharding.Mesh``; batch-parallel SPMD replaces the reference's
  one-process-per-trajectory multiprocessing design.

Float64 is enabled by default (required for faithful trajectories of this
chaotic system); set ``QGS_X64=0`` before import to opt out.
"""

import os

if os.environ.get("QGS_X64", "1") != "0":
    import jax

    jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
