"""
Device-mesh utilities (ensemble SPMD)
=====================================

The replacement for the reference's one-OS-process-per-trajectory
ensemble parallelism (ref ``qgs/integrators/integrator.py:77-142``): the
ensemble (batch) axis of every state array is sharded across a 1-D
``jax.sharding.Mesh`` with a named ``'ensemble'`` axis.  Because the
integrators are pure batched programs, jit + sharded inputs alone yields
SPMD execution — queue/barrier semantics disappear entirely; XLA inserts
any needed collectives.  The cards of a host are joined all to all, so the
mesh follows the algorithm alone, with no topology-shaped device order.

For mode-space parallelism at high resolutions, a second ``'model'`` axis
partitions the contraction's output rows (see
:mod:`qgs_jax.parallel.sharded_tendency`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENSEMBLE_AXIS = "ensemble"


def ensemble_mesh(devices=None):
    """A 1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ENSEMBLE_AXIS,))


def ensemble_sharding(mesh):
    """Sharding that splits the leading (ensemble) axis across the mesh."""
    return NamedSharding(mesh, P(ENSEMBLE_AXIS))


def pad_batch(arr, multiple):
    """Pad the leading axis up to a multiple (repeating the last row) so it
    shards evenly; returns (padded, original_size)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = jnp.repeat(arr[-1:], rem, axis=0)
    return jnp.concatenate([arr, pad], axis=0), n


def ensemble_size(mesh):
    """Size of the mesh's ensemble axis (total devices for 1-D meshes)."""
    return dict(mesh.shape).get(ENSEMBLE_AXIS, mesh.devices.size)


def shard_ensemble(arr, mesh=None):
    """Device-put an ensemble array (leading batch axis) sharded across the
    mesh, padding the batch if needed.  Returns (sharded, original_size).

    Works both single-process (plain ``device_put``) and multi-process (the
    mesh spans hosts; every process passes the same host array and
    contributes its local shards — see
    :mod:`qgs_jax.parallel.distributed`)."""
    if mesh is None:
        mesh = ensemble_mesh()
    n_ens = ensemble_size(mesh)
    sharding = ensemble_sharding(mesh)
    if any(d.process_index != jax.process_index()
           for d in mesh.devices.ravel()):
        host = np.asarray(arr)
        rem = (-host.shape[0]) % n_ens
        n = host.shape[0]
        if rem:
            host = np.concatenate(
                [host, np.repeat(host[-1:], rem, axis=0)], axis=0)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]), n
    arr = jnp.asarray(arr)
    padded, n = pad_batch(arr, n_ens)
    return jax.device_put(padded, sharding), n
