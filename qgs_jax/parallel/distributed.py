"""
Multi-process distributed execution
===================================

The cross-process half of the ensemble parallelism story.  The reference's
entire parallel layer is a single-node pool of OS processes fed by queues
(ref ``qgs/integrators/integrator.py:77-142``); here it is one SPMD
program over a device mesh that may span several processes:

* each process drives its local cards; :func:`initialize` wires the
  processes together through ``jax.distributed``;
* :func:`host_chip_mesh` lays the global device list out as a 2-D
  ``('ensemble', 'model')`` mesh in which the **model** (mode-space) axis
  is always contained inside one process, so its per-RK-stage collective
  stays on the host's NVLink, while the **ensemble** axis spans processes:
  the only cross-process traffic is the embarrassingly-parallel ensemble
  sharding (no collectives in the hot loop at all);
* global arrays are built with :func:`make_global_array` (every process
  holds the same host copy, as SPMD drivers do) and read back with
  :func:`gather_to_host`.

The multi-process path is exercised with CPU processes and Gloo
collectives (:func:`run_multiprocess_selftest`), which compiles and runs
the same SPMD program a multi-host job would run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENSEMBLE_AXIS = "ensemble"
MODEL_AXIS = "model"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Idempotent wrapper around ``jax.distributed.initialize``.

    With no arguments, relies on the standard ``JAX_COORDINATOR_ADDRESS``
    etc. environment variables; silently no-ops when already initialized or
    when nothing indicates a multi-process run.
    """
    if jax.process_count() > 1:
        return  # already wired up
    has_env = any(k in os.environ for k in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not has_env:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    except RuntimeError as err:  # double-initialize in the same process
        if "already initialized" not in str(err).lower():
            raise


def is_distributed():
    """True when this program runs as one process of a multi-process job."""
    return jax.process_count() > 1


def host_chip_mesh(model_axis_size=1, devices=None):
    """Build the production 2-D ``('ensemble', 'model')`` mesh.

    The global device list (ordered by process, as ``jax.devices()`` is) is
    reshaped so that each size-``model_axis_size`` model group consists of
    devices of a single process — the model-axis collective stays inside
    the host — and the ensemble axis runs across processes.

    ``model_axis_size`` must divide the per-process device count.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    n = devices.size
    counts = {}
    for d in devices.ravel():
        counts[d.process_index] = counts.get(d.process_index, 0) + 1
    local = min(counts.values())
    if model_axis_size < 1 or local % model_axis_size != 0:
        raise ValueError(
            f"model_axis_size={model_axis_size} must divide the per-process "
            f"device count ({local})")
    # jax.devices() sorts by process; reshaping row-major keeps each
    # contiguous model group within one process.
    grid = devices.reshape(n // model_axis_size, model_axis_size)
    return Mesh(grid, (ENSEMBLE_AXIS, MODEL_AXIS))


def make_global_array(host_array, mesh, pspec=None):
    """Build a (possibly multi-process) global ``jax.Array`` from a
    host-replicated numpy array: every process passes the same full array
    and contributes the shards its local devices own."""
    host_array = np.asarray(host_array)
    if pspec is None:
        pspec = P(ENSEMBLE_AXIS)
    sharding = NamedSharding(mesh, pspec)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def gather_to_host(arr):
    """Return the full numpy value of a global array on every process.

    For fully-addressable (single-process) arrays this is a plain copy; in
    a multi-process run it executes one SPMD all-gather (every process must
    call it — standard SPMD discipline)."""
    if not hasattr(arr, "is_fully_addressable") or arr.is_fully_addressable:
        return np.asarray(arr)
    mesh = arr.sharding.mesh
    replicated = jax.jit(lambda x: x,
                         out_shardings=NamedSharding(mesh, P()))(arr)
    return np.asarray(replicated.addressable_data(0))


def free_port():
    """A localhost TCP port that was free when asked (the OS picks it for a
    socket bound to port 0), for a ``jax.distributed`` coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# ---------------------------------------------------------------------------
# multi-process CPU self-test (the virtual multi-host harness)
# ---------------------------------------------------------------------------

def run_multiprocess_selftest(num_processes=2, local_devices=4,
                              model_axis_size=1, timeout=900):
    """Spawn ``num_processes`` CPU processes (each with ``local_devices``
    virtual devices), wire them with ``jax.distributed`` + Gloo, and run the
    distributed MAOOAM ensemble integration self-test in each: the sharded
    multi-host trajectory must match the single-device one.

    Raises ``RuntimeError`` on any failure; returns the workers' report
    lines.  This is the CPU stand-in for an N-host run.
    """
    port = free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={local_devices}"
    env["JAX_ENABLE_X64"] = "1"

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "qgs_jax.parallel.distributed",
               str(pid), str(num_processes), str(port), str(model_axis_size)]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    reports, failures = [], []
    for pid, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"worker {pid} timed out\n{out[-2000:]}")
            continue
        ok_lines = [ln for ln in out.splitlines() if ln.startswith("DISTOK")]
        if proc.returncode != 0 or not ok_lines:
            failures.append(f"worker {pid} rc={proc.returncode}\n{out[-2000:]}")
        else:
            reports.extend(ok_lines)
    if failures:
        raise RuntimeError("multi-process selftest failed:\n" + "\n".join(failures))
    return reports


def _selftest_worker(process_id, num_processes, port, model_axis_size):
    """Body of one self-test process (run via ``python -m``, CPU platform
    and virtual device count fixed by the launcher's environment)."""
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes, process_id=process_id)

    import jax.numpy as jnp
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator

    assert jax.process_count() == num_processes

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

    mesh = host_chip_mesh(model_axis_size)
    n_ens = dict(mesh.shape)[ENSEMBLE_AXIS]
    B = 2 * n_ens
    rng = np.random.default_rng(7)
    ic = rng.random((B, pars.ndim)) * 0.01

    # -- distributed ensemble integration (ensemble axis spans processes) --
    integ = RungeKuttaIntegrator(mesh=mesh)
    integ.set_func(f)
    integ.integrate(0., 5., 0.1, ic=ic, write_steps=10)
    t, traj = integ.get_trajectories()

    # -- single-device oracle (local devices only, no sharding) ------------
    local_mesh = Mesh(np.array(jax.local_devices()[:1]), (ENSEMBLE_AXIS,))
    oracle = RungeKuttaIntegrator(mesh=local_mesh)
    oracle.set_func(f)
    oracle.integrate(0., 5., 0.1, ic=ic, write_steps=10)
    t_ref, traj_ref = oracle.get_trajectories()

    np.testing.assert_allclose(traj, traj_ref, rtol=1e-12, atol=1e-14)

    # -- TGLS: tangent/fundamental matrices sharded across processes -------
    from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator

    tgls = RungeKuttaTglsIntegrator(mesh=mesh)
    tgls.set_func(f, Df)
    tgls.integrate(0., 1., 0.1, ic=ic, tg_ic=np.eye(pars.ndim), write_steps=0)
    _, traj_tg, fmat = tgls.get_trajectories()

    tgls_o = RungeKuttaTglsIntegrator(mesh=local_mesh)
    tgls_o.set_func(f, Df)
    tgls_o.integrate(0., 1., 0.1, ic=ic, tg_ic=np.eye(pars.ndim),
                     write_steps=0)
    _, traj_tg_ref, fmat_ref = tgls_o.get_trajectories()
    np.testing.assert_allclose(fmat, fmat_ref, rtol=1e-12, atol=1e-14)

    # -- Lyapunov toolbox: a short BLV window sharded across processes -----
    from qgs_jax.toolbox.lyapunov import compute_backward_lyapunovs

    _, _, exps, vecs = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 0.5, 1.5, 0.1, 0.1, ic, write_steps=0,
        mesh=mesh)
    _, _, exps_ref, vecs_ref = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 0.5, 1.5, 0.1, 0.1, ic, write_steps=0)
    np.testing.assert_allclose(gather_to_host(exps), gather_to_host(exps_ref),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gather_to_host(vecs), gather_to_host(vecs_ref),
                               rtol=1e-12, atol=1e-14)

    # -- twofloat tier under the distributed mesh: the df kernel is
    # per-member elementwise, so the cross-process result must equal the
    # single-device one exactly
    integ_df = RungeKuttaIntegrator(mesh=mesh, precision="twofloat")
    integ_df.set_func(f)
    integ_df.integrate(0., 1., 0.1, ic=ic, write_steps=0)
    _, traj_df = integ_df.get_trajectories()
    integ_df_o = RungeKuttaIntegrator(mesh=local_mesh, precision="twofloat")
    integ_df_o.set_func(f)
    integ_df_o.integrate(0., 1., 0.1, ic=ic, write_steps=0)
    _, traj_df_ref = integ_df_o.get_trajectories()
    np.testing.assert_allclose(traj_df, traj_df_ref, rtol=1e-12, atol=1e-14)

    # -- model-axis paths, when requested: the bucketed row-partitioned
    # kernel (default; no psum, one all_gather over 'model') and the dense
    # reduction-sharded psum kernel --------------------------------------
    if model_axis_size > 1:
        from qgs_jax.parallel.sharded_tendency import make_sharded_tendency
        from qgs_jax.integrators.rk import make_rk_step, rk4_tableau

        a, b, c = rk4_tableau()
        x = make_global_array(ic, mesh, P(ENSEMBLE_AXIS, None))
        y_ref = np.asarray(jax.jit(make_rk_step(f.batched, a, b, c))(
            jnp.asarray(ic), jnp.asarray(0.0), jnp.asarray(0.1)))
        for kern, rtol in (("bucketed", 1e-10), ("dense", 1e-10)):
            f_sh = make_sharded_tendency(tensor.tensor, mesh, kernel=kern)
            step = jax.jit(make_rk_step(f_sh, a, b, c))
            y = step(x, jnp.asarray(0.0), jnp.asarray(0.1))
            np.testing.assert_allclose(gather_to_host(y), y_ref,
                                       rtol=rtol, atol=1e-12)

    print(f"DISTOK process={process_id}/{num_processes} "
          f"mesh={dict(mesh.shape)} B={B} ndim={pars.ndim} "
          f"records={np.asarray(traj).shape} "
          f"checks=ensemble,tgls,blv,twofloat"
          f"{',model-rowshard,model-psum' if model_axis_size > 1 else ''}",
          flush=True)


if __name__ == "__main__":
    _pid, _np_, _port, _ma = (int(a) for a in sys.argv[1:5])
    _selftest_worker(_pid, _np_, _port, _ma)
