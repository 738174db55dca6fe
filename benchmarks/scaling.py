#!/usr/bin/env python
"""Ensemble-sharding scaling-efficiency report.

Two modes:

* default — measures the MAOOAM ensemble RK4 throughput at 1, 2, 4, ...
  devices of the available mesh (weak scaling: fixed per-device ensemble)
  and reports the parallel efficiency — the BASELINE.json scaling gate.
  On a CPU host the multi-device points run on the virtual host-platform
  mesh; the sharding program is the one a multi-GPU host runs.

* ``--multiprocess`` — the multi-HOST weak-scaling point: 1-process
  baseline vs a 2-process ``jax.distributed`` run (each process pinned to
  its own physical core, 1 virtual device per process, fixed per-process
  ensemble).  The ensemble hot loop has no cross-process collectives at
  all, so this measures the multi-process scaling efficiency; asserts the
  BASELINE ≥85% gate.
"""

import os
import subprocess
import sys
import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import time

import numpy as np

PER_PROC = 512
MP_STEPS = 400


def _mp_worker(process_id, num_processes, port, core):
    """One pinned process of the multi-process weak-scaling measurement."""
    try:
        os.sched_setaffinity(0, {core})
    except (AttributeError, OSError):
        pass
    import jax
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                                   num_processes=num_processes,
                                   process_id=process_id)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    f, Df = create_tendencies(pars)
    a, b, c = rk4_tableau()
    step = make_rk_step(f.batched, a, b, c)

    B = PER_PROC * num_processes
    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("ensemble",))
    sharding = NamedSharding(mesh, P("ensemble"))
    host_ic = np.random.default_rng(0).random((B, pars.ndim)) * 0.01
    y0 = jax.make_array_from_callback(host_ic.shape, sharding,
                                      lambda idx: host_ic[idx])

    @jax.jit
    def run(y):
        return jax.lax.fori_loop(
            0, MP_STEPS,
            lambda i, y: step(y, jnp.asarray(0.0, y.dtype),
                              jnp.asarray(0.1, y.dtype)), y)

    y = run(y0)
    jax.block_until_ready(y)
    if num_processes > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("bench_start")
    t0 = time.perf_counter()
    y = run(y)
    jax.block_until_ready(y)
    elapsed = time.perf_counter() - t0
    print(f"SCALEOK process={process_id} elapsed={elapsed:.6f} "
          f"B={B} steps={MP_STEPS}", flush=True)


def _mp_launch(num_processes):
    from qgs_jax.parallel.distributed import free_port

    port = free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_ENABLE_X64"] = "1"
    repo = str(_pathlib.Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, __file__, "--mp-worker", str(pid),
         str(num_processes), str(port), str(pid % (os.cpu_count() or 1))],
        env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(num_processes)]
    elapsed = []
    for pid, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=1200)
        ok = [ln for ln in out.splitlines() if ln.startswith("SCALEOK")]
        if proc.returncode != 0 or not ok:
            raise RuntimeError(f"scaling worker {pid} failed:\n{out[-2000:]}")
        elapsed.append(float(ok[0].split("elapsed=")[1].split()[0]))
    B = PER_PROC * num_processes
    return B * MP_STEPS / max(elapsed)


def main_multiprocess():
    import json

    rate1 = _mp_launch(1)
    rate2 = _mp_launch(2)
    eff = rate2 / (2 * rate1)
    print(f"{'processes':>10} {'traj-steps/s':>15} {'efficiency':>11}")
    print(f"{1:>10} {rate1:>15,.0f} {'100.0%':>11}")
    print(f"{2:>10} {rate2:>15,.0f} {eff:>10.1%}")
    print("\nMulti-host weak scaling (2 pinned CPU processes, "
          "jax.distributed + Gloo): the ensemble hot loop is "
          "collective-free, so efficiency is compute-bound.")
    print(json.dumps({
        "metric": "maooam_multiprocess_weak_scaling",
        "mode": "2 pinned CPU processes, jax.distributed + Gloo",
        "per_process_ensemble": PER_PROC, "steps": MP_STEPS,
        "traj_steps_per_s": {"1": rate1, "2": rate2},
        "efficiency": eff, "gate": 0.85, "pass": bool(eff >= 0.85),
    }))
    assert eff >= 0.85, f"scaling efficiency {eff:.1%} below the 85% gate"
    print(f"PASS: {eff:.1%} >= 85% (BASELINE.json multi-host gate)")
    return eff


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.integrators.rk import make_rk_step, rk4_tableau
    from qgs_jax.utils.profiling import ThroughputMeter

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    f, Df = create_tendencies(pars)
    a, b, c = rk4_tableau()
    step = make_rk_step(f.batched, a, b, c)

    PER_DEVICE = 512
    STEPS = 100
    devices = jax.devices()
    results = {}

    n_dev = 1
    while n_dev <= len(devices):
        B = PER_DEVICE * n_dev
        mesh = Mesh(np.array(devices[:n_dev]), ("ensemble",))
        sharding = NamedSharding(mesh, P("ensemble"))
        y0 = jax.device_put(
            np.random.default_rng(0).random((B, pars.ndim)) * 0.01, sharding)

        @jax.jit
        def run(y):
            return jax.lax.fori_loop(
                0, STEPS,
                lambda i, y: step(y, jnp.asarray(0.0, y.dtype),
                                  jnp.asarray(0.1, y.dtype)), y)

        y = run(y0)
        y.block_until_ready()
        meter = ThroughputMeter(pars.ndim, ensemble=B)
        with meter:
            y = run(y)
            y.block_until_ready()
        meter.add_steps(STEPS)
        results[n_dev] = meter.traj_steps_per_s
        n_dev *= 2

    import json
    import os

    base = results[1]
    platform = jax.devices()[0].platform
    n_cores = os.cpu_count() or 1
    print(f"{'devices':>8} {'traj-steps/s':>15} {'efficiency':>11}")
    for n_dev, rate in results.items():
        eff = rate / (base * n_dev)
        print(f"{n_dev:>8} {rate:>15,.0f} {eff:>10.1%}")
    if platform == "cpu":
        print(f"\nNOTE: virtual host-platform devices share {n_cores} physical "
              f"core(s); weak-scaling efficiency beyond {n_cores} devices is "
              f"bounded by the silicon, not the sharding program. "
              f"Efficiency vs the {n_cores}-core ideal at {max(results)} devices: "
              f"{results[max(results)] / (base * min(n_cores, max(results))):.1%}.")
    print(json.dumps({
        "metric": "maooam_ensemble_weak_scaling",
        "platform": platform, "per_device_ensemble": PER_DEVICE,
        "traj_steps_per_s": {str(k): v for k, v in results.items()},
        "efficiency": {str(k): results[k] / (base * k) for k in results},
        "physical_cores": n_cores,
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":
        _mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   int(sys.argv[5]))
    elif "--multiprocess" in sys.argv:
        main_multiprocess()
    else:
        main()
