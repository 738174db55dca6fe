"""Multi-process (virtual multi-host) distributed-execution tests.

The mesh replacement for the reference's single-node process pool
(ref ``qgs/integrators/integrator.py:77-142``) must also cover the
cross-host case.  These tests spawn real OS processes wired with
``jax.distributed`` + Gloo over CPU devices and check that the sharded
multi-host MAOOAM integration matches the single-device oracle
bit-for-bit (see ``qgs_jax/parallel/distributed.py``).
"""

import numpy as np
import pytest

from qgs_jax.parallel.distributed import host_chip_mesh, run_multiprocess_selftest


def test_multiprocess_ensemble_and_model_axes():
    # 2 processes x 2 virtual devices each: ensemble axis spans processes
    # (cross-host analogue), model axis stays inside a process.
    reports = run_multiprocess_selftest(num_processes=2, local_devices=2,
                                        model_axis_size=2)
    assert len(reports) == 2
    for r in reports:
        assert "mesh={'ensemble': 2, 'model': 2}" in r


def test_host_chip_mesh_layout():
    # single-process: 8 virtual devices, model groups must be contiguous
    mesh = host_chip_mesh(model_axis_size=2)
    assert dict(mesh.shape) == {"ensemble": 4, "model": 2}
    with pytest.raises(ValueError):
        host_chip_mesh(model_axis_size=3)


def test_gather_to_host_single_process():
    from qgs_jax.parallel.distributed import gather_to_host, make_global_array
    from jax.sharding import PartitionSpec as P

    mesh = host_chip_mesh(model_axis_size=1)
    x = np.arange(32, dtype=np.float64).reshape(8, 4)
    g = make_global_array(x, mesh, P("ensemble", None))
    np.testing.assert_array_equal(gather_to_host(g), x)
