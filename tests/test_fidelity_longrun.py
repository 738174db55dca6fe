"""Long-horizon climate-fidelity gate (slow).

Chaotic divergence rules out pointwise allclose beyond a few hundred
steps, so the >= 1e5-step gate compares *climate statistics* between the
device twofloat path and the native f64 oracle (bit-exact reference
semantics) — see ``benchmarks/fidelity.py`` for the recorded tolerances
and the reference smoke-run context (ref ``README.md:68-91``).
"""

import numpy as np
import pytest

from qgs_jax import native

from benchmarks.fidelity import (
    attractor_ensemble, build_maooam, check_metrics, compare_climate,
    run_device_twofloat, run_oracle,
)

pytestmark = pytest.mark.slow

N_STEPS = 120_000
ENSEMBLE = 4
WRITE = 10


@pytest.mark.skipif(not native.available(), reason="native oracle unavailable")
def test_maooam_climate_statistics_twofloat_vs_f64_oracle():
    pars, tensor = build_maooam()
    ics = attractor_ensemble(tensor, pars.ndim, ENSEMBLE)
    oracle = run_oracle(tensor, ics, N_STEPS, WRITE)
    device = run_device_twofloat(tensor, ics, N_STEPS, WRITE)

    assert oracle.shape == device.shape
    assert np.all(np.isfinite(device))

    # short-horizon sanity: the first records must still agree pointwise
    np.testing.assert_allclose(device[:, :5], oracle[:, :5],
                               rtol=5e-7, atol=5e-9)

    metrics = compare_climate(oracle, device, verbose=False)
    check_metrics(metrics)
