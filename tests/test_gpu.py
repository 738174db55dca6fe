"""Checks that mean something only on the card (``pytest -m gpu``; phase 6
of ``chip_smoke.py`` runs them).  Here they skip: XLA:CPU strips the
double-float barriers and has no TF32, so neither check can fail on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` there")


@pytest.fixture(scope="module")
def maooam():
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.params.params import QgParams

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.029, 'kdp': 0.029, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    return pars, f, tensor


def test_twofloat_tracks_f64_on_card(gpu, maooam):
    """The double-float tier holds 1e-12 absolute against native float64
    over 100 RK4 steps with the platform's accumulation policy."""
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator

    pars, f, _ = maooam
    ic = np.random.default_rng(0).random((256, pars.ndim)) * 0.01
    out = {}
    for precision in ("float64", "twofloat"):
        integ = RungeKuttaIntegrator(precision=precision)
        integ.set_func(f)
        integ.integrate(0., 10., 0.1, ic=ic, write_steps=0)
        out[precision] = np.asarray(integ.get_trajectories()[1])
    err = np.abs(out["twofloat"] - out["float64"]).max()
    assert err <= 1e-12, err


def test_f32_jacobian_is_not_tf32(gpu, maooam):
    """The f32 Jacobian contraction (a one-hot matmul) keeps true f32
    products: <= 1e-6 relative to float64, where TF32 reads ~1e-3."""
    from qgs_jax.ops.contraction import make_coo_jacobian

    pars, _, tensor = maooam
    jt = tensor.jacobian_tensor
    x = np.random.default_rng(1).random((64, pars.ndim)) * 0.05
    xx = np.concatenate([np.ones((64, 1)), x], axis=1)
    j64 = np.asarray(make_coo_jacobian(jt, jnp.float64)(jnp.asarray(xx)))
    j32 = np.asarray(make_coo_jacobian(jt, jnp.float32)(
        jnp.asarray(xx, jnp.float32)), np.float64)
    rel = np.abs(j32 - j64).max() / np.abs(j64).max()
    assert rel <= 1e-6, rel
