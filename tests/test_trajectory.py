"""Trajectory fidelity: the JAX scan integrator must match the
reference-semantics NumPy backend allclose over N RK4 steps, for both the
RP atmosphere-only and the coupled MAOOAM configurations
(driver gate, see BASELINE.json)."""

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.models.numpy_backend import (
    make_numpy_tendencies, integrate_runge_kutta_numpy,
)
from qgs_jax.integrators.rk import integrate_runge_kutta


def _rp_params():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def _maooam_params():
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3, 'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


@pytest.mark.parametrize("make_params,label", [(_rp_params, "rp"),
                                               (_maooam_params, "maooam")])
def test_trajectory_matches_reference_semantics(make_params, label):
    pars = make_params()
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    fn, _ = make_numpy_tendencies(tensor.tensor, tensor.jacobian_tensor)

    rng = np.random.default_rng(21217)
    ic = rng.random(pars.ndim) * 0.01

    # point check of the tendencies themselves
    fx_jax = np.asarray(f(0., ic))
    fx_np = fn(0., ic)
    assert np.allclose(fx_jax, fx_np, rtol=1e-12, atol=1e-14)

    # 300 RK4 steps (exact reference summation order on the NumPy side)
    t_np, y_np = integrate_runge_kutta_numpy(fn, 0., 30., 0.1, ic, write_steps=5)
    t_jx, y_jx = integrate_runge_kutta(f.batched, 0., 30., 0.1, ic, write_steps=5)
    assert np.allclose(t_np, t_jx)
    assert np.allclose(np.asarray(y_jx), y_np, rtol=1e-9, atol=1e-11), \
        f"{label}: max abs err {np.abs(np.asarray(y_jx) - y_np).max()}"


def test_ensemble_batch_consistency():
    """A batch of ICs integrated together must match per-IC integration."""
    pars = _rp_params()
    f, Df = create_tendencies(pars)
    rng = np.random.default_rng(7)
    ics = rng.random((4, pars.ndim)) * 0.01

    _, traj_batch = integrate_runge_kutta(f.batched, 0., 10., 0.1, ics, write_steps=0)
    for i in range(4):
        _, traj_one = integrate_runge_kutta(f.batched, 0., 10., 0.1, ics[i], write_steps=0)
        assert np.allclose(np.asarray(traj_batch)[i], np.asarray(traj_one),
                           rtol=1e-12, atol=1e-13)


def test_write_steps_semantics():
    """Record grid must match the reference: time[::w] plus the final point."""
    pars = _rp_params()
    f, _ = create_tendencies(pars)
    ic = np.full(pars.ndim, 0.01)
    t, y = integrate_runge_kutta(f.batched, 0., 1.05, 0.1, ic, write_steps=5)
    # time grid: arange(0, 1.05, .1) (11 pts) + [1.05] -> 12 points, ticks 0,5,10 + final 11
    assert len(t) == 4
    assert y.shape == (pars.ndim, 4)


def test_high_resolution_coo_mode():
    """6x6 config (ndim=228): auto mode picks the gather-scatter COO path;
    it must agree with the dense einsum path."""
    from qgs_jax.inner_products.analytic import (
        AtmosphericAnalyticInnerProducts, OceanicAnalyticInnerProducts,
    )
    from qgs_jax.tensors.qgtensor import QgsTensor
    from qgs_jax.ops.contraction import make_tendency_fns

    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8})
    pars.set_atmospheric_channel_fourier_modes(6, 6)
    pars.set_oceanic_basin_fourier_modes(6, 6)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    aip = AtmosphericAnalyticInnerProducts(pars)
    oip = OceanicAnalyticInnerProducts(pars)
    aip.connect_to_ocean(oip)
    tensor = QgsTensor(pars, aip, oip)
    assert pars.ndim == 228

    f_auto, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor, mode="auto")
    f_dense, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor, mode="dense")
    x = np.random.default_rng(0).random((3, pars.ndim)) * 0.01
    fa = np.asarray(f_auto(0., x))
    fd = np.asarray(f_dense(0., x))
    assert np.allclose(fa, fd, rtol=1e-11, atol=1e-13)


def test_backward_integration_roundtrip():
    """Backward integration must invert forward integration."""
    pars = _rp_params()
    f, _ = create_tendencies(pars)
    ic = np.random.default_rng(11).random(pars.ndim) * 0.01
    _, y_fwd = integrate_runge_kutta(f.batched, 0., 5., 0.1, ic, write_steps=0)
    _, y_back = integrate_runge_kutta(f.batched, 0., 5., 0.1,
                                      np.asarray(y_fwd), write_steps=0,
                                      forward=False)
    assert np.allclose(np.asarray(y_back), ic, atol=1e-7)


def test_native_kernels_bitwise_parity():
    """The C++ kernels must reproduce the Python reference-semantics loops
    bit-for-bit (same storage-order accumulation, FP contraction disabled)."""
    from qgs_jax import native
    if not native.available():
        pytest.skip("no C++ toolchain")
    pars = _maooam_params()
    _, _, tensor = create_tendencies(pars, return_qgtensor=True)
    fn_c, Dfn_c = native.make_native_tendencies(tensor.tensor, tensor.jacobian_tensor)
    fn_p, Dfn_p = make_numpy_tendencies(tensor.tensor, tensor.jacobian_tensor)
    x = np.random.default_rng(3).random(pars.ndim) * 0.05
    assert np.array_equal(fn_c(0., x), fn_p(0., x))
    assert np.array_equal(Dfn_c(0., x), Dfn_p(0., x))

    # native RK4 vs python-loop RK4 (same tableau arithmetic)
    from qgs_jax.models.numpy_backend import integrate_runge_kutta_numpy
    _, y_py = integrate_runge_kutta_numpy(fn_p, 0., 10., 0.1, x, write_steps=0)
    y_c, rec = native.rk4_integrate(tensor.tensor, x, 0.1, 100, write_steps=10)
    assert np.allclose(y_c, y_py, rtol=1e-13, atol=1e-15)
    assert rec.shape[0] == 11
    assert np.allclose(rec[0], x)


def test_jax_trajectory_matches_native_oracle():
    """Fidelity gate against the fast native oracle over 10k RK4 steps."""
    from qgs_jax import native
    if not native.available():
        pytest.skip("no C++ toolchain")
    pars = _maooam_params()
    f, _, tensor = create_tendencies(pars, return_qgtensor=True)
    x = np.random.default_rng(5).random(pars.ndim) * 0.01
    y_c, _ = native.rk4_integrate(tensor.tensor, x, 0.1, 10000)
    _, y_j = integrate_runge_kutta(f.batched, 0., 1000., 0.1, x, write_steps=0)
    assert np.allclose(np.asarray(y_j), y_c, rtol=1e-6, atol=1e-8), \
        np.abs(np.asarray(y_j) - y_c).max()


def test_f32_dtype_preserved_through_scan():
    """f32 states must stay f32 through the scan integrators: the traced
    f64 (t, dt) pairs used to promote the carry, which silently ran the
    f32 tier in f64 (and broke lax.scan carry typing for f32 ensembles)."""
    import jax.numpy as jnp
    from qgs_jax.integrators.rk import integrate_runge_kutta_tgls

    pars = _maooam_params()
    f, Df = create_tendencies(pars, dtype=jnp.float32)
    ic = (np.random.default_rng(0).random((4, pars.ndim)) * 0.01).astype(np.float32)

    _, y = integrate_runge_kutta(f.batched, 0., 5., 0.1, ic, write_steps=0)
    assert np.asarray(y).dtype == np.float32

    _, y, m = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 1., 0.1,
                                         ic, np.eye(pars.ndim, dtype=np.float32),
                                         write_steps=0)
    assert np.asarray(y).dtype == np.float32
    assert np.asarray(m).dtype == np.float32


def test_dimension_autoprobe():
    """ic=None infers ndim from the tendency function and integrates a zero
    IC (ref ``qgs/integrators/integrate.py:131-143``)."""
    import jax.numpy as jnp
    from qgs_jax.integrators.rk import infer_ndim, integrate_runge_kutta
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator

    from qgs_jax.models.tendencies import create_tendencies
    pars = _rp_params()
    f, Df = create_tendencies(pars)
    assert infer_ndim(f.batched) == pars.ndim

    t, traj = integrate_runge_kutta(f.batched, 0., 1., 0.1)
    assert traj.shape[0] == pars.ndim

    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    integ.initialize(10., 0.1, number_of_trajectories=2)
    assert integ.get_ic().shape == (2, pars.ndim)


def test_float_batch_chunking_identical():
    """Single-float batch chunking past the f32 chunk threshold (the plain-path
    analogue of the df chunking, ``QGS_F32_BATCH_CHUNK``): chunked
    integration is BIT-identical to the unchunked program (per-member
    arithmetic is unchanged), odd batches are zero-padded/sliced, and
    ``batch_devices`` scales the per-device threshold so an at-knee
    sharded batch stays unchunked."""
    import os

    pars = _rp_params()
    f, Df = create_tendencies(pars)
    rng = np.random.default_rng(11)
    ic = rng.random((10, pars.ndim)) * 0.05    # odd vs chunk of 3

    saved = os.environ.get("QGS_F32_BATCH_CHUNK")
    try:
        os.environ["QGS_F32_BATCH_CHUNK"] = "0"
        _, y_plain = integrate_runge_kutta(f.batched, 0., 5., 0.1, ic,
                                           write_steps=10)
        os.environ["QGS_F32_BATCH_CHUNK"] = "3"  # k=4 chunks, pad 2
        _, y_chunk = integrate_runge_kutta(f.batched, 0., 5., 0.1, ic,
                                           write_steps=10)
        assert np.asarray(y_chunk).shape == np.asarray(y_plain).shape
        assert (np.asarray(y_chunk) == np.asarray(y_plain)).all()

        # per-device knee scaling: 8 "devices" x 3 > B keeps it unchunked
        _, y_dev = integrate_runge_kutta(f.batched, 0., 5., 0.1, ic,
                                         write_steps=10, batch_devices=8)
        assert (np.asarray(y_dev) == np.asarray(y_plain)).all()
    finally:
        if saved is None:
            os.environ.pop("QGS_F32_BATCH_CHUNK", None)
        else:
            os.environ["QGS_F32_BATCH_CHUNK"] = saved
