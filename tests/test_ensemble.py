"""Ensemble integrator classes + mesh sharding over the 8-device virtual CPU
mesh (conftest forces JAX_PLATFORMS=cpu with 8 host devices)."""

import jax
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator, RungeKuttaTglsIntegrator
from qgs_jax.parallel.mesh import ensemble_mesh, shard_ensemble


def _system():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)
    return pars, f, Df


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_ensemble_integration():
    pars, f, Df = _system()
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)

    rng = np.random.default_rng(0)
    ics = rng.random((16, pars.ndim)) * 0.1      # 2 trajectories per device
    integrator.integrate(0., 20., 0.1, ic=ics, write_steps=10)
    t, y = integrator.get_trajectories()
    assert y.shape == (16, pars.ndim, len(t))

    # must agree with unsharded batch integration
    integ1 = RungeKuttaIntegrator(mesh=ensemble_mesh(jax.devices()[:1]))
    integ1.set_func(f)
    integ1.integrate(0., 20., 0.1, ic=ics, write_steps=10)
    _, y1 = integ1.get_trajectories()
    assert np.allclose(y, y1, rtol=1e-12, atol=1e-13)


def test_sharding_layout():
    mesh = ensemble_mesh()
    arr = np.ones((16, 20))
    sharded, n = shard_ensemble(arr, mesh)
    assert n == 16
    assert len(sharded.sharding.device_set) == 8


def test_initialize_reconverge():
    pars, f, Df = _system()
    integrator = RungeKuttaIntegrator(number_of_dimensions=pars.ndim)
    integrator.set_func(f)
    integrator.initialize(10., 0.1, number_of_trajectories=8,
                          reconvergence_time=1., reconverge=True)
    assert integrator.ic.shape == (8, pars.ndim)
    assert np.all(np.isfinite(integrator.ic))
    # the perturbed ensemble members must have diverged from one another
    assert np.std(integrator.ic, axis=0).max() > 0


def test_tgls_integrator_class():
    pars, f, Df = _system()
    tint = RungeKuttaTglsIntegrator()
    tint.set_func(f, Df)
    ic = np.full(pars.ndim, 0.01)
    dy = np.full(pars.ndim, 1e-4)
    tint.integrate(0., 1., 0.1, ic=ic, tg_ic=dy, write_steps=0)
    t, y, dyf = tint.get_trajectories()
    assert y.shape == (pars.ndim,)
    assert dyf.shape == (pars.ndim,)
    assert np.all(np.isfinite(dyf))


def test_twofloat_precision_tier():
    """precision='twofloat' on the integrator class: same trajectories as
    the float64 path to double-float accuracy, same record semantics."""
    pars, f, Df = _system()
    ref = RungeKuttaIntegrator()
    ref.set_func(f)
    df_int = RungeKuttaIntegrator(precision="twofloat")
    df_int.set_func(f)

    rng = np.random.default_rng(7)
    ic = rng.random((4, pars.ndim)) * 0.05
    for write_steps in (0, 3):
        ref.integrate(0., 10., 0.1, ic=ic, write_steps=write_steps)
        t64, y64 = ref.get_trajectories()
        df_int.integrate(0., 10., 0.1, ic=ic, write_steps=write_steps)
        tdf, ydf = df_int.get_trajectories()
        assert np.array_equal(np.asarray(t64), np.asarray(tdf))
        assert y64.shape == ydf.shape
        assert np.abs(y64 - ydf).max() < 1e-9, np.abs(y64 - ydf).max()

    # any EXPLICIT tableau is supported (RK2 formerly rejected — the df
    # step now splits arbitrary tableau coefficients exactly); implicit
    # tableaux are rejected, not silently wrong
    import pytest
    from qgs_jax.integrators.rk import rk2_tableau
    a2, b2, c2 = rk2_tableau()
    rk2 = RungeKuttaIntegrator(a=a2, b=b2, c=c2, precision="twofloat")
    rk2.set_func(f)
    rk2.integrate(0., 1., 0.1, ic=ic, write_steps=0)
    _, y_rk2 = rk2.get_trajectories()
    assert np.all(np.isfinite(np.asarray(y_rk2)))

    bad = RungeKuttaIntegrator(a=np.array([[0.5]]), b=np.array([1.0]),
                               c=np.array([0.5]), precision="twofloat")
    bad.set_func(f)
    with pytest.raises(ValueError, match="explicit"):
        bad.integrate(0., 1., 0.1, ic=ic)


def test_mode_sharded_tendency_matches_unsharded():
    """Tensor-parallel tendency on a 4x2 (ensemble x model) virtual mesh.

    The default (bucketed) kernel partitions output rows across the model
    axis — disjoint rows, no psum, one all_gather — and must be
    BIT-identical to the jitted unsharded bucketed kernel (same global
    count ladder, same per-row slot order).  The dense kernel (reduction
    axis sharded, one psum per eval) is the comparison path and agrees to
    roundoff."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from qgs_jax.ops.contraction import (jit_contraction,
                                         make_bucketed_contraction)
    from qgs_jax.parallel.sharded_tendency import make_sharded_tendency

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.029, 'kdp': 0.029, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)

    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("ensemble", "model"))

    x = np.random.default_rng(11).random((16, pars.ndim)) * 0.05
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("ensemble", None)))
    out_plain = np.asarray(f.batched(0., jnp.asarray(x)))

    # bucketed (default): bit-identical to the jitted unsharded kernel
    f_bucketed = make_sharded_tendency(tensor.tensor, mesh)
    out_bucketed = np.asarray(jax.jit(f_bucketed)(0., xs))
    cb = make_bucketed_contraction(tensor.tensor)
    xx = jnp.concatenate([jnp.ones((x.shape[0], 1), out_bucketed.dtype),
                          jnp.asarray(x)], axis=1)
    out_ref = np.asarray(jit_contraction(cb)(xx))[:, 1:]
    assert np.array_equal(out_bucketed, out_ref), \
        np.abs(out_bucketed - out_ref).max()
    assert np.allclose(out_bucketed, out_plain, rtol=1e-12, atol=1e-13)

    # dense (psum comparison path): agrees to roundoff
    f_dense = make_sharded_tendency(tensor.tensor, mesh, kernel="dense")
    out_dense = np.asarray(jax.jit(f_dense)(0., xs))
    assert np.allclose(out_dense, out_plain, rtol=1e-12, atol=1e-13), \
        np.abs(out_dense - out_plain).max()
