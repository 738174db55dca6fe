"""Mesh-sharded TGLS integration and Lyapunov toolbox: the ensemble axis
(including (B, n, n_tg) tangent/fundamental-matrix blocks) sharded over the
8-device virtual mesh must reproduce the single-device results bit-for-bit
(no cross-member reductions exist in these programs).

Round-1 review: the TGLS ensemble integrator and the whole L5 toolbox ran
single-device; these tests pin the sharded paths (the mesh analogue
of ref ``qgs/toolbox/lyapunov.py:155,816`` pool-parallel estimators).
"""

import jax
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator
from qgs_jax.parallel.mesh import ensemble_mesh
from qgs_jax.toolbox.lyapunov import (
    compute_backward_lyapunovs, compute_clvs_ginelli,
    LyapunovsEstimator, CovariantLyapunovsEstimator,
)


def _system():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)
    return pars, f, Df


def _ics(pars, B=8):
    rng = np.random.default_rng(3)
    return rng.random((B, pars.ndim)) * 0.05


def test_tgls_integrator_sharded_matches_single_device():
    pars, f, Df = _system()
    ics = _ics(pars, 16)
    tg = np.eye(pars.ndim)      # full fundamental matrices, (B, n, n)

    sharded = RungeKuttaTglsIntegrator()                        # all 8 devices
    sharded.set_func(f, Df)
    sharded.integrate(0., 5., 0.1, ic=ics, tg_ic=tg, write_steps=5)
    t_s, y_s, m_s = sharded.get_trajectories()

    # the tangent blocks must actually be sharded across the mesh
    assert len(sharded._recorded_fmatrix.sharding.device_set) == 8

    single = RungeKuttaTglsIntegrator(mesh=ensemble_mesh(jax.devices()[:1]))
    single.set_func(f, Df)
    single.integrate(0., 5., 0.1, ic=ics, tg_ic=tg, write_steps=5)
    t_1, y_1, m_1 = single.get_trajectories()

    assert np.array_equal(t_s, t_1)
    assert np.array_equal(y_s, y_1)
    assert np.array_equal(m_s, m_1)


def test_tgls_integrator_sharded_adjoint_identity():
    """<TL x, y> == <x, AD y> must hold on the sharded path too (one step,
    1e-3 like the reference: the forward-integrated adjoint ODE matches the
    discrete TL transpose only up to the discretization error), and the
    sharded adjoint path must equal the single-device one bitwise."""
    pars, f, Df = _system()
    ics = _ics(pars, 8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(pars.ndim)
    y = rng.standard_normal(pars.ndim)

    tint = RungeKuttaTglsIntegrator()
    tint.set_func(f, Df)
    tint.integrate(0., 0.1, 0.1, ic=ics, tg_ic=x, write_steps=0)
    _, _, tl_x = tint.get_trajectories()
    tint.integrate(0., 0.1, 0.1, ic=ics, tg_ic=y, write_steps=0, adjoint=True)
    _, _, ad_y = tint.get_trajectories()
    lhs = tl_x @ y                    # (B,)
    rhs = ad_y @ x
    assert np.allclose(lhs, rhs, atol=1e-3), np.abs(lhs - rhs).max()

    single = RungeKuttaTglsIntegrator(mesh=ensemble_mesh(jax.devices()[:1]))
    single.set_func(f, Df)
    single.integrate(0., 0.1, 0.1, ic=ics, tg_ic=y, write_steps=0, adjoint=True)
    _, _, ad_y1 = single.get_trajectories()
    assert np.array_equal(ad_y, ad_y1)


def test_backward_lyapunovs_sharded_matches_single_device():
    pars, f, Df = _system()
    ics = _ics(pars, 8)
    mesh8 = ensemble_mesh()
    mesh1 = ensemble_mesh(jax.devices()[:1])

    out8 = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 5., 15., 0.1, 0.1, ics, write_steps=2,
        mesh=mesh8)
    out1 = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 5., 15., 0.1, 0.1, ics, write_steps=2,
        mesh=mesh1)
    for a, b in zip(out8, out1):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_clvs_ginelli_sharded_matches_single_device():
    pars, f, Df = _system()
    ics = _ics(pars, 8)
    mesh8 = ensemble_mesh()

    out8 = compute_clvs_ginelli(
        f.batched, Df.batched, 0., 4., 8., 12., 0.1, 0.1, ics, write_steps=2,
        mesh=mesh8)
    out1 = compute_clvs_ginelli(
        f.batched, Df.batched, 0., 4., 8., 12., 0.1, 0.1, ics, write_steps=2)
    # trajectory is bitwise identical; exponents/vectors go through
    # solve_triangular/einsum, which XLA tiles differently per local batch
    # size — allow machine-epsilon differences there
    assert np.array_equal(np.asarray(out8[1]), np.asarray(out1[1]))
    assert np.allclose(np.asarray(out8[2]), np.asarray(out1[2]),
                       rtol=1e-12, atol=1e-12)
    assert np.allclose(np.asarray(out8[3]), np.asarray(out1[3]),
                       rtol=1e-12, atol=1e-12)


def test_sharded_padding_unpadded_batch():
    """A batch that does not divide the mesh size must be padded, sharded
    and un-padded transparently."""
    pars, f, Df = _system()
    ics = _ics(pars, 11)        # 11 % 8 != 0
    mesh8 = ensemble_mesh()
    out8 = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 2., 6., 0.1, 0.1, ics, write_steps=2,
        mesh=mesh8)
    out1 = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 2., 6., 0.1, 0.1, ics, write_steps=2)
    assert np.asarray(out8[1]).shape[0] == 11
    for a, b in zip(out8, out1):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_estimators_accept_mesh():
    pars, f, Df = _system()
    ics = _ics(pars, 8)
    mesh = ensemble_mesh()

    est = LyapunovsEstimator(mesh=mesh)
    est.set_func(f.batched, Df.batched)
    est.compute_lyapunovs(0., 2., 8., 0.1, 0.1, ics, write_steps=2)
    t, traj, exps, vecs = est.get_lyapunovs()
    assert traj.shape[0] == 8 and np.isfinite(exps).all()

    cest = CovariantLyapunovsEstimator(mesh=mesh)
    cest.set_func(f.batched, Df.batched)
    cest.compute_clvs(0., 2., 4., 6., 0.1, 0.1, ics, write_steps=2)
    t, traj, exps, vecs = cest.get_clvs()
    assert traj.shape[0] == 8 and np.isfinite(vecs).all()
