"""Lyapunov toolbox validation on the Lorenz-63 system, whose spectrum is
known: (0.906, 0, -14.57) at the classical parameters."""

import jax.numpy as jnp
import numpy as np
import pytest

from qgs_jax.toolbox.lyapunov import (
    compute_backward_lyapunovs, compute_forward_lyapunovs,
    compute_clvs_ginelli, compute_clvs_subspace,
    LyapunovsEstimator, CovariantLyapunovsEstimator,
)
from qgs_jax.integrators.rk import integrate_runge_kutta

SIGMA, RHO, BETA = 10., 28., 8. / 3.
L63_SPECTRUM = np.array([0.906, 0.0, -14.572])


def f63(t, x):
    return jnp.stack([SIGMA * (x[:, 1] - x[:, 0]),
                      RHO * x[:, 0] - x[:, 1] - x[:, 0] * x[:, 2],
                      x[:, 0] * x[:, 1] - BETA * x[:, 2]], axis=1)


def Df63(t, x):
    B = x.shape[0]
    z = jnp.zeros(B)
    o = jnp.ones(B)
    return jnp.stack([
        jnp.stack([-SIGMA * o, SIGMA * o, z], axis=1),
        jnp.stack([RHO - x[:, 2], -o, -x[:, 0]], axis=1),
        jnp.stack([x[:, 1], x[:, 0], -BETA * o], axis=1),
    ], axis=1)


@pytest.fixture(scope="module")
def attractor_ic():
    ic = np.array([[1., 1., 1.], [-3., 2., 20.]])
    _, y = integrate_runge_kutta(f63, 0., 50., 0.01, ic, write_steps=0)
    return np.asarray(y)


def test_backward_lyapunovs_spectrum(attractor_ic):
    t, traj, exps, vecs = compute_backward_lyapunovs(
        f63, Df63, 0., 20., 120., 0.01, 0.01, attractor_ic, write_steps=1)
    mean_exps = np.asarray(exps).mean(axis=-1)      # (B, 3)
    for b in range(2):
        assert np.allclose(mean_exps[b], L63_SPECTRUM, atol=0.35), mean_exps[b]
    # vectors orthonormal
    v = np.asarray(vecs)[0, :, :, -1]
    assert np.allclose(v.T @ v, np.eye(3), atol=1e-10)
    # exponent sum ~ divergence = -(sigma + 1 + beta)
    assert abs(mean_exps[0].sum() - (-(SIGMA + 1 + BETA))) < 0.3


def test_forward_lyapunovs_spectrum(attractor_ic):
    t, traj, exps, vecs = compute_forward_lyapunovs(
        f63, Df63, 0., 100., 120., 0.01, 0.01, attractor_ic, write_steps=1)
    mean_exps = np.asarray(exps).mean(axis=-1)
    # FLV columns converge under the backward dynamics, so they come out in
    # ascending-exponent order (the reference's convention as well)
    for b in range(2):
        assert np.allclose(mean_exps[b][::-1], L63_SPECTRUM, atol=0.35), mean_exps[b]


def test_clvs_ginelli(attractor_ic):
    t, traj, exps, vecs = compute_clvs_ginelli(
        f63, Df63, 0., 20., 60., 80., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    mean_exps = np.asarray(exps).mean(axis=-1)
    assert np.allclose(np.sort(mean_exps)[::-1], L63_SPECTRUM, atol=0.5), mean_exps
    # CLVs are norm-1 but NOT orthogonal in general
    v = np.asarray(vecs)[:, :, 100]
    assert np.allclose(np.linalg.norm(v, axis=0), 1., atol=1e-8)
    # first CLV should align with the first BLV
    _, _, _, bv = compute_backward_lyapunovs(
        f63, Df63, 0., 20., 60., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    b1 = np.asarray(bv)[:, 0, 100]
    c1 = v[:, 0]
    assert abs(abs(np.dot(b1, c1)) - 1.) < 1e-6


def test_clvs_covariance_property(attractor_ic):
    """The defining property: the tangent flow maps CLV_j(t) onto
    span(CLV_j(t+dt)) — check alignment after one window."""
    from qgs_jax.integrators.rk import make_tgls_step, rk4_tableau
    t, traj, exps, vecs = compute_clvs_ginelli(
        f63, Df63, 0., 20., 60., 90., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    traj = np.asarray(traj)
    vecs = np.asarray(vecs)
    a, b, c = rk4_tableau()
    step = make_tgls_step(f63, Df63, a, b, c)
    k = 500
    y = jnp.asarray(traj[:, k][None])
    V = jnp.asarray(vecs[:, :, k][None])
    _, V2 = step((y, V), jnp.asarray(0.0), jnp.asarray(0.01))
    V2 = np.array(V2)[0]
    V2 /= np.linalg.norm(V2, axis=0)
    for j in range(3):
        d = abs(np.dot(V2[:, j], vecs[:, j, k + 1]))
        assert d > 0.999, (j, d)


def test_clvs_subspace_method(attractor_ic):
    out = compute_clvs_subspace(
        f63, Df63, 0., 20., 60., 90., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    t, traj, exps, vecs = out
    mean_exps = np.asarray(exps).mean(axis=-1)
    assert np.allclose(np.sort(mean_exps)[::-1], L63_SPECTRUM, atol=0.6), mean_exps


def test_estimator_classes(attractor_ic):
    est = LyapunovsEstimator()
    est.set_func(f63, Df63)
    est.compute_lyapunovs(0., 20., 60., 0.01, 0.01, attractor_ic[0], write_steps=5)
    t, traj, exps, vecs = est.get_lyapunovs()
    assert np.allclose(exps.mean(axis=-1), L63_SPECTRUM, atol=0.6)

    cest = CovariantLyapunovsEstimator()
    cest.set_func(f63, Df63)
    cest.compute_clvs(0., 20., 50., 70., 0.01, 0.01, attractor_ic[0], write_steps=5)
    t, traj, exps, vecs = cest.get_clvs()
    assert np.isfinite(exps).all()


def test_estimator_partial_tableau(attractor_ic):
    """Constructors must honor b/c without a (round-2 review: `(a, b, c) if
    a is not None else None` silently dropped partial tableaux; the
    reference accepts each coefficient independently, ref
    ``qgs/toolbox/lyapunov.py:41-100,178-205``)."""
    a4, b4, c4 = np.zeros((4, 4)), np.array([1/6, 1/3, 1/3, 1/6]), \
        np.array([0., 0.5, 0.5, 1.])
    a4[1, 0] = a4[2, 1] = 0.5
    a4[3, 2] = 1.

    # a first-order method sharing RK4's a and c: only b differs
    b_euler = np.array([1., 0., 0., 0.])

    for cls in (LyapunovsEstimator, CovariantLyapunovsEstimator):
        est = cls(b=b_euler)
        assert est.tableau is not None, cls.__name__
        ta, tb, tc = est.tableau
        assert np.array_equal(tb, b_euler)
        assert np.array_equal(ta, a4) and np.array_equal(tc, c4)
        # partial set_bca keeps the other coefficients
        est.set_bca(c=c4)
        assert np.array_equal(est.tableau[1], b_euler)
        # set_bca on a default-constructed estimator must also work
        est2 = cls()
        est2.set_bca(b=b_euler)
        assert np.array_equal(est2.tableau[1], b_euler)

    # the custom b must actually be applied: first-order weights give a
    # different trajectory/exponent stream than RK4
    est_rk4 = LyapunovsEstimator()
    est_rk4.set_func(f63, Df63)
    est_rk4.compute_lyapunovs(0., 5., 15., 0.01, 0.01, attractor_ic[0],
                              write_steps=1)
    est_e = LyapunovsEstimator(b=b_euler)
    est_e.set_func(f63, Df63)
    est_e.compute_lyapunovs(0., 5., 15., 0.01, 0.01, attractor_ic[0],
                            write_steps=1)
    assert not np.allclose(est_rk4.get_lyapunovs()[1],
                           est_e.get_lyapunovs()[1]), \
        "partial-tableau b was not applied"

    # ensemble integrators share the same merge semantics
    from qgs_jax.integrators.integrator import (RungeKuttaIntegrator,
                                                RungeKuttaTglsIntegrator)
    for icls in (RungeKuttaIntegrator, RungeKuttaTglsIntegrator):
        integ = icls(b=b_euler)
        assert np.array_equal(integ.b, b_euler)
        assert np.array_equal(integ.a, a4) and np.array_equal(integ.c, c4)
        integ.set_bca(c=c4)
        assert np.array_equal(integ.b, b_euler)


def test_qg_model_lyapunov_spectrum():
    """Lyapunov toolbox driven by the actual QG model (RP atmosphere,
    20-dim): the spectrum must show (a) a positive leading exponent (the
    configuration is chaotic), (b) a near-zero exponent (time-translation
    invariance of the autonomous flow), and (c) a sum equal to the
    time-mean phase-space divergence trace(Df) along the trajectory."""
    import jax.numpy as jnp
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    rng = np.random.default_rng(0)
    ic = rng.random((2, pars.ndim)) * 0.01
    _, ic = integrate_runge_kutta(f.batched, 0., 3000., 0.1, ic, write_steps=0)

    t, traj, exps, vecs = compute_backward_lyapunovs(
        f.batched, Df.batched, 0., 100., 500., 0.1, 0.1, np.asarray(ic),
        write_steps=1)
    mean_exps = np.asarray(exps).mean(axis=-1)

    for b in range(2):
        m = mean_exps[b]
        assert m[0] > 0.03, m[0]                       # chaotic
        assert np.abs(m).min() < 0.01, m               # neutral direction
        assert np.all(np.diff(m) < 0.05), m            # ~descending order
        J = np.asarray(Df.batched(
            0., jnp.asarray(np.moveaxis(np.asarray(traj)[b], -1, 0))))
        divergence = np.trace(J, axis1=1, axis2=2).mean()
        assert abs(m.sum() - divergence) < 0.05, (m.sum(), divergence)


def test_lyapunov_f32_dtype_preserved(attractor_ic):
    """An f32 ensemble must stay f32 end-to-end (no silent promotion to
    f64, which would silently run the slower f64 arithmetic)."""
    import jax.numpy as jnp

    def f32(t, x):
        return f63(t, x.astype(jnp.float32)).astype(jnp.float32)

    def Df32(t, x):
        return Df63(t, x.astype(jnp.float32)).astype(jnp.float32)

    ic32 = np.asarray(attractor_ic, np.float32)
    t, traj, exps, vecs = compute_backward_lyapunovs(
        f32, Df32, 0., 10., 60., 0.01, 0.01, ic32, write_steps=1)
    assert np.asarray(traj).dtype == np.float32
    assert np.asarray(exps).dtype == np.float32
    assert np.asarray(vecs).dtype == np.float32
    mean_exps = np.asarray(exps, np.float64).mean(axis=-1)
    assert np.allclose(mean_exps[0], L63_SPECTRUM, atol=0.5), mean_exps[0]


def test_ginelli_noise_pert(attractor_ic):
    """noise_pert must (a) be a no-op at 0.0, (b) actually perturb the
    backward Ginelli pass when set (round-1 review: it was silently
    ignored), (c) leave a well-conditioned spectrum essentially unchanged
    at small amplitude."""
    args = (f63, Df63, 0., 20., 60., 80., 0.01, 0.01, attractor_ic[:1])
    t0_, _, exps0, vecs0 = compute_clvs_ginelli(*args, write_steps=1)
    _, _, exps0b, vecs0b = compute_clvs_ginelli(*args, write_steps=1,
                                                noise_pert=0.0)
    assert np.array_equal(np.asarray(vecs0), np.asarray(vecs0b))

    _, _, exps1, vecs1 = compute_clvs_ginelli(*args, write_steps=1,
                                              noise_pert=1e-3)
    assert not np.array_equal(np.asarray(vecs0), np.asarray(vecs1)), \
        "noise_pert had no effect"
    # small regularization must not destroy the exponents
    m0 = np.asarray(exps0).mean(axis=-1)
    m1 = np.asarray(exps1).mean(axis=-1)
    assert np.allclose(np.sort(m0), np.sort(m1), atol=0.2)

    # estimator-class plumbing
    cest = CovariantLyapunovsEstimator(noise_pert=1e-3)
    cest.set_func(f63, Df63)
    cest.compute_clvs(0., 20., 50., 70., 0.01, 0.01, attractor_ic[0],
                      write_steps=5)
    _, _, exps, vecs = cest.get_clvs()
    assert np.isfinite(exps).all() and np.isfinite(vecs).all()


def test_clvs_subspace_batch_boundary(attractor_ic):
    """B=1 and B=2 (duplicated IC) must take the same code path and give
    identical CLVs per member (round-1 review: the forward-pass IC switched
    between the state at t0 and the state at ta depending on batch size)."""
    ic1 = attractor_ic[:1]
    ic2 = np.repeat(ic1, 2, axis=0)
    out1 = compute_clvs_subspace(
        f63, Df63, 0., 10., 30., 45., 0.01, 0.01, ic1, write_steps=5)
    out2 = compute_clvs_subspace(
        f63, Df63, 0., 10., 30., 45., 0.01, 0.01, ic2, write_steps=5)
    vecs1 = np.asarray(out1[3])                       # (n, n_vec, T)
    vecs2 = np.asarray(out2[3])                       # (B, n, n_vec, T)
    assert vecs2.shape[0] == 2
    assert np.allclose(vecs2[0], vecs1, atol=1e-10)
    assert np.allclose(vecs2[1], vecs1, atol=1e-10)


def test_qg_clv_cross_method():
    """Ginelli vs subspace-intersection CLVs on the QG model itself: the
    leading vectors must align and the mean exponents agree."""
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    rng = np.random.default_rng(1)
    ic = rng.random((1, pars.ndim)) * 0.01
    _, ic = integrate_runge_kutta(f.batched, 0., 3000., 0.1, ic,
                                  write_steps=0)
    ic = np.atleast_2d(np.asarray(ic))

    # QG spectrum gaps are ~0.01, so convergence spans must be O(100) time
    # units (unlike L63, where 20 suffices)
    tg, _, eg, vg = compute_clvs_ginelli(
        f.batched, Df.batched, 0., 300., 400., 700., 0.1, 0.1, ic,
        write_steps=1)
    ts, _, es, vs = compute_clvs_subspace(
        f.batched, Df.batched, 0., 300., 400., 700., 0.1, 0.1, ic,
        write_steps=1)

    vg = np.asarray(vg)                               # (n, n_vec, T)
    vs = np.asarray(vs)
    T = vg.shape[-1]
    # the method-independent invariant is the Oseledets FLAG: the span of
    # the leading j covariant vectors.  Individual vectors inside a
    # nearly-degenerate exponent block (the QG spectrum has ~0.01 gaps vs
    # finite-span convergence e^(gap * span)) may mix between methods, so
    # compare subspaces by principal angles, not vector-by-vector.
    # a flag boundary is only resolvable when the exponent gap across it
    # is large over the convergence span (gap * span e-foldings); QG has
    # a nearly-degenerate (lambda_2, lambda_3) pair whose internal
    # boundary legitimately differs between methods
    span = 300.0
    m_desc = np.sort(np.asarray(eg).mean(axis=-1))[::-1]
    checked = []
    for j_block in range(1, 6):
        if (m_desc[j_block - 1] - m_desc[j_block]) * span < 5.0:
            continue
        checked.append(j_block)
        for k in range(T // 4, 3 * T // 4 + 1, max(T // 4, 1)):
            qg = np.linalg.qr(vg[:, :j_block, k])[0]
            qs = np.linalg.qr(vs[:, :j_block, k])[0]
            s_min = np.linalg.svd(qg.T @ qs, compute_uv=False).min()
            assert s_min > 0.98, (k, j_block, s_min)
    assert 1 in checked        # the leading vector is always resolvable
    # the leading exponent and the leading-block exponent SUM agree (the
    # sum is invariant under intra-block mixing)
    mg = np.sort(np.asarray(eg).mean(axis=-1))
    ms = np.sort(np.asarray(es).mean(axis=-1))
    assert abs(mg[-1] - ms[-1]) < 0.02, (mg[-1], ms[-1])
    assert abs(mg[-3:].sum() - ms[-3:].sum()) < 0.05, (mg[-3:], ms[-3:])


def test_twofloat_toolbox_precision():
    """Double-float Benettin tier on the QG model vs the f64 oracle (the
    reference's other HOT path, ref ``qgs/toolbox/lyapunov.py:481-613``):
    over spans short enough that chaotic trajectory divergence stays
    bounded, the df-tier mean exponents must track f64 orders of magnitude
    tighter than an all-f32 run (CPU backend strips the EFT barriers, so
    the on-chip agreement is tighter still)."""
    import jax.numpy as jnp
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.ops.contraction import make_tendency_fns

    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df, T = create_tendencies(pars, return_qgtensor=True)
    tensors = (T.tensor, T.jacobian_tensor)

    rng = np.random.default_rng(0)
    ic = rng.random((1, pars.ndim)) * 0.01
    _, ic = integrate_runge_kutta(f.batched, 0., 3000., 0.1, ic, write_steps=0)
    ic = np.atleast_2d(np.asarray(ic))

    f32b, j32b = make_tendency_fns(T.tensor, T.jacobian_tensor,
                                   dtype=jnp.float32)

    args = (0., 10., 40., 0.1, 0.1)
    _, _, e64, _ = compute_backward_lyapunovs(
        f.batched, Df.batched, *args, ic, write_steps=1)
    _, _, edf, _ = compute_backward_lyapunovs(
        f.batched, Df.batched, *args, ic, write_steps=1,
        precision='twofloat', tensors=tensors)
    _, _, e32, _ = compute_backward_lyapunovs(
        f32b, j32b, *args, np.asarray(ic, np.float32), write_steps=1)
    m64 = np.asarray(e64).mean(-1)
    mdf = np.asarray(edf).mean(-1)
    m32 = np.asarray(e32, np.float64).mean(-1)
    err_df = np.abs(m64 - mdf).max()
    err_32 = np.abs(m64 - m32).max()
    assert err_df < 5e-8, err_df                     # measured ~7e-9 on CPU
    assert err_df < err_32 * 0.1, (err_df, err_32)   # measured ~100x tighter

    # df exponents are float64 and the vectors orthonormal
    assert np.asarray(edf).dtype == np.float64
    _, _, _, vdf = compute_backward_lyapunovs(
        f.batched, Df.batched, *args, ic, write_steps=0,
        precision='twofloat', tensors=tensors)
    v = np.asarray(vdf)
    assert np.abs(v.T @ v - np.eye(pars.ndim)).max() < 1e-12

    # forward + Ginelli df paths run and stay glued on short spans
    _, _, fe64, _ = compute_forward_lyapunovs(
        f.batched, Df.batched, 0., 30., 40., 0.1, 0.1, ic, write_steps=1)
    _, _, fedf, _ = compute_forward_lyapunovs(
        f.batched, Df.batched, 0., 30., 40., 0.1, 0.1, ic, write_steps=1,
        precision='twofloat', tensors=tensors)
    assert np.abs(np.asarray(fe64).mean(-1)
                  - np.asarray(fedf).mean(-1)).max() < 1e-6

    tg_, _, ge64, gv64 = compute_clvs_ginelli(
        f.batched, Df.batched, 0., 10., 25., 40., 0.1, 0.1, ic, write_steps=1)
    _, _, gedf, gvdf = compute_clvs_ginelli(
        f.batched, Df.batched, 0., 10., 25., 40., 0.1, 0.1, ic, write_steps=1,
        precision='twofloat', tensors=tensors)
    assert np.abs(np.asarray(ge64).mean(-1)
                  - np.asarray(gedf).mean(-1)).max() < 1e-6
    align = np.abs(np.einsum('nvt,nvt->vt', np.asarray(gv64),
                             np.asarray(gvdf)))
    assert align.min() > 1 - 1e-8, align.min()

    # estimator plumbing: precision='twofloat' through the class API
    est = LyapunovsEstimator(precision='twofloat')
    est.set_func(f, Df)
    est.compute_lyapunovs(*args, ic, write_steps=1)
    m_est = est.get_lyapunovs()[2].mean(-1)
    assert np.allclose(m_est, mdf, atol=1e-12)

    cest = CovariantLyapunovsEstimator(precision='twofloat')
    cest.set_func(f, Df)
    cest.compute_clvs(0., 10., 25., 40., 0.1, 0.1, ic, write_steps=5,
                      method=1)
    _, _, se, sv = cest.get_clvs()
    assert np.isfinite(se).all() and np.isfinite(sv).all()


def test_batched_qr_cholqr2():
    """CholeskyQR2 (the matmul-based re-orthonormalization of the Benettin
    windows) must match Householder QR: orthonormal Q, consistent |diag R|
    (the exponent source), exact reconstruction."""
    from qgs_jax.toolbox.lyapunov import batched_qr

    rng = np.random.default_rng(0)
    m = jnp.asarray(rng.standard_normal((8, 20, 12)))
    # give it some conditioning spread (factors up to ~1e3)
    scale = jnp.asarray(np.logspace(0, 3, 12))
    m = m * scale[None, None, :]

    qc, rc = batched_qr(m, "cholqr2")
    qh, rh = batched_qr(m, "householder")

    eye = np.eye(12)
    assert np.abs(np.asarray(jnp.einsum('bij,bik->bjk', qc, qc))
                  - eye).max() < 1e-12
    assert np.abs(np.asarray(jnp.matmul(qc, rc)) - np.asarray(m)).max() < 1e-9
    dc = np.abs(np.asarray(jnp.diagonal(rc, axis1=-2, axis2=-1)))
    dh = np.abs(np.asarray(jnp.diagonal(rh, axis1=-2, axis2=-1)))
    assert np.abs(dc / dh - 1).max() < 1e-10

    # end-to-end: the L63 spectrum through explicitly-cholqr2 windows
    from qgs_jax.toolbox.lyapunov import make_window_step
    import jax

    win_c = make_window_step(f63, Df63, 0.01, 0.01, qr_method="cholqr2")
    win_h = make_window_step(f63, Df63, 0.01, 0.01, qr_method="householder")
    ic = jnp.asarray([[1., 1., 1.]])
    Q0 = jnp.eye(3)[None]

    def spectrum(win):
        def body(carry, tt):
            (y, Q), R = win(carry, tt)
            return (y, Q), jnp.log(jnp.abs(jnp.diagonal(R, axis1=-2,
                                                        axis2=-1)))
        _, exps = jax.lax.scan(body, (ic, Q0), 0.01 * jnp.arange(5000))
        return np.asarray(exps)[1000:].mean(axis=0) / 0.01

    sc = spectrum(win_c)
    sh = spectrum(win_h)
    assert np.allclose(sc, sh, atol=1e-6), (sc, sh)


def test_toolbox_scan_cache_across_spans(attractor_ic):
    """The compiled-pipeline cache (round-3: runners keyed on model/window
    options with time grids as arguments) must serve DIFFERENT spans and
    batch sizes correctly from one cached executable family — a wrong key
    or a baked-in span would silently corrupt the second call."""
    # same model, three different spans/batches, interleaved
    t1 = compute_backward_lyapunovs(
        f63, Df63, 0., 10., 30., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    t2 = compute_backward_lyapunovs(
        f63, Df63, 0., 5., 45., 0.01, 0.01, attractor_ic, write_steps=1)
    t1b = compute_backward_lyapunovs(
        f63, Df63, 0., 10., 30., 0.01, 0.01, attractor_ic[:1], write_steps=1)
    # repeat of the first call must be bitwise identical
    assert np.array_equal(np.asarray(t1[2]), np.asarray(t1b[2]))
    # shapes reflect the requested spans (2000/4000 windows + 1)
    assert np.asarray(t1[2]).shape[-1] == 2001
    assert np.asarray(t2[2]).shape[-1] == 4001
    # both spans produce the right spectrum
    assert np.allclose(np.asarray(t2[2]).mean(-1)[0], L63_SPECTRUM, atol=0.5)

    # a DIFFERENT dt must not hit the first executable (different window)
    t3 = compute_backward_lyapunovs(
        f63, Df63, 0., 10., 30., 0.02, 0.01, attractor_ic[:1], write_steps=1)
    assert np.asarray(t3[2]).shape[-1] == 1001
    assert np.allclose(np.asarray(t3[2]).mean(-1), L63_SPECTRUM, atol=0.6)

    # ginelli: two spans from the cached pipeline
    g1 = compute_clvs_ginelli(
        f63, Df63, 0., 10., 20., 30., 0.01, 0.01, attractor_ic[:1],
        write_steps=1)
    g2 = compute_clvs_ginelli(
        f63, Df63, 0., 20., 40., 55., 0.01, 0.01, attractor_ic[:1],
        write_steps=1)
    assert np.asarray(g1[3]).shape[-1] == 1001
    assert np.asarray(g2[3]).shape[-1] == 2001
    assert np.isfinite(np.asarray(g2[2])).all()


def test_estimator_honors_custom_fjac():
    """Round-3 review: set_func auto-captures f.qgtensor for the direct
    tangent path — but a user-supplied custom Jacobian function must stay
    honored (the tensors are only used when fjac is the tensor-derived
    Jacobian of the same model)."""
    import jax.numpy as jnp
    from qgs_jax.params.params import QgParams
    from qgs_jax.models.tendencies import create_tendencies

    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    rng = np.random.default_rng(0)
    ic = rng.random((1, pars.ndim)) * 0.01
    _, ic = integrate_runge_kutta(f.batched, 0., 2000., 0.1, ic,
                                  write_steps=0)
    ic = np.atleast_2d(np.asarray(ic))

    def scaled_fjac(t, x):         # a deliberately modified Jacobian
        return 0.5 * Df.batched(t, x)

    est_mod = LyapunovsEstimator()
    est_mod.set_func(f, scaled_fjac)
    assert est_mod._tensors is None          # custom fjac -> no tensor path
    est_mod.compute_lyapunovs(0., 5., 15., 0.1, 0.1, ic, write_steps=1)
    m_mod = est_mod.get_lyapunovs()[2].mean(-1)

    est_std = LyapunovsEstimator()
    est_std.set_func(f, Df)
    assert est_std._tensors is not None      # matching pair -> fast path
    est_std.compute_lyapunovs(0., 5., 15., 0.1, 0.1, ic, write_steps=1)
    m_std = est_std.get_lyapunovs()[2].mean(-1)

    # the estimator's result must equal the functional path run with the
    # SAME custom fjac (and no tensors) — and differ from the model's own
    # Jacobian result
    _, _, e_ref, _ = compute_backward_lyapunovs(
        f.batched, scaled_fjac, 0., 5., 15., 0.1, 0.1, ic, write_steps=1)
    assert np.array_equal(np.asarray(est_mod.get_lyapunovs()[2]),
                          np.asarray(e_ref))
    assert not np.allclose(m_mod, m_std, atol=1e-4), (m_mod, m_std)
