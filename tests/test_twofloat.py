"""Double-float (two-float32) arithmetic and contraction: error-free
transformation correctness and contraction accuracy vs float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgs_jax.ops.twofloat import (
    two_sum, two_prod, split, df_add, df_mul, df_from_f64, df_to_f64,
    make_df_quadratic, make_df_rk4_step,
)
from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies


@pytest.fixture(scope="module")
def maooam():
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.029, 'kdp': 0.029, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True)
    return pars, f, tensor


def test_error_free_transforms():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    b = jnp.asarray(rng.standard_normal(4096), jnp.float32)

    s, e = two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    assert np.abs(np.asarray(s, np.float64) + np.asarray(e, np.float64)
                  - exact).max() == 0.0

    p, e = two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    assert np.abs(np.asarray(p, np.float64) + np.asarray(e, np.float64)
                  - exact).max() == 0.0

    hi, lo = split(a)
    assert np.abs(np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
                  - np.asarray(a, np.float64)).max() == 0.0


def test_df_roundtrip_and_ops():
    rng = np.random.default_rng(1)
    a64 = rng.standard_normal(1000)
    b64 = rng.standard_normal(1000)
    a = df_from_f64(jnp.asarray(a64))
    b = df_from_f64(jnp.asarray(b64))
    assert np.abs(np.asarray(df_to_f64(a)) - a64).max() < 1e-14

    s = np.asarray(df_to_f64(df_add(a, b)))
    assert np.abs(s - (a64 + b64)).max() < 1e-13
    p = np.asarray(df_to_f64(df_mul(a, b)))
    assert np.abs(p - a64 * b64).max() < 1e-13


def test_df_contraction_accuracy(maooam):
    pars, f, tensor = maooam
    rng = np.random.default_rng(2)
    B = 16
    x = rng.random((B, pars.ndim)) * 0.05
    xx = np.concatenate([np.ones((B, 1)), x], axis=1)

    quad = make_df_quadratic(tensor.tensor)
    out = jax.jit(quad)(df_from_f64(jnp.asarray(xx)))
    fx_df = np.asarray(df_to_f64(out))[:, 1:]
    fx_64 = np.asarray(f.batched(0., jnp.asarray(x)))
    # absolute criterion: several tendency components are ~1e-6 with heavy
    # cancellation, so a relative bound only measures the denominator.  On
    # the CPU backend (which strips the EFT barriers) the bucketed layout
    # achieves ~2e-12 absolute; tests/test_gpu.py holds the card to 1e-12
    # after 100 full RK4 steps.
    assert np.abs(fx_df - fx_64).max() < 5e-12, np.abs(fx_df - fx_64).max()

    # f32 for contrast: ~6 orders of magnitude worse
    fx_32 = np.asarray(f.batched(0., jnp.asarray(x, jnp.float32)))
    rel32 = np.abs(fx_32 - fx_64) / (np.abs(fx_64) + 1e-10)
    assert rel32.max() > 1e-8


def test_df_contraction_any_row_width():
    """Regression: rows whose nnz count is not a power of two (e.g. the
    4x4/4x4 MAOOAM truncation, max 24 per row) must reduce exactly — the
    old tree assumed power-of-two widths and mis-shaped/dropped lanes."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(4, 4)
    pars.set_oceanic_basin_fourier_modes(4, 4)
    pars.set_params({'kd': 0.029, 'kdp': 0.029, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    _, _, tensor = create_tendencies(pars, return_qgtensor=True)
    T = tensor.tensor
    counts = np.bincount(np.asarray(T.coords[0]), minlength=T.shape[0])
    assert counts.max() & (counts.max() - 1), "config no longer exercises odd widths"

    rng = np.random.default_rng(5)
    x = rng.random((4, pars.ndim + 1)) * 0.1
    x[:, 0] = 1.0
    ref = np.einsum('ijk,bj,bk->bi', np.asarray(T.todense()), x, x)
    for accumulate in ("strict", "fast"):
        quad = make_df_quadratic(T, accumulate=accumulate)
        out = np.asarray(df_to_f64(jax.jit(quad)(df_from_f64(jnp.asarray(x)))))
        rel = np.abs(out - ref).max() / np.abs(ref).max()
        # 'fast' carries the CPU-backend barrier-stripping penalty (~1e-8)
        # (see make_df_quadratic docstring)
        assert rel < (1e-12 if accumulate == "strict" else 1e-6), (accumulate, rel)


def test_df_rk4_trajectory(maooam):
    from qgs_jax.integrators.rk import integrate_runge_kutta
    pars, f, tensor = maooam
    rng = np.random.default_rng(3)
    x = rng.random((4, pars.ndim)) * 0.05

    step = make_df_rk4_step(tensor.tensor, 0.1)

    @jax.jit
    def run(y):
        return jax.lax.fori_loop(0, 1000, lambda i, y: step(y), y)

    y_df = np.asarray(df_to_f64(run(df_from_f64(jnp.asarray(x)))))
    _, y64 = integrate_runge_kutta(f.batched, 0., 100., 0.1, x, write_steps=0)
    assert np.abs(y_df - np.asarray(y64)).max() < 1e-8


def test_df_tangent_contraction_exact(maooam):
    """The df tangent contraction must reproduce the dense f64 J(x) @ dm
    product at (near-)machine level for a single evaluation — adjoint and
    inverse variants included (ref ``qgs/integrators/integrate.py:227-231``)."""
    from qgs_jax.ops.twofloat import make_df_tangent_contraction

    pars, f, tensor = maooam
    from qgs_jax.ops.contraction import make_tendency_fns
    _, jac_b = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor)

    rng = np.random.default_rng(6)
    B, n = 4, pars.ndim
    x = rng.random((B, n)) * 0.05
    xx = np.concatenate([np.ones((B, 1)), x], axis=1)
    dm = rng.standard_normal((B, n, n))
    J = np.asarray(jac_b(0., jnp.asarray(x)))

    for adjoint in (False, True):
        for inverse in (False, True):
            hom = make_df_tangent_contraction(tensor.jacobian_tensor,
                                              adjoint=adjoint, inverse=inverse)
            out = jax.jit(hom)(df_from_f64(jnp.asarray(xx)),
                               df_from_f64(jnp.asarray(dm)))
            got = np.asarray(df_to_f64(out))
            sign = -1.0 if inverse else 1.0
            if adjoint:
                ref = sign * np.einsum('bnm,bnt->bmt', J, dm)
            else:
                ref = sign * np.einsum('bnm,bmt->bnt', J, dm)
            err = np.abs(got - ref).max()
            assert err < 1e-12, (adjoint, inverse, err)


def test_df_tgls_integration(maooam):
    """Fused df TGLS RK4 vs the f64 oracle over 100 steps: trajectory and
    fundamental matrix must track far below f32 accuracy (CPU backend
    strips the EFT barriers -> ~1e-9 absolute here)."""
    from qgs_jax.integrators.rk import (integrate_runge_kutta,
                                        integrate_runge_kutta_tgls,
                                        integrate_runge_kutta_tgls_df)

    pars, f, tensor = maooam
    from qgs_jax.ops.contraction import make_tendency_fns
    _, jac_b = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor)

    rng = np.random.default_rng(7)
    ic = rng.random((2, pars.ndim)) * 0.05
    _, ic = integrate_runge_kutta(f.batched, 0., 200., 0.1, ic, write_steps=0)
    ic = np.asarray(ic)
    tg = np.eye(pars.ndim)

    for adjoint in (False, True):
        _, tr64, fm64 = integrate_runge_kutta_tgls(
            f.batched, jac_b, 0., 10., 0.1, ic, tg, adjoint=adjoint,
            write_steps=0)
        _, trdf, fmdf = integrate_runge_kutta_tgls_df(
            tensor.tensor, tensor.jacobian_tensor, 0., 10., 0.1, ic, tg,
            adjoint=adjoint, write_steps=0)
        e_tr = np.abs(np.asarray(tr64) - np.asarray(trdf)).max()
        e_fm = np.abs(np.asarray(fm64) - np.asarray(fmdf)).max()
        assert e_tr < 1e-7 and e_fm < 1e-6, (adjoint, e_tr, e_fm)

    # f32 contrast on the same workload: the fundamental matrix drifts
    # orders of magnitude more
    f32b, j32b = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                                   dtype=jnp.float32)
    _, tr32, fm32 = integrate_runge_kutta_tgls(
        f32b, j32b, 0., 10., 0.1, np.asarray(ic, np.float32),
        np.asarray(tg, np.float32), write_steps=0)
    _, tr64, fm64 = integrate_runge_kutta_tgls(
        f.batched, jac_b, 0., 10., 0.1, ic, tg, write_steps=0)
    _, trdf, fmdf = integrate_runge_kutta_tgls_df(
        tensor.tensor, tensor.jacobian_tensor, 0., 10., 0.1, ic, tg,
        write_steps=0)
    err32 = np.abs(np.asarray(fm32, np.float64) - np.asarray(fm64)).max()
    errdf = np.abs(np.asarray(fmdf) - np.asarray(fm64)).max()
    assert errdf < err32 * 1e-2, (errdf, err32)


def test_df_tgls_integrator_class(maooam):
    """RungeKuttaTglsIntegrator(precision='twofloat') end-to-end plumbing."""
    from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator
    from qgs_jax.integrators.rk import integrate_runge_kutta

    pars, f, tensor = maooam
    from qgs_jax.models.tendencies import create_tendencies as _ct
    rng = np.random.default_rng(8)
    ic = rng.random((2, pars.ndim)) * 0.05
    _, ic = integrate_runge_kutta(f.batched, 0., 100., 0.1, ic, write_steps=0)
    ic = np.asarray(ic)

    # needs Df too — rebuild the (f, Df) PAIR so they share one qgtensor
    # (a jacobian built separately is treated as a custom fjac and
    # rejected by the twofloat guard, see test_operand_threading)
    f2, fjac, _ = _ct(pars, return_qgtensor=True)
    f = f2
    integ = RungeKuttaTglsIntegrator(precision="twofloat")
    integ.set_func(f, fjac)
    integ.integrate(0., 5., 0.1, ic=ic, tg_ic=np.eye(pars.ndim), write_steps=5)
    t, traj, fmat = integ.get_trajectories()
    assert np.isfinite(np.asarray(traj)).all()
    assert np.isfinite(np.asarray(fmat)).all()
    assert np.asarray(traj).dtype == np.float64

    oracle = RungeKuttaTglsIntegrator()
    oracle.set_func(f, fjac)
    oracle.integrate(0., 5., 0.1, ic=ic, tg_ic=np.eye(pars.ndim), write_steps=5)
    _, traj64, fmat64 = oracle.get_trajectories()
    assert np.abs(np.asarray(traj) - np.asarray(traj64)).max() < 1e-7
    assert np.abs(np.asarray(fmat) - np.asarray(fmat64)).max() < 1e-6


def test_cholqr_df(maooam):
    """Mixed-precision CholeskyQR for the double-float Benettin windows:
    R and Q accurate to ~eps32^2 per factorization (unit check), and the
    window pipeline's exponent stream must track the f64-Householder
    reference (CPU strict-mode df carries ~1e-11/op barrier-stripping
    noise, so the 400-window tolerance here is loose)."""
    from qgs_jax.ops.twofloat import cholqr_df
    from qgs_jax.toolbox.lyapunov import make_window_step_df
    from qgs_jax.integrators.rk import integrate_runge_kutta

    rng = np.random.default_rng(0)
    Qb = np.linalg.qr(rng.standard_normal((4, 20, 20)))[0]
    M64 = Qb * np.exp(rng.standard_normal((4, 1, 20)) * 0.2)
    Q, R64 = jax.jit(cholqr_df)(df_from_f64(jnp.asarray(M64)))
    Q64 = np.asarray(df_to_f64(Q))
    R = np.asarray(R64)
    Qr, Rr = np.linalg.qr(M64)
    dref = np.abs(np.diagonal(Rr, axis1=-2, axis2=-1))
    dgot = np.abs(np.diagonal(R, axis1=-2, axis2=-1))
    assert np.abs(dgot / dref - 1).max() < 1e-12
    assert np.abs(np.einsum('bij,bik->bjk', Q64, Q64)
                  - np.eye(20)).max() < 1e-12
    assert (np.abs(np.einsum('bij,bjk->bik', Q64, R) - M64).max()
            / np.abs(M64).max()) < 1e-12

    pars, f, tensor = maooam
    ic = rng.random((1, pars.ndim)) * 0.05
    _, ic = integrate_runge_kutta(f.batched, 0., 200., 0.1, ic,
                                  write_steps=0)
    ic = np.atleast_2d(np.asarray(ic))
    n = pars.ndim
    Q0_np = np.linalg.qr(np.random.default_rng(1).random((n, n)))[0]

    def run_variant(qr):
        win = make_window_step_df(tensor.tensor, tensor.jacobian_tensor,
                                  0.1, 0.1, qr_method=qr)

        @jax.jit
        def run(y0, Q0):
            def body(carry, _):
                (y, Q), R = win(carry, 0.0)
                return (y, Q), jnp.log(jnp.abs(
                    jnp.diagonal(R, axis1=-2, axis2=-1)))

            _, logs = jax.lax.scan(body, (y0, Q0), None, length=200)
            return logs

        logs = np.asarray(run(
            df_from_f64(jnp.asarray(ic)),
            df_from_f64(jnp.asarray(
                np.broadcast_to(Q0_np[None], (1, n, n)).copy()))))
        return logs.mean(axis=0)[0] / 0.1

    d = np.abs(run_variant("householder") - run_variant("mixed")).max()
    assert d < 2e-8, d


def test_df_arbitrary_tableau(maooam):
    """VERDICT r03 #8: the double-float tier must accept any explicit
    Butcher tableau (the reference integrates arbitrary tableaux at full
    precision, ref ``qgs/integrators/integrate.py:29``).  RK2 (Heun) df
    vs ambient-f64 RK2 over 50 steps."""
    from qgs_jax.integrators.rk import (integrate_runge_kutta,
                                        integrate_runge_kutta_df,
                                        rk2_tableau)

    pars, f, tensor = maooam
    rng = np.random.default_rng(11)
    x0 = rng.random((3, pars.ndim)) * 0.05
    a2, b2, c2 = rk2_tableau()

    _, y64 = integrate_runge_kutta(f.batched, 0., 5., 0.1, x0,
                                   write_steps=0, a=a2, b=b2, c=c2)
    _, ydf = integrate_runge_kutta_df(tensor.tensor, 0., 5., 0.1, x0,
                                      write_steps=0, squeeze=False,
                                      a=a2, b=b2, c=c2)
    err = np.abs(np.asarray(ydf) - np.asarray(y64)).max()
    assert err < 1e-9, err
    # RK2 and RK4 genuinely differ (the tableau is honored, not ignored)
    _, y4 = integrate_runge_kutta_df(tensor.tensor, 0., 5., 0.1, x0,
                                     write_steps=0, squeeze=False)
    assert np.abs(np.asarray(y4) - np.asarray(ydf)).max() > 1e-6


def test_df_integrator_rk2_precision_twofloat(maooam):
    """RungeKuttaIntegrator(precision='twofloat') with a non-RK4 tableau
    (formerly rejected); implicit tableaux still raise."""
    from qgs_jax.integrators.integrator import RungeKuttaIntegrator
    from qgs_jax.integrators.rk import rk2_tableau

    pars, f, tensor = maooam
    a2, b2, c2 = rk2_tableau()
    integ = RungeKuttaIntegrator(a=a2, b=b2, c=c2, precision="twofloat")
    integ.set_func(f)
    x0 = np.full(pars.ndim, 0.01)
    integ.integrate(0., 1., 0.1, ic=x0, write_steps=0)
    _, y = integ.get_trajectories()
    assert np.all(np.isfinite(np.asarray(y)))

    # implicit (non-strictly-lower-triangular a) must be rejected clearly
    a_imp = np.array([[0.5]])
    integ2 = RungeKuttaIntegrator(a=a_imp, b=np.array([1.0]),
                                  c=np.array([0.5]), precision="twofloat")
    integ2.set_func(f)
    with pytest.raises(ValueError, match="explicit"):
        integ2.integrate(0., 1., 0.1, ic=x0, write_steps=0)


def test_df_batch_chunking_padded_and_scaled(maooam):
    """Batch chunking past the chunk threshold: odd batches are
    zero-padded to equal lax.map chunks (not silently unchunked), results
    match the unchunked program to the backend's EFT noise, and a
    mesh-sharded run scales the per-device knee by batch_devices (here 8
    virtual devices x 4096 > B, so the program stays unchunked)."""
    import os
    from qgs_jax.integrators.rk import integrate_runge_kutta_df

    pars, f, tensor = maooam
    rng = np.random.default_rng(0)
    ic = rng.random((130, pars.ndim)) * 0.01   # odd B, > tiny chunk

    saved = os.environ.get("QGS_DF_BATCH_CHUNK")
    try:
        os.environ["QGS_DF_BATCH_CHUNK"] = "64"   # force k=3 chunks of 44
        _, y1 = integrate_runge_kutta_df(tensor.tensor, 0., 0.5, 0.1, ic,
                                         write_steps=0)
        os.environ["QGS_DF_BATCH_CHUNK"] = "0"
        _, y2 = integrate_runge_kutta_df(tensor.tensor, 0., 0.5, 0.1, ic,
                                         write_steps=0)
        d = np.abs(np.asarray(y1) - np.asarray(y2)).max()
        assert np.isfinite(np.asarray(y1)).all()
        # identical per-member arithmetic; the CPU backend's stripped EFT
        # barriers leave fusion-level noise, far below trajectory scale
        assert d < 1e-9, d

        # batch_devices scales the knee: with 8 "devices" the global
        # threshold is 512 >= B, so the chunked and plain programs agree
        # exactly in shape handling (finite, same result class)
        os.environ["QGS_DF_BATCH_CHUNK"] = "64"
        _, y3 = integrate_runge_kutta_df(tensor.tensor, 0., 0.5, 0.1, ic,
                                         write_steps=0, batch_devices=8)
        assert np.isfinite(np.asarray(y3)).all()
        assert np.abs(np.asarray(y3) - np.asarray(y2)).max() < 1e-9
    finally:
        if saved is None:
            os.environ.pop("QGS_DF_BATCH_CHUNK", None)
        else:
            os.environ["QGS_DF_BATCH_CHUNK"] = saved
