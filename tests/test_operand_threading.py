"""Operand-threading of the contraction kernels: tensor buffers must be
jit *arguments* (not baked program constants), so that

* two same-shape models (different parameter values) share one compiled
  executable — no recompile per configuration (the round-3 sweep paid a
  ~3-minute remote compile per parameter set), and
* the dense matmul path's program size stays independent of the tensor size
  (the round-3 dense path died at ndim 421 on a compile-request limit).

See ``qgs_jax/ops/contraction.py`` (Contraction) and the scan caches in
``qgs_jax/integrators/rk.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from qgs_jax.integrators import rk
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.params.params import QgParams


def _maooam_params(kd):
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': kd, 'kdp': kd, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


@pytest.fixture(scope="module")
def two_models():
    fa, Dfa, ta = create_tendencies(_maooam_params(0.0290),
                                    return_qgtensor=True)
    fb, Dfb, tb = create_tendencies(_maooam_params(0.0350),
                                    return_qgtensor=True)
    return (fa, Dfa, ta), (fb, Dfb, tb)


def test_same_shape_models_share_apply_and_key(two_models):
    (fa, Dfa, _), (fb, Dfb, _) = two_models
    assert fa.key == fb.key
    assert fa.apply is fb.apply, \
        "same-structure models must share the cached apply function"
    assert Dfa.key == Dfb.key
    # operands differ (the parameter values live there)
    va = np.concatenate([np.asarray(b["V"])
                         for g in fa.batched.operands["groups"]
                         for b in g["buckets"]])
    vb = np.concatenate([np.asarray(b["V"])
                         for g in fb.batched.operands["groups"]
                         for b in g["buckets"]])
    assert not np.array_equal(va, vb)


def test_no_new_scan_compile_for_second_model(two_models):
    """The second model's integration must reuse the first's compiled scan
    (structural cache key) while producing its own — correct — result."""
    (fa, _, _), (fb, _, _) = two_models
    x0 = np.full((2, 36), 0.01)

    _, ya = rk.integrate_runge_kutta(fa.batched, 0., 1., 0.1, x0,
                                     write_steps=0)
    n_entries = len(rk._SCAN_CACHE)
    _, yb = rk.integrate_runge_kutta(fb.batched, 0., 1., 0.1, x0,
                                     write_steps=0)
    assert len(rk._SCAN_CACHE) == n_entries, \
        "same-shape model must not add a scan-cache entry"

    # and the shared executable still computes model-B physics
    assert not np.allclose(np.asarray(ya), np.asarray(yb))
    fb_direct = np.asarray(fb.batched(0., jnp.asarray(x0)))
    fa_direct = np.asarray(fa.batched(0., jnp.asarray(x0)))
    assert not np.allclose(fa_direct, fb_direct)
    # one explicit RK4 step cross-check against the shared-scan result
    _, y1 = rk.integrate_runge_kutta(fb.batched, 0., 0.1, 0.1, x0,
                                     write_steps=0)
    a, b, c = rk.rk4_tableau()
    step = rk.make_rk_step(fb.batched, a, b, c)
    y_ref = step(jnp.asarray(x0), 0.0, 0.1)
    assert np.allclose(np.asarray(y1), np.asarray(y_ref), rtol=1e-12)


def test_dense_mode_threads_tensor_as_argument(two_models):
    """The dense path must place the matricized tensor in the operands
    pytree (a device argument), not close over it — and agree with the
    rowsum path."""
    from qgs_jax.ops.contraction import make_tendency_fns

    (_, _, ta), _ = two_models
    f_dense, jac_dense = make_tendency_fns(ta.tensor, ta.jacobian_tensor,
                                           mode="dense")
    f_row, _ = make_tendency_fns(ta.tensor, ta.jacobian_tensor,
                                 mode="rowsum")
    assert "T2T" in f_dense.operands
    n1 = ta.tensor.shape[0]
    assert f_dense.operands["T2T"].shape == (n1 * n1, n1)

    rng = np.random.default_rng(0)
    x = rng.random((3, 36)) * 0.05
    assert np.allclose(np.asarray(f_dense(0., jnp.asarray(x))),
                       np.asarray(f_row(0., jnp.asarray(x))),
                       rtol=1e-12, atol=1e-14)


def test_df_scan_shares_executable_across_models(two_models):
    """The double-float integrator's compiled scan must be shared between
    same-layout models (the structural 'df_scan_exec' cache entry)."""
    (_, _, ta), (_, _, tb) = two_models
    x0 = np.full((2, 36), 0.01)

    rk.integrate_runge_kutta_df(ta.tensor, 0., 1., 0.1, x0, write_steps=0)
    n_exec = sum(1 for k in rk._SCAN_CACHE
                 if isinstance(k, tuple) and k[-1] == 'df_scan_exec')
    _, yb = rk.integrate_runge_kutta_df(tb.tensor, 0., 1., 0.1, x0,
                                        write_steps=0)
    n_exec2 = sum(1 for k in rk._SCAN_CACHE
                  if isinstance(k, tuple) and k[-1] == 'df_scan_exec')
    assert n_exec2 == n_exec, \
        "same-layout df models must share one compiled scan"
    assert np.all(np.isfinite(np.asarray(yb)))


def test_direct_tangent_variants_share_key(two_models):
    """adjoint/inverse live purely in operand values: every variant of the
    same shape shares one compiled program."""
    from qgs_jax.ops.contraction import make_direct_tangent

    (_, _, ta), _ = two_models
    plain = make_direct_tangent(ta.jacobian_tensor)
    adj = make_direct_tangent(ta.jacobian_tensor, adjoint=True)
    inv = make_direct_tangent(ta.jacobian_tensor, inverse=True)
    assert plain.key == inv.key
    assert plain.apply is inv.apply
    # adjoint may drop a different entry count; if the counts match the
    # key (and executable) is shared too
    if adj.key == plain.key:
        assert adj.apply is plain.apply
    # inverse really negates
    rng = np.random.default_rng(1)
    xx = np.concatenate([np.ones((2, 1)), rng.random((2, 36)) * 0.05],
                        axis=1)
    dm = rng.standard_normal((2, 36, 4))
    got_p = np.asarray(plain(jnp.asarray(xx), jnp.asarray(dm)))
    got_i = np.asarray(inv(jnp.asarray(xx), jnp.asarray(dm)))
    assert np.allclose(got_p, -got_i, rtol=1e-12)


def test_tgls_twofloat_rejects_custom_fjac(two_models):
    """ADVICE r03: a custom fjac with precision='twofloat' must raise (the
    fused step contracts the model's own jacobian tensor and would silently
    ignore the custom one)."""
    from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator

    (fa, Dfa, _), _ = two_models

    def custom_fjac(t, x):
        return Dfa(t, x) * 2.0

    integ = RungeKuttaTglsIntegrator(precision="twofloat")
    integ.set_func(fa, custom_fjac)
    x0 = np.full(36, 0.01)
    with pytest.raises(RuntimeError, match="custom fjac"):
        integ.integrate(0., 0.2, 0.1, ic=x0, tg_ic=np.eye(36))

    # the model's own fjac stays accepted
    integ2 = RungeKuttaTglsIntegrator(precision="twofloat")
    integ2.set_func(fa, Dfa)
    integ2.integrate(0., 0.2, 0.1, ic=x0, tg_ic=np.eye(36))
    t, traj, fmat = integ2.get_trajectories()
    assert np.all(np.isfinite(np.asarray(fmat)))


def test_rowsum_feature_major_matches(two_models):
    """Feature-major gathers (rows of the transposed state) must be
    arithmetically identical to the batch-major layout."""
    import jax.numpy as jnp
    from qgs_jax.ops.contraction import make_rowsum_contraction

    (_, _, ta), _ = two_models
    T = ta.tensor
    rng = np.random.default_rng(2)
    xx = rng.random((5, T.shape[0])) * 0.1
    xx[:, 0] = 1.0
    bm = np.asarray(make_rowsum_contraction(T)(jnp.asarray(xx)))
    fm = np.asarray(make_rowsum_contraction(
        T, feature_major=True)(jnp.asarray(xx)))
    assert np.allclose(bm, fm, rtol=1e-13, atol=1e-15)


def test_bucketed_contraction_matches_rowsum(two_models):
    """The count-bucketed (padding-free) kernel must reproduce the rowsum
    contraction on the MAOOAM tensor."""
    import jax.numpy as jnp
    from qgs_jax.ops.contraction import (make_bucketed_contraction,
                                         make_rowsum_contraction)

    (_, _, ta), _ = two_models
    T = ta.tensor
    rng = np.random.default_rng(3)
    xx = rng.random((5, T.shape[0])) * 0.1
    xx[:, 0] = 1.0
    ref = np.asarray(make_rowsum_contraction(T)(jnp.asarray(xx)))
    got = np.asarray(make_bucketed_contraction(T)(jnp.asarray(xx)))
    assert np.allclose(got, ref, rtol=1e-12, atol=1e-14)
    # no padding: total slot count equals nnz exactly
    c = make_bucketed_contraction(T)
    slots = sum(b["V"].shape[0] for g in c.operands["groups"]
                for b in g["buckets"])
    assert slots == T.nnz


def test_bucket_ladder_quantization_bit_identical(two_models):
    """The DP-placed count ladder (any max_buckets) only ADDS zero slots
    at the end of each row's reduction, so results must be BIT-identical
    to the exact (one bucket per distinct count) layout, while total
    padding stays bounded; the ladder must also never exceed its budget."""
    import jax
    import jax.numpy as jnp
    from qgs_jax.ops.contraction import (_active_index_groups,
                                         _count_thresholds, _bucketed_layout,
                                         make_bucketed_contraction,
                                         jit_contraction)

    import os

    (_, _, ta), _ = two_models
    T = ta.tensor
    rng = np.random.default_rng(3)
    xx = jnp.asarray(rng.random((5, T.shape[0])) * 0.1)

    saved = os.environ.get("QGS_BUCKET_MAX")
    try:
        # the exact baseline must not depend on the ambient ladder setting
        os.environ["QGS_BUCKET_MAX"] = "1000000"
        exact = np.asarray(jit_contraction(make_bucketed_contraction(T))(xx))
        groups, _, _ = _active_index_groups(T, False)
        for K in (2, 3, 5):
            # force quantization (MAOOAM has ~10 distinct counts per group)
            for d_eff, g_rows, g_data, idx_cols in groups:
                counts = np.bincount(g_rows, minlength=T.shape[0])
                thr = _count_thresholds(counts, K)
                assert len(thr) <= K
                assert max(thr) >= counts.max()
                buckets, _ = _bucketed_layout(g_rows, g_data, list(idx_cols),
                                              T.shape[0], max_buckets=K)
                assert len(buckets) <= K
            os.environ["QGS_BUCKET_MAX"] = str(K)
            got = np.asarray(jit_contraction(make_bucketed_contraction(T))(xx))
            assert np.array_equal(got, exact), K
    finally:
        if saved is None:
            os.environ.pop("QGS_BUCKET_MAX", None)
        else:
            os.environ["QGS_BUCKET_MAX"] = saved


def test_tgls_twofloat_accepts_rebuilt_jacobian(two_models):
    """A Jacobian rebuilt from the SAME parameters (value-equal tensors,
    different objects) must be accepted by the twofloat guard — only a
    numerically different fjac is 'custom'."""
    from qgs_jax.integrators.integrator import RungeKuttaTglsIntegrator

    (fa, _, _), _ = two_models
    fa2, Dfa2, _ = create_tendencies(_maooam_params(0.0290),
                                     return_qgtensor=True)
    assert fa2.qgtensor is not fa.qgtensor     # genuinely distinct objects
    integ = RungeKuttaTglsIntegrator(precision="twofloat")
    integ.set_func(fa, Dfa2)                   # cross-build pairing
    x0 = np.full(36, 0.01)
    integ.integrate(0., 0.2, 0.1, ic=x0, tg_ic=np.eye(36))
    _, traj, fmat = integ.get_trajectories()
    assert np.all(np.isfinite(np.asarray(fmat)))


def test_unknown_mode_raises(two_models):
    from qgs_jax.ops.contraction import make_tendency_fns

    (_, _, ta), _ = two_models
    with pytest.raises(ValueError, match="unknown contraction mode"):
        make_tendency_fns(ta.tensor, ta.jacobian_tensor, mode="bucketd")
