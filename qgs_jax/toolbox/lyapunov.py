"""
Lyapunov toolbox
================

Backward/Forward Lyapunov vectors & exponents (Benettin QR algorithm) and
Covariant Lyapunov vectors (Ginelli et al. 2007, and the BLV/FLV subspace
intersection method), re-designed for batched device execution
(ref ``/root/reference/qgs/toolbox/lyapunov.py:41-1333``):

* the whole ensemble of trajectories is batched — ``jnp.linalg.qr`` / ``svd``
  are natively batched, replacing the reference's per-trajectory Python
  process pool;
* the window / substep structure is a nested ``lax.scan`` (outer scan over
  QR windows of length ``dt``, inner scan over tangent substeps ``mdt``),
  compiled once;
* the Ginelli backward pass is a reverse scan over the stored R matrices
  with batched triangular solves.

Conventions: ``dt`` must be an integer multiple of ``mdt`` and the span
lengths integer multiples of ``dt`` (the reference's own examples satisfy
this; it keeps every scan shape static).

Shapes: trajectories (B, n); vector blocks (B, n, n_vec); outputs follow
the reference layout (B, n, [n_vec,] n_records) squeezed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import NamedSharding, PartitionSpec as P

from qgs_jax.utils.backend import backend_policy
from qgs_jax.integrators.rk import (_scan_cache_get, _tableau_key,
                                    make_rk_step, make_tgls_step,
                                    merge_tableau, rk4_tableau)


def _window_key(df_mode, f, fjac, tensors, dt, mdt, tableau, adjoint,
                inverse):
    """Cache key identifying a compiled window pipeline (strong refs to
    the tendency functions / tensors — see the rk.py scan-cache notes)."""
    tb = _tableau_key(*(tableau if tableau is not None else rk4_tableau()))
    if df_mode:
        return ('df', tensors[0], tensors[1], dt, mdt, tb, adjoint, inverse)
    tkey = tensors[1] if tensors is not None else None
    return (f, fjac, tkey, dt, mdt, tb, adjoint, inverse)


def _shard_ic(mesh, ic):
    """Shard a (B, n) IC batch over the mesh's ensemble axis (padding the
    batch if needed).  Returns ``(ic, n_orig, put)`` where ``put(x, k)``
    device-puts ``x`` with its axis ``k`` sharded over 'ensemble' (the
    mesh analogue of the reference's pool-parallel estimators,
    ref ``qgs/toolbox/lyapunov.py:155,816``)."""
    if mesh is None or mesh.devices.size <= 1 or ic.shape[0] < mesh.devices.size:
        return ic, ic.shape[0], lambda x, k=0: x
    from qgs_jax.parallel.mesh import shard_ensemble

    ic, n_orig = shard_ensemble(ic, mesh)

    def put(x, k=0):
        spec = [None] * x.ndim
        spec[k] = "ensemble"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return ic, n_orig, put


def _n_windows(t0, t1, dt):
    n = int(round((t1 - t0) / dt))
    assert abs(n * dt - (t1 - t0)) < 1e-9 * max(1.0, abs(t1 - t0)), \
        "span must be an integer multiple of dt"
    return n


def _n_sub(dt, mdt):
    n = int(round(dt / mdt))
    assert abs(n * mdt - dt) < 1e-12 + 1e-9 * dt, "dt must be a multiple of mdt"
    return n


def _normalize_columns(m):
    """Normalize matrix columns; return (normalized, norms)."""
    norms = jnp.linalg.norm(m, axis=-2)
    return m / norms[..., None, :], norms


def _cholqr(m):
    """One Cholesky-QR pass: ``m = Q R`` via ``R^T R = m^T m``.

    The Gram matmul and the triangular solve are batched matrix work,
    unlike Householder QR's sequential reflector loop.  HIGHEST precision
    on the Gram matrix: a reduced-precision product (TF32 at DEFAULT
    precision on a GPU) would destroy the ~1e-7 exponent accuracy the f32
    tier promises."""
    g = jnp.matmul(jnp.swapaxes(m, -1, -2), m,
                   precision=jax.lax.Precision.HIGHEST)
    L = jnp.linalg.cholesky(g)                          # g = L L^T, R = L^T
    q = jnp.swapaxes(
        jax.scipy.linalg.solve_triangular(L, jnp.swapaxes(m, -1, -2),
                                          lower=True), -1, -2)
    return q, jnp.swapaxes(L, -1, -2)


def batched_qr(m, method="auto"):
    """Batched thin QR of ``(..., n, k)`` stacks for the Benettin windows.

    ``method='cholqr2'`` runs two Cholesky-QR passes (CholeskyQR2:
    orthogonality to machine eps for the well-conditioned propagated
    blocks a QR cadence produces — cond grows only like
    exp((lambda_1 - lambda_n) dt) per window); ``'householder'`` is
    ``jnp.linalg.qr``.  ``'auto'`` is Householder everywhere; cholqr2
    stays as an opt-in for larger blocks.  Note cholqr2 fixes
    diag(R) > 0 (a canonical sign choice; Householder may flip column
    signs — exponents use log|diag R| either way)."""
    if method == "auto":
        method = "householder"
    if method == "householder":
        return jnp.linalg.qr(m)
    q1, r1 = _cholqr(m)
    q, r2 = _cholqr(q1)
    return q, jnp.matmul(r2, r1, precision=jax.lax.Precision.HIGHEST)


# pytree record helpers: states are plain arrays in the ambient-dtype path
# and (hi, lo) float32 pairs in the twofloat path — these treat both
# uniformly (a plain array is a single-leaf tree)
_tmap = jax.tree_util.tree_map


def _tappend(recs, last):
    return _tmap(lambda r, l: jnp.concatenate([r, l[None]], axis=0), recs, last)


def _tprepend(first, recs):
    return _tmap(lambda f_, r: jnp.concatenate([f_[None], r], axis=0), first, recs)


def _tindex(tree, idx):
    return _tmap(lambda x: x[idx], tree)


def _check_df_args(tensors, tableau):
    if tensors is None:
        raise ValueError(
            "precision='twofloat' needs tensors=(tendency_tensor, "
            "jacobian_tensor) — e.g. (f.qgtensor.tensor, "
            "f.qgtensor.jacobian_tensor) from create_tendencies")
    if tableau is not None:
        # any explicit tableau is supported (RK4 uses the fused fast path)
        from qgs_jax.ops.twofloat import _check_explicit_tableau
        _check_explicit_tableau(*tableau)


def _is_rk4(tableau):
    if tableau is None:
        return True
    a_r, b_r, c_r = rk4_tableau()
    ta, tb, tc = tableau
    return (np.shape(ta) == a_r.shape and np.allclose(ta, a_r)
            and np.allclose(tb, b_r) and np.allclose(tc, c_r))


def make_window_step_df(tensor, jtensor, dt, mdt, adjoint=False, inverse=False,
                        backward=False, qr_method="auto", tableau=None):
    """Double-float Benettin window: the (y, Q) tangent propagation runs in
    double-float (2x float32) arithmetic (:mod:`qgs_jax.ops.twofloat`), the
    per-window QR re-orthonormalization in float64 (the df->f64 conversion
    is exact; the QR is one batched (n, n_vec) factorization per ``dt``
    window vs ``n_sub`` tangent RK4 substeps).  Carries are (hi, lo) pairs;
    returns the R factor in float64 for exact ``log|diag R|`` exponent
    accumulation — the precision-critical quantity of the Benettin
    algorithm (ref ``qgs/toolbox/lyapunov.py:481-613``).

    ``qr_method``: 'householder' (float64 Householder QR) or 'mixed'
    (the float64-free :func:`~qgs_jax.ops.twofloat.cholqr_df`); 'auto'
    takes the platform's value from
    :func:`qgs_jax.utils.backend.backend_policy`."""
    from qgs_jax.ops.twofloat import (cholqr_df, df_from_f64, df_to_f64,
                                      make_df_tgls_rk4_step,
                                      make_df_tgls_rk_step_dynamic)

    if qr_method == "auto":
        qr_method = backend_policy().qr_method
    n_sub = _n_sub(dt, mdt)
    h = -mdt if backward else mdt
    if _is_rk4(tableau):
        step = make_df_tgls_rk4_step(tensor, jtensor, h, adjoint=adjoint,
                                     inverse=inverse)
    else:
        # arbitrary explicit tableau: the generic df step with the window
        # substep baked in (constant-folded at trace time, exact split)
        dyn = make_df_tgls_rk_step_dynamic(tensor, jtensor, *tableau,
                                           adjoint=adjoint, inverse=inverse)
        step = lambda carry: dyn(carry, 0.0, h)

    def window(carry, tt):
        del tt                       # the model is autonomous

        def sub(carry2, _):
            return step(carry2), None

        carry2, _ = jax.lax.scan(sub, carry, None, length=n_sub)
        y2, M = carry2
        if qr_method == "mixed":
            Qd, R = cholqr_df(M)
            return (y2, Qd), R
        Q64, R = batched_qr(df_to_f64(M), qr_method)
        return (y2, df_from_f64(Q64)), R

    return window


def make_window_step(f, fjac, dt, mdt, tableau=None, adjoint=False, inverse=False,
                     backward=False, qr_method="auto", tangent=None):
    """One Benettin window: propagate (y, Q) over ``dt`` with tangent
    substeps ``mdt``, then QR-reorthonormalize (see :func:`batched_qr`).
    Returns
    ``window((y, Q), tt) -> ((y', Q'), R)``.

    ``tangent``: optional direct tangent contraction (see
    :func:`qgs_jax.ops.contraction.make_direct_tangent`) used instead of
    the materialized-Jacobian route — the compute_* drivers build it when
    the model's tensors are available.
    With ``backward=True`` the window integrates from ``tt`` down to
    ``tt - dt`` (used for the forward-Lyapunov-vector estimation)."""
    if tableau is None:
        tableau = rk4_tableau()
    a, b, c = tableau
    n_sub = _n_sub(dt, mdt)
    h = -mdt if backward else mdt
    step = make_tgls_step(f, fjac, a, b, c, adjoint=adjoint, inverse=inverse,
                          tangent=tangent)

    def window(carry, tt):
        def sub(carry2, k):
            ts = tt + k * h
            # substep in the state's dtype: an f64 scalar would silently
            # promote an f32 ensemble to f64
            return step(carry2, ts, jnp.asarray(h, dtype=carry2[0].dtype)), None

        carry2, _ = jax.lax.scan(sub, carry, jnp.arange(n_sub))
        y2, M = carry2
        Q, R = batched_qr(M, qr_method)
        return (y2, Q), R

    return window


# ---------------------------------------------------------------------------
# Benettin: backward and forward Lyapunov vectors
# ---------------------------------------------------------------------------

def compute_backward_lyapunovs(f, fjac, t0, tw, t, dt, mdt, ic, n_vec=None,
                               write_steps=1, adjoint=False, inverse=False,
                               tableau=None, seed=0, mesh=None,
                               precision=None, tensors=None):
    """Backward Lyapunov vectors/exponents between ``tw`` and ``t`` after a
    convergence transient from ``t0`` to ``tw`` (Benettin QR algorithm).

    ``f``/``fjac`` must be batched; ``ic`` is (B, n) or (n,).  With
    ``mesh``, the ensemble axis (incl. the (B, n, n_vec) tangent blocks)
    is sharded across the mesh.  With ``precision='twofloat'`` (requires
    ``tensors=(T, JT)``, the COO tendency/Jacobian tensors), the tangent
    flow is propagated in double-float (2x float32) arithmetic with
    per-window QR — ~f64 exponent accuracy from float32 arithmetic (see
    :func:`make_window_step_df`).
    Returns ``(times, traj, exponents, vectors)`` with reference shapes
    (B, n, n_rec), (B, n_vec, n_rec), (B, n, n_vec, n_rec) squeezed.
    """
    df_mode = precision == "twofloat"
    if df_mode:
        _check_df_args(tensors, tableau)
        from qgs_jax.ops.twofloat import df_from_f64, df_to_f64
        ic = jnp.asarray(ic, jnp.float64)
    ic = jnp.atleast_2d(jnp.asarray(ic))
    ic, n_orig, put = _shard_ic(mesh, ic)
    B, n = ic.shape
    if n_vec is None:
        n_vec = n

    n_pre = _n_windows(t0, tw, dt)
    n_rec_w = _n_windows(tw, t, dt)

    rng = np.random.default_rng(seed)
    Q0 = jnp.asarray(np.linalg.qr(rng.random((n, n_vec)))[0], dtype=ic.dtype)
    Q0 = put(jnp.broadcast_to(Q0[None], (B, n, n_vec)))

    if df_mode:
        y0c, Q0c = df_from_f64(ic), df_from_f64(Q0)
    else:
        y0c, Q0c = ic, Q0

    # one compiled pipeline per (model, window options) — NOT per call:
    # the jitted runner is cached (strong-ref key, like the rk.py scan
    # cache) and the time grids arrive as arguments, so repeated
    # estimator calls with new spans/ICs reuse the executable instead of
    # re-tracing (measured 14x on the on-chip BLV benchmark, whose
    # repeat calls were paying executable setup every time)
    wkey = _window_key(df_mode, f, fjac, tensors, dt, mdt, tableau,
                       adjoint, inverse)

    def build():
        if df_mode:
            window = make_window_step_df(tensors[0], tensors[1], dt, mdt,
                                         adjoint, inverse, tableau=tableau)
        else:
            tangent = None
            if tensors is not None:
                from qgs_jax.ops.contraction import make_bucketed_tangent
                tangent = make_bucketed_tangent(tensors[1], dtype=ic.dtype,
                                              adjoint=adjoint,
                                              inverse=inverse)
            window = make_window_step(f, fjac, dt, mdt, tableau, adjoint,
                                      inverse, tangent=tangent)

        @jax.jit
        def run(y0, Q0, tts_pre, tts_rec):
            leaf = jax.tree_util.tree_leaves(Q0)[0]
            Bv, nv = leaf.shape[0], leaf.shape[2]
            e_dtype = jnp.float64 if df_mode else leaf.dtype
            # convergence pass
            (y, Q), _ = jax.lax.scan(window, (y0, Q0), tts_pre)

            # recording pass: emit (y, Q) at window start and R of the window
            def rec_window(carry, tt):
                (y, Q), R = window(carry[0], tt)
                exps = jnp.log(jnp.abs(jnp.diagonal(R, axis1=-2,
                                                    axis2=-1))) / dt
                return ((y, Q), exps), (carry[0][0], carry[0][1], carry[1])

            # seed exponent from one extra window at tw - dt? reference uses
            # the R of the *previous* window; emit the carry-in exponent
            (state, exps), (ys, Qs, exps_s) = jax.lax.scan(
                rec_window, ((y, Q), jnp.zeros((Bv, nv), dtype=e_dtype)),
                tts_rec)
            # append final point
            ys = _tappend(ys, state[0])
            Qs = _tappend(Qs, state[1])
            exps_s = jnp.concatenate([exps_s, exps[None]], axis=0)
            return ys, Qs, exps_s

        return run

    run = _scan_cache_get(('blv',) + wkey + (str(ic.dtype),), build)
    ys, Qs, exps = run(y0c, Q0c,
                       jnp.asarray(t0 + dt * np.arange(n_pre)),
                       jnp.asarray(tw + dt * np.arange(n_rec_w)))
    if df_mode:
        ys, Qs = df_to_f64(ys), df_to_f64(Qs)

    times = tw + dt * np.arange(n_rec_w + 1)
    idx = np.arange(0, n_rec_w + 1, max(write_steps, 1))
    if idx[-1] != n_rec_w:
        idx = np.concatenate([idx, [n_rec_w]])
    if write_steps == 0:
        idx = np.array([n_rec_w])

    traj = jnp.moveaxis(ys[idx][:, :n_orig], 0, -1)
    vecs = jnp.moveaxis(Qs[idx][:, :n_orig], 0, -1)
    lexp = jnp.moveaxis(exps[idx][:, :n_orig], 0, -1)
    return times[idx], jnp.squeeze(traj), jnp.squeeze(lexp), jnp.squeeze(vecs)


def compute_forward_lyapunovs(f, fjac, t0, tw, t, dt, mdt, ic, n_vec=None,
                              write_steps=1, adjoint=False, inverse=False,
                              tableau=None, seed=0, mesh=None,
                              precision=None, tensors=None):
    """Forward Lyapunov vectors/exponents between ``t0`` and ``tw``: the
    trajectory is integrated forward to ``t``, then the tangent flow is
    propagated backward with QR re-orthonormalization (converging over
    [t, tw], recording over [tw, t0]).  ``precision='twofloat'`` as in
    :func:`compute_backward_lyapunovs`."""
    df_mode = precision == "twofloat"
    if df_mode:
        _check_df_args(tensors, tableau)
        from qgs_jax.ops.twofloat import (df_from_f64, df_to_f64,
                                          make_df_rk4_step)
        ic = jnp.asarray(ic, jnp.float64)
    ic = jnp.atleast_2d(jnp.asarray(ic))
    ic, n_orig, put = _shard_ic(mesh, ic)
    B, n = ic.shape
    if n_vec is None:
        n_vec = n

    n_rec_w = _n_windows(t0, tw, dt)
    n_post = _n_windows(tw, t, dt)

    if tableau is None:
        tableau = rk4_tableau()
    a_t, b_t, c_t = tableau
    n_sub = _n_sub(dt, mdt)

    rng = np.random.default_rng(seed)
    Q0 = jnp.asarray(np.linalg.qr(rng.random((n, n_vec)))[0], dtype=ic.dtype)
    Q0 = put(jnp.broadcast_to(Q0[None], (B, n, n_vec)))

    if df_mode:
        y0c, Q0c = df_from_f64(ic), df_from_f64(Q0)
    else:
        y0c, Q0c = ic, Q0

    # cached compiled pipeline; see compute_backward_lyapunovs
    wkey = _window_key(df_mode, f, fjac, tensors, dt, mdt, tableau,
                       adjoint, inverse)

    def build():
        if df_mode:
            window = make_window_step_df(tensors[0], tensors[1], dt, mdt,
                                         adjoint, inverse, backward=True,
                                         tableau=tableau)
            if _is_rk4(tableau):
                fwd_df = make_df_rk4_step(tensors[0], mdt)
                fwd_sub = lambda y2, ts: fwd_df(y2)
            else:
                from qgs_jax.ops.twofloat import make_df_rk_step_dynamic
                fwd_dyn = make_df_rk_step_dynamic(tensors[0], *tableau)
                fwd_sub = lambda y2, ts: fwd_dyn(y2, 0.0, mdt)
        else:
            tangent = None
            if tensors is not None:
                from qgs_jax.ops.contraction import make_bucketed_tangent
                tangent = make_bucketed_tangent(tensors[1], dtype=ic.dtype,
                                              adjoint=adjoint,
                                              inverse=inverse)
            window = make_window_step(f, fjac, dt, mdt, tableau, adjoint,
                                      inverse, backward=True,
                                      tangent=tangent)
            fwd_step = make_rk_step(f, a_t, b_t, c_t)
            fwd_sub = lambda y2, ts: fwd_step(
                y2, ts, jnp.asarray(mdt, dtype=y2.dtype))

        @jax.jit
        def run(y0, Q0, fwd_tts, post_tts, rec_tts):
            leaf = jax.tree_util.tree_leaves(Q0)[0]
            Bv, nv = leaf.shape[0], leaf.shape[2]
            e_dtype = jnp.float64 if df_mode else leaf.dtype
            n_rec = rec_tts.shape[0]
            n_post_ = post_tts.shape[0]

            # forward trajectory, stored at window boundaries
            def fwd_window(y, tt):
                def sub(y2, k):
                    return fwd_sub(y2, tt + k * mdt), None

                y2, _ = jax.lax.scan(sub, y, jnp.arange(n_sub))
                return y2, y2

            yT, ys = jax.lax.scan(fwd_window, y0, fwd_tts)
            ys = _tprepend(y0, ys)              # states at all boundaries

            # backward convergence pass over [t, tw]
            def conv_window(Q, inp):
                tt, y_end = inp
                (_, Q2), R = window((y_end, Q), tt)
                return Q2, R

            post_ys = _tindex(ys, n_rec + n_post_ - jnp.arange(n_post_))
            Q, R_last = jax.lax.scan(conv_window, Q0, (post_tts, post_ys))

            # backward recording pass over [tw, t0]
            def rec_window(carry, inp):
                Q, R_prev = carry
                tt, y_end = inp
                exps = jnp.log(jnp.abs(jnp.diagonal(R_prev, axis1=-2,
                                                    axis2=-1))) / dt
                out = (y_end, Q, exps)
                (_, Q2), R = window((y_end, Q), tt)
                return (Q2, R), out

            rec_ys = _tindex(ys, n_rec - jnp.arange(n_rec))
            (Qf, Rf), (ys_r, Qs_r, exps_r) = jax.lax.scan(
                rec_window,
                (Q, R_last[-1] if n_post_ > 0
                 else jnp.zeros((Bv, nv, nv), dtype=e_dtype)),
                (rec_tts, rec_ys))
            exps_f = jnp.log(jnp.abs(jnp.diagonal(Rf, axis1=-2,
                                                  axis2=-1))) / dt
            ys_r = _tappend(ys_r, _tindex(ys, 0))
            Qs_r = _tappend(Qs_r, Qf)
            exps_r = jnp.concatenate([exps_r, exps_f[None]], axis=0)
            # records run backward in time — flip to ascending
            return (_tindex(ys_r, slice(None, None, -1)),
                    _tindex(Qs_r, slice(None, None, -1)), exps_r[::-1])

        return run

    run = _scan_cache_get(('flv',) + wkey + (str(ic.dtype),), build)
    ys, Qs, exps = run(y0c, Q0c,
                       jnp.asarray(t0 + dt * np.arange(n_rec_w + n_post)),
                       jnp.asarray(t - dt * np.arange(n_post)),
                       jnp.asarray(tw - dt * np.arange(n_rec_w)))
    if df_mode:
        ys, Qs = df_to_f64(ys), df_to_f64(Qs)

    times = t0 + dt * np.arange(n_rec_w + 1)
    idx = np.arange(0, n_rec_w + 1, max(write_steps, 1))
    if idx[-1] != n_rec_w:
        idx = np.concatenate([idx, [n_rec_w]])
    if write_steps == 0:
        idx = np.array([0])

    traj = jnp.moveaxis(ys[idx][:, :n_orig], 0, -1)
    vecs = jnp.moveaxis(Qs[idx][:, :n_orig], 0, -1)
    lexp = jnp.moveaxis(-exps[idx][:, :n_orig], 0, -1)
    return times[idx], jnp.squeeze(traj), jnp.squeeze(lexp), jnp.squeeze(vecs)


# ---------------------------------------------------------------------------
# Covariant Lyapunov vectors
# ---------------------------------------------------------------------------

def compute_clvs_ginelli(f, fjac, t0, ta, tb, tc, dt, mdt, ic, n_vec=None,
                         write_steps=1, tableau=None, seed=0, noise_pert=0.0,
                         mesh=None, precision=None, tensors=None):
    """Covariant Lyapunov vectors between ``ta`` and ``tb`` via the Ginelli
    method: forward Benettin pass storing (Q, R), backward triangular-solve
    pass from ``tc``.  Memory scales with the number of ``dt`` windows in
    [ta, tc] (the reference documents the same constraint).

    ``noise_pert`` regularizes near-tangencies: after every backward
    triangular solve, Gaussian noise of that amplitude is added to the
    diagonal of the coefficient matrix before column renormalization
    (Kuptsov & Parlitz 2012; ref ``qgs/toolbox/lyapunov.py:773-784`` setter,
    applied in the backward Ginelli loop at ``:1258-1276``).

    ``precision='twofloat'``: forward Benettin windows run in double-float
    with f64 QR (see :func:`make_window_step_df`); the backward
    triangular-solve pass runs in plain f64 on the stored R matrices (one
    (n_vec, n_vec) solve per window — cheap next to the tangent
    propagation)."""
    df_mode = precision == "twofloat"
    if df_mode:
        _check_df_args(tensors, tableau)
        from qgs_jax.ops.twofloat import df_from_f64, df_to_f64
        ic = jnp.asarray(ic, jnp.float64)
    ic = jnp.atleast_2d(jnp.asarray(ic))
    ic, n_orig, put = _shard_ic(mesh, ic)
    B, n = ic.shape
    if n_vec is None:
        n_vec = n

    n_pre = _n_windows(t0, ta, dt)
    n_rec = _n_windows(ta, tb, dt)
    n_post = _n_windows(tb, tc, dt)

    rng = np.random.default_rng(seed)
    Q0 = jnp.asarray(np.linalg.qr(rng.standard_normal((n, n_vec)))[0],
                     dtype=ic.dtype)
    Q0 = put(jnp.broadcast_to(Q0[None], (B, n, n_vec)))
    A0 = np.linalg.qr(rng.standard_normal((n_vec, n_vec)))[1]
    A0 = A0 / np.linalg.norm(A0, axis=0, keepdims=True)
    A0 = put(jnp.broadcast_to(jnp.asarray(A0, dtype=ic.dtype)[None],
                              (B, n_vec, n_vec)))

    if df_mode:
        y0c, Q0c = df_from_f64(ic), df_from_f64(Q0)
    else:
        y0c, Q0c = ic, Q0

    # per-backward-step diagonal regularization noise (host-drawn so the
    # zero-amplitude path is bitwise identical to no regularization)
    noise = put(jnp.asarray(
        rng.standard_normal((n_rec + n_post, B, n_vec)) * noise_pert,
        dtype=A0.dtype), 1)

    # cached compiled pipeline; see compute_backward_lyapunovs
    wkey = _window_key(df_mode, f, fjac, tensors, dt, mdt, tableau,
                       False, False)

    def build():
        if df_mode:
            window = make_window_step_df(tensors[0], tensors[1], dt, mdt,
                                         tableau=tableau)
        else:
            tangent = None
            if tensors is not None:
                from qgs_jax.ops.contraction import make_bucketed_tangent
                tangent = make_bucketed_tangent(tensors[1], dtype=ic.dtype)
            window = make_window_step(f, fjac, dt, mdt, tableau,
                                      tangent=tangent)

        @jax.jit
        def run(y0, Q0, A0, noise, tts_pre, tts_rec, tts_post):
            n_rec_ = tts_rec.shape[0]
            nv = A0.shape[-1]
            (y, Q), _ = jax.lax.scan(window, (y0, Q0), tts_pre)

            def rec_window(carry, tt):
                (y2, Q2), R = window(carry, tt)
                return (y2, Q2), (carry[0], carry[1], R)

            (y, Q), (ys, Qs, Rs) = jax.lax.scan(rec_window, (y, Q), tts_rec)
            ys = _tappend(ys, y)
            Qs = _tappend(Qs, Q)
            if df_mode:
                # CLV assembly + the backward pass run in f64 (exact df->f64)
                from qgs_jax.ops.twofloat import df_to_f64 as _to64
                Qs = _to64(Qs)

            def post_window(carry, tt):
                (y2, Q2), R = window(carry, tt)
                return (y2, Q2), R

            _, Rs_post = jax.lax.scan(post_window, (y, Q), tts_post)
            R_all = jnp.concatenate([Rs, Rs_post], axis=0)  # (rec+post, B, v, v)

            # backward Ginelli pass: a_{i} = normalize(R_i^{-1} a_{i+1}),
            # with optional Gaussian diagonal noise against near-tangency
            # ill-conditioning (exactly zero contribution at amplitude 0).
            # In df mode the solve uses the mixed-precision refinement
            # scheme (f32 solves + f64 residual, trisolve_mp) — the
            # emulated-f64 sequential solve this replaces dominated the
            # backward pass (the same lever cholqr_df applied to the
            # forward window in round 3).
            diag_idx = jnp.arange(nv)
            if df_mode:
                from qgs_jax.ops.twofloat import trisolve_mp as _trisolve
            else:
                def _trisolve(R, A, lower=False):
                    return jax.scipy.linalg.solve_triangular(R, A,
                                                             lower=lower)

            def back(carry, inp):
                A = carry
                R, nz = inp
                A_new = _trisolve(R, A, lower=False)
                A_new = A_new.at[..., diag_idx, diag_idx].add(nz)
                A_n, norms = _normalize_columns(A_new)
                return A_n, (A_n, norms)

            # converge over the post segment (reversed), then record
            A_conv, _ = jax.lax.scan(back, A0,
                                     (R_all[n_rec_:][::-1],
                                      noise[n_rec_:][::-1]))
            _, (As, norms) = jax.lax.scan(back, A_conv,
                                          (R_all[:n_rec_][::-1],
                                           noise[:n_rec_][::-1]))
            As = As[::-1]                   # A at window starts ta..tb-dt
            norms = norms[::-1]

            # CLVs at the recorded points: Q_i A_i; exponents from norms
            clvs = jnp.einsum('tbnv,tbvw->tbnw', Qs[:n_rec_], As,
                              precision=jax.lax.Precision.HIGHEST)
            exps = -jnp.log(jnp.abs(norms)) / dt
            # final point tb: apply the converged A at tb (first element of
            # the reversed recording scan) — reference records n_rec+1 points
            clv_last = jnp.einsum('bnv,bvw->bnw', Qs[n_rec_], A_conv,
                                  precision=jax.lax.Precision.HIGHEST)
            exps_last = exps[-1]
            clvs = jnp.concatenate([clvs, clv_last[None]], axis=0)
            exps = jnp.concatenate([exps, exps_last[None]], axis=0)
            return ys, clvs, exps

        return run

    run = _scan_cache_get(('clv',) + wkey + (str(ic.dtype),), build)
    ys, clvs, exps = run(y0c, Q0c, A0, noise,
                         jnp.asarray(t0 + dt * np.arange(n_pre)),
                         jnp.asarray(ta + dt * np.arange(n_rec)),
                         jnp.asarray(tb + dt * np.arange(n_post)))
    if df_mode:
        ys = df_to_f64(ys)

    times = ta + dt * np.arange(n_rec + 1)
    idx = np.arange(0, n_rec + 1, max(write_steps, 1))
    if idx[-1] != n_rec:
        idx = np.concatenate([idx, [n_rec]])
    if write_steps == 0:
        idx = np.array([n_rec])

    traj = jnp.moveaxis(ys[idx][:, :n_orig], 0, -1)
    vecs = jnp.moveaxis(clvs[idx][:, :n_orig], 0, -1)
    lexp = jnp.moveaxis(exps[idx][:, :n_orig], 0, -1)
    return times[idx], jnp.squeeze(traj), jnp.squeeze(lexp), jnp.squeeze(vecs)


@jax.jit
def _subspace_intersect(Bfull, Ffull):
    """Subspace intersection, batched over the mode index j: CLV_j is the
    leading left singular vector of M_j = BLV_1..j+1^T FLV_1..n-j
    (ref ``qgs/toolbox/lyapunov.py:1293`` runs this fully in its compute
    layer).  The truncation mask ``(v <= j) & (w < n-j)`` is SEPARABLE —
    M_j = diag(r_j) G diag(c_j) with G the full overlap Gram matrix — so
    the leading left singular vector of every M_j comes from ONE masked
    power iteration on M_j M_j^T run for all j simultaneously: each sweep
    is two (B, T, n, n) batched matmuls (no SVD and no lax.map).
    sigma_1(M_j) = cos of the smallest principal angle = 1
    (the flags intersect by construction), so the iteration is well
    scaled; convergence rate is the (sigma_2/sigma_1)^2 angle gap.

    Module-level jit: retraced per (B, T, n) shape, the executable reused
    across calls (a per-call jit object cost a fresh compile-cache lookup
    every invocation).

    Convergence caveat: the iteration contracts as (sigma_2/sigma_1)^2
    per sweep, so for NEAR-DEGENERATE principal-angle pairs (nearly equal
    exponents — e.g. symmetric mode pairs) the sweep cap leaves the
    returned vector mixed within the near-degenerate plane.  This is the
    regime where finite-time CLVs are ill-conditioned for EVERY method
    (an exact SVD of the finite-time overlap returns an equally arbitrary
    member of the plane, and the Ginelli backward pass converges at the
    same gap rate); the cross-method test compares Oseledets FLAGS, which
    are the well-defined objects there."""
    n = Bfull.shape[-1]
    G = jnp.einsum('btnv,btnw->btvw', Bfull, Ffull,
                   precision=jax.lax.Precision.HIGHEST)      # (B, T, n, n)
    rows = jnp.arange(n)
    jj = jnp.arange(n)
    r = (rows[:, None] <= jj[None, :]).astype(G.dtype)       # (n, J) rows
    c = (rows[:, None] < (n - jj)[None, :]).astype(G.dtype)  # columns

    def norm_cols(U):
        nrm = jnp.sqrt(jnp.sum(U * U, axis=-2, keepdims=True))
        return U / jnp.where(nrm == 0, 1.0, nrm)

    def phase(U0_, prec, chunk, max_sweeps, tol):
        """while_loop of `chunk`-sweep blocks with one convergence check
        per block (a per-sweep check measured 3x the sweep itself: the
        (B,T,n,J) min-reduce + double carry dominate these small batched
        matmuls); near-degenerate principal-angle pairs never converge,
        so the cap is the usual exit and block granularity is what
        matters."""
        def sweep(i, U):
            # U <- normalize(diag(r) G diag(c)^2 G^T diag(r) U), all j at
            # once (diag(c) is idempotent: M M^T needs c applied once)
            Y = c * jnp.einsum('btvw,btvj->btwj', G, r * U, precision=prec)
            Z = r * jnp.einsum('btvw,btwj->btvj', G, Y, precision=prec)
            return norm_cols(Z)

        def block(U):
            return jax.lax.fori_loop(0, chunk, sweep, U)

        def cond(state):
            U, U_prev, it = state
            align = jnp.abs(jnp.sum(U * U_prev, axis=-2))    # (B, T, J)
            return jnp.logical_and(it < max_sweeps,
                                   jnp.min(align) < 1.0 - tol)

        def body(state):
            U, _, it = state
            return block(U), U, it + chunk

        U, _, _ = jax.lax.while_loop(cond, body, (block(U0_), U0_, chunk))
        return U

    # deterministic start with nonuniform weights (breaks any symmetry
    # that could leave the start orthogonal to the leading vector)
    U0 = norm_cols(jnp.broadcast_to(
        (r * (1.0 + rows / n)[:, None]).astype(G.dtype), G.shape))
    # every sweep at HIGHEST, float32 included: on an H100 a DEFAULT
    # precision bulk phase (reduced-precision f32 operands) left the f32
    # vectors up to 5.6e-3 (median 1.3e-3) out of alignment with the
    # all-HIGHEST run, far outside the 100 eps polish tolerance, and these
    # (B, T, n, n) products are too small for the cheaper precision to pay
    eps = jnp.finfo(G.dtype).eps
    U = phase(U0, jax.lax.Precision.HIGHEST, chunk=8, max_sweeps=512,
              tol=100.0 * eps)
    # u_j is zero beyond index j (the row mask), so contracting the
    # FULL BLV basis reproduces the per-j truncated contraction exactly
    return jnp.einsum('btnv,btvj->btnj', Bfull, U,
                      precision=jax.lax.Precision.HIGHEST)


def compute_clvs_subspace(f, fjac, t0, ta, tb, tc, dt, mdt, ic, write_steps=1,
                          tableau=None, seed=0, return_blvs=False, return_flvs=False,
                          mesh=None, precision=None, tensors=None):
    """Covariant Lyapunov vectors by intersecting the BLV and FLV subspaces
    (Eckmann-Ruelle / Kuptsov-Parlitz): CLV_j spans
    ``span(BLV_1..j) ∩ span(FLV_1..n-j+1)``.  Lower memory than Ginelli for
    long trajectories.  ``precision='twofloat'`` propagates both Benettin
    passes in double-float (the masked-power-iteration intersection and
    the one-substep local exponents run in f64 on the recorded vectors
    either way)."""
    ic = jnp.atleast_2d(jnp.asarray(ic))
    B, n = ic.shape

    tt_b, traj, bexp, bvec = compute_backward_lyapunovs(
        f, fjac, t0, ta, tb, dt, mdt, ic, n_vec=n, write_steps=write_steps,
        tableau=tableau, seed=seed, mesh=mesh, precision=precision,
        tensors=tensors)
    # forward vectors on the same span [ta, tb], converging over [tb, tc]:
    # the forward pass starts at ta, so its IC is the state at ta — the
    # first recorded point of the backward pass (for every batch size)
    ic_at_ta = traj.reshape(B, n, -1)[:, :, 0]
    tt_f, _, fexp, fvec = compute_forward_lyapunovs(
        f, fjac, ta, tb, tc, dt, mdt, ic_at_ta,
        n_vec=n, write_steps=write_steps, tableau=tableau, seed=seed, mesh=mesh,
        precision=precision, tensors=tensors)

    bvec_ = jnp.asarray(bvec).reshape(B, n, n, -1)
    fvec_ = jnp.asarray(fvec).reshape(B, n, n, -1)

    # on-device intersection: see _subspace_intersect (masked power
    # iteration, module-level jit shared across calls)
    Bfull = jnp.moveaxis(bvec_, -1, 1)                        # (B, T, n, n)
    Ffull = jnp.moveaxis(fvec_, -1, 1)                        # (B, T, n, n)

    clvs = _subspace_intersect(Bfull, Ffull)      # (B, T, n, n_vec)
    clvs = jnp.moveaxis(clvs, 1, -1)              # (B, n, n_vec, T)

    # local exponents: one tangent mdt-step on the CLV matrix.  The
    # compiled scan is cached by the (f, fjac, tableau) identity, so
    # repeated calls reuse one executable
    if tableau is None:
        tableau = rk4_tableau()
    a_t, b_t, c_t = tableau

    def build_exps():
        tgls = make_tgls_step(f, fjac, a_t, b_t, c_t)

        @jax.jit
        def local_exps(ys, vs, mdt_):
            def one(carry, inp):
                y, v = inp
                _, v2 = tgls((y, v), jnp.asarray(0.0),
                             mdt_.astype(y.dtype))
                _, norms = _normalize_columns(v2)
                return carry, jnp.log(jnp.abs(norms)) / mdt_

            _, exps = jax.lax.scan(
                one, None,
                (jnp.moveaxis(ys, -1, 0), jnp.moveaxis(vs, -1, 0)))
            return jnp.moveaxis(exps, 0, -1)

        return local_exps

    local_exps = _scan_cache_get(
        ('subspace_exps', f, fjac, _tableau_key(a_t, b_t, c_t)), build_exps)

    traj_ = jnp.asarray(traj).reshape(B, n, -1)
    exps = local_exps(traj_, clvs, jnp.asarray(mdt, clvs.dtype))

    out = [tt_b, jnp.squeeze(traj), jnp.squeeze(exps), jnp.squeeze(clvs)]
    if return_blvs:
        out.append((bexp, bvec))
    if return_flvs:
        out.append((fexp, fvec))
    return tuple(out)


# ---------------------------------------------------------------------------
# Estimator classes (reference API surface)
# ---------------------------------------------------------------------------

class LyapunovsEstimator:
    """Benettin BLV/FLV estimator with the reference's class API.  Pass a
    ``mesh`` to shard the IC ensemble (and its tangent blocks) across
    devices — the mesh replacement of the reference's worker pool.
    ``precision='twofloat'`` runs the tangent propagation in double-float
    (requires ``set_func`` with a tendency function from
    ``create_tendencies``, which carries its tensors)."""

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, mesh=None, precision=None):
        # partial tableaux are honored: missing coefficients fall back to
        # RK4, mirroring set_bca (ref ``qgs/toolbox/lyapunov.py:41-100``)
        self.tableau = merge_tableau(a, b, c)
        self.func = None
        self.func_jac = None
        self.n_dim = number_of_dimensions
        self.ic = None
        self._result = None
        self.mesh = mesh
        if precision not in (None, "float64", "twofloat"):
            raise ValueError(
                f"unknown precision {precision!r}: expected None/'float64' "
                "(ambient dtype) or 'twofloat'")
        self.precision = precision
        self._tensors = None

    def set_func(self, f, fjac):
        self.func = getattr(f, "batched", f)
        self.func_jac = getattr(fjac, "batched", fjac)
        # capture the model tensors (for the direct tangent path and the
        # twofloat tier) only when fjac is the tensor-derived Jacobian of
        # the SAME model — a user-supplied custom fjac must stay honored.
        # "Same model" = value-equal jacobian tensors (a rebuild from the
        # same parameters counts), not object identity.
        from qgs_jax.integrators.integrator import _same_model_jacobian
        qgt = getattr(f, "qgtensor", None)
        if qgt is not None and _same_model_jacobian(fjac, qgt):
            self._tensors = (qgt.tensor, qgt.jacobian_tensor)
        else:
            self._tensors = None

    def start(self):
        pass

    def terminate(self):
        pass

    def set_bca(self, b=None, c=None, a=None, ic_init=True):
        """Swap the Butcher tableau of the internal integrators
        (ref ``lyapunov.py:178,786``)."""
        self.tableau = merge_tableau(a, b, c, current=self.tableau)
        if ic_init:
            self.ic = None

    stop = terminate

    def compute_lyapunovs(self, t0, tw, t, dt, mdt, ic=None, write_steps=1,
                          n_vec=None, forward=False, adjoint=False, inverse=False):
        if ic is None:
            ic = self.ic
        ic = np.asarray(ic)
        if forward:
            self._result = compute_forward_lyapunovs(
                self.func, self.func_jac, t0, tw, t, dt, mdt, ic, n_vec=n_vec,
                write_steps=write_steps, adjoint=adjoint, inverse=inverse,
                tableau=self.tableau, mesh=self.mesh,
                precision=self.precision, tensors=self._tensors)
        else:
            self._result = compute_backward_lyapunovs(
                self.func, self.func_jac, t0, tw, t, dt, mdt, ic, n_vec=n_vec,
                write_steps=write_steps, adjoint=adjoint, inverse=inverse,
                tableau=self.tableau, mesh=self.mesh,
                precision=self.precision, tensors=self._tensors)

    def get_lyapunovs(self):
        """Return ``(times, trajectory, exponents, vectors)``."""
        t, traj, exp, vec = self._result
        return t, np.asarray(traj), np.asarray(exp), np.asarray(vec)


class CovariantLyapunovsEstimator:
    """CLV estimator (Ginelli method 0 / subspace method 1)."""

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, noise_pert=0.0, mesh=None,
                 precision=None):
        # see LyapunovsEstimator: partial tableaux merge with RK4 defaults
        self.tableau = merge_tableau(a, b, c)
        self.func = None
        self.func_jac = None
        self.n_dim = number_of_dimensions
        self.noise_pert = noise_pert
        self.ic = None
        self._result = None
        self._blvs = None
        self._flvs = None
        self.method = 0
        self.mesh = mesh
        if precision not in (None, "float64", "twofloat"):
            raise ValueError(
                f"unknown precision {precision!r}: expected None/'float64' "
                "(ambient dtype) or 'twofloat'")
        self.precision = precision
        self._tensors = None

    def set_func(self, f, fjac):
        self.func = getattr(f, "batched", f)
        self.func_jac = getattr(fjac, "batched", fjac)
        # capture the model tensors (for the direct tangent path and the
        # twofloat tier) only when fjac is the tensor-derived Jacobian of
        # the SAME model — a user-supplied custom fjac must stay honored.
        # "Same model" = value-equal jacobian tensors (a rebuild from the
        # same parameters counts), not object identity.
        from qgs_jax.integrators.integrator import _same_model_jacobian
        qgt = getattr(f, "qgtensor", None)
        if qgt is not None and _same_model_jacobian(fjac, qgt):
            self._tensors = (qgt.tensor, qgt.jacobian_tensor)
        else:
            self._tensors = None

    def start(self):
        pass

    def terminate(self):
        pass

    def set_bca(self, b=None, c=None, a=None, ic_init=True):
        """Swap the Butcher tableau of the internal integrators
        (ref ``lyapunov.py:178,786``)."""
        self.tableau = merge_tableau(a, b, c, current=self.tableau)
        if ic_init:
            self.ic = None

    def set_noise_pert(self, noise_pert):
        """Set the Ginelli R-diagonal noise-regularization amplitude
        (ref ``lyapunov.py:773-784``)."""
        self.noise_pert = noise_pert

    stop = terminate

    def compute_clvs(self, t0, ta, tb, tc, dt, mdt, ic=None, write_steps=1,
                     n_vec=None, method=None, backward_vectors=False,
                     forward_vectors=False):
        if method is None:
            method = self.method
        self.method = method
        if ic is None:
            ic = self.ic
        ic = np.asarray(ic)
        if method == 0:
            self._result = compute_clvs_ginelli(
                self.func, self.func_jac, t0, ta, tb, tc, dt, mdt, ic,
                n_vec=n_vec, write_steps=write_steps, tableau=self.tableau,
                noise_pert=self.noise_pert, mesh=self.mesh,
                precision=self.precision, tensors=self._tensors)
            self._blvs = self._flvs = None
        else:
            out = compute_clvs_subspace(
                self.func, self.func_jac, t0, ta, tb, tc, dt, mdt, ic,
                write_steps=write_steps, tableau=self.tableau,
                return_blvs=backward_vectors, return_flvs=forward_vectors,
                mesh=self.mesh, precision=self.precision,
                tensors=self._tensors)
            self._result = out[:4]
            k = 4
            self._blvs = out[k] if backward_vectors else None
            if backward_vectors:
                k += 1
            self._flvs = out[k] if forward_vectors else None

    def get_clvs(self):
        """Return ``(times, trajectory, exponents, vectors)``."""
        t, traj, exp, vec = self._result
        return t, np.asarray(traj), np.asarray(exp), np.asarray(vec)

    def get_blvs(self):
        if self._blvs is None:
            return None
        exp, vec = self._blvs
        return self._result[0], np.asarray(self._result[1]), np.asarray(exp), np.asarray(vec)

    def get_flvs(self):
        if self._flvs is None:
            return None
        exp, vec = self._flvs
        return self._result[0], np.asarray(self._result[1]), np.asarray(exp), np.asarray(vec)
