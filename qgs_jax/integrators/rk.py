"""
Runge-Kutta integration (device compute path)
=============================================

Explicit Runge-Kutta integrators for arbitrary Butcher tableaux, built on
``jax.lax.scan`` so the whole trajectory loop compiles to a single XLA
while-loop on device — no per-step host round trips (the reference's design
point was a Numba per-trajectory loop, ref
``qgs/integrators/integrate.py:183-223``; here the ensemble axis is batched
and sharded instead).

Layout conventions:

* states are batched: ``y`` has shape (B, ndim); tangent/fundamental
  matrices have shape (B, ndim, n_tg).
* the time grid reproduces the reference semantics:
  ``time = concat(arange(t0, t, dt), [t])`` — uniform steps plus one
  (possibly shorter) final step; with ``write_steps = w`` the recorded
  points are ``time[::w]`` plus the final point if not already recorded.
* memory: the scan is chunked by the write stride, so only the recorded
  states are materialized — long transients cost O(1) memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_tmap = jax.tree_util.tree_map


def rk4_tableau(dtype=jnp.float64):
    """The classical RK4 Butcher tableau (reference default)."""
    c = np.array([0., 0.5, 0.5, 1.])
    b = np.array([1. / 6, 1. / 3, 1. / 3, 1. / 6])
    a = np.zeros((4, 4))
    a[1, 0] = 0.5
    a[2, 1] = 0.5
    a[3, 2] = 1.
    return a, b, c


def rk2_tableau(dtype=jnp.float64):
    """Heun's second-order method."""
    c = np.array([0., 1.])
    b = np.array([0.5, 0.5])
    a = np.zeros((2, 2))
    a[1, 0] = 1.
    return a, b, c


def merge_tableau(a=None, b=None, c=None, current=None):
    """Merge partially-specified Butcher coefficients into a full
    ``(a, b, c)`` tableau: unspecified coefficients fall back to ``current``
    (a previously-configured tableau) and then to the RK4 defaults — the
    reference treats each coefficient independently in its ``set_bca``
    methods (ref ``qgs/toolbox/lyapunov.py:178-205``), so passing only
    ``b``/``c`` must not silently discard them.  Returns ``None`` when
    nothing is specified and there is no current tableau (callers then use
    their own default)."""
    if a is None and b is None and c is None and current is None:
        return None
    base = current if current is not None else rk4_tableau()
    return (np.asarray(a) if a is not None else np.asarray(base[0]),
            np.asarray(b) if b is not None else np.asarray(base[1]),
            np.asarray(c) if c is not None else np.asarray(base[2]))


def time_grid(t0, t, dt):
    """Reference-compatible integration time grid (host side)."""
    return np.concatenate((np.arange(t0, t, dt), np.full((1,), t)))


def _record_indices(n_points, write_steps):
    """Indices into the time grid that get recorded (host side)."""
    idx = list(range(0, n_points, write_steps))
    if idx[-1] != n_points - 1:
        idx.append(n_points - 1)
    return np.array(idx)


def make_rk_step(f, a, b, c, dtype=jnp.float64):
    """Build a single-step function ``step(y, tt, dt) -> y_new`` for the
    explicit tableau (a, b, c).  The stage loop is unrolled (s is static)."""
    s = len(b)
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)

    def step(y, tt, dt):
        dt64 = dt
        dt = jnp.asarray(dt, dtype=y.dtype)   # keep f32 states f32 (no silent
        k = []                                # promotion through a traced f64 dt)
        for i in range(s):
            y_s = y
            for l in range(i):
                if a[i, l] != 0.0:
                    y_s = y_s + dt * float(a[i, l]) * k[l]
            k.append(f(tt + float(c[i]) * dt64, y_s))
        y_new = y
        for i in range(s):
            if b[i] != 0.0:
                y_new = y_new + dt * float(b[i]) * k[i]
        return y_new

    return step


def make_tgls_step(f, fjac, a, b, c, adjoint=False, inverse=False, boundary=None,
                   dtype=jnp.float64, tangent=None):
    """Single step of the coupled (trajectory, tangent) system.

    The tangent carries a fundamental-matrix block (B, ndim, n_tg) propagated
    with d(dx)/dt = +-J(x) dx (or J^T for the adjoint) plus an optional
    inhomogeneous boundary term Psi(t, x) (ref ``integrate.py:556-614``).

    ``tangent``: optional direct contraction ``hom(xx, dm)`` over the
    dummy-padded state (:func:`qgs_jax.ops.contraction.make_direct_tangent`,
    already carrying the adjoint/inverse transform) — avoids materializing
    the Jacobian and the tiny per-member matmuls it implies.
    """
    s = len(b)
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)
    sign = -1.0 if inverse else 1.0

    def tangent_rhs(t, y_s, dm):
        if tangent is not None:
            ones = jnp.ones(y_s.shape[:-1] + (1,), dtype=y_s.dtype)
            hom = tangent(jnp.concatenate([ones, y_s], axis=-1), dm)
        else:
            J = fjac(t, y_s)                  # (B, n, n)
            # HIGHEST: at DEFAULT precision XLA:GPU rounds f32 operands
            # (see ops.contraction._resolve_precision)
            hi = jax.lax.Precision.HIGHEST
            if adjoint:
                hom = sign * jnp.einsum('bnm,bnt->bmt', J, dm, precision=hi)
            else:
                hom = sign * jnp.einsum('bnm,bmt->bnt', J, dm, precision=hi)
        if boundary is not None:
            hom = hom + boundary(t, y_s)
        return hom

    def step(carry, tt, dt):
        y, dm = carry
        dt64 = dt
        dt = jnp.asarray(dt, dtype=y.dtype)   # see make_rk_step: no promotion
        k, km = [], []
        for i in range(s):
            y_s, dm_s = y, dm
            for l in range(i):
                if a[i, l] != 0.0:
                    y_s = y_s + dt * float(a[i, l]) * k[l]
                    dm_s = dm_s + dt * float(a[i, l]) * km[l]
            ts = tt + float(c[i]) * dt64
            k.append(f(ts, y_s))
            km.append(tangent_rhs(ts, y_s, dm_s))
        y_new, dm_new = y, dm
        for i in range(s):
            if b[i] != 0.0:
                y_new = y_new + dt * float(b[i]) * k[i]
                dm_new = dm_new + dt * float(b[i]) * km[i]
        return y_new, dm_new

    return step


def _scan_chunks(step_pytree, carry0, td_all, write_steps):
    """Scan the step function over the full time grid, materializing the
    carry only every ``write_steps`` steps (0 = final state only).

    Implementation: one outer ``lax.scan`` over record chunks, each chunk an
    inner ``lax.scan`` of ``write_steps`` steps — O(n_records) memory, a
    single compiled while-loop on device.

    ``td_all`` is the (n_steps, 2) array of (t, dt) pairs.
    Returns ``(final_carry, records)`` where ``records`` is a carry pytree
    with a leading record axis (time indices 0, w, 2w, ..., final).
    """
    n_steps = td_all.shape[0]

    def run_plain(carry, td):
        def body(ca, t_d):
            return step_pytree(ca, t_d[0], t_d[1]), None

        ca, _ = jax.lax.scan(body, carry, td)
        return ca

    if write_steps == 0:
        final = run_plain(carry0, td_all)
        return final, jax.tree_util.tree_map(lambda x: x[None], final)

    w = write_steps
    k = n_steps // w
    rem = n_steps - k * w

    parts = [jax.tree_util.tree_map(lambda x: x[None], carry0)]
    carry = carry0
    if k > 0:
        def chunk_body(ca, td_chunk):
            ca = run_plain(ca, td_chunk)
            return ca, ca

        carry, stacked = jax.lax.scan(chunk_body, carry0, td_all[:k * w].reshape(k, w, 2))
        parts.append(stacked)
    if rem > 0:
        carry = run_plain(carry, td_all[k * w:])
        parts.append(jax.tree_util.tree_map(lambda x: x[None], carry))
    records = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
    return carry, records


# ---------------------------------------------------------------------------
# compiled-integrator cache
# ---------------------------------------------------------------------------
#
# Each distinct (tendency fn, tableau, write stride, tangent options) pair
# compiles one scan; subsequent calls with the same time-grid length reuse
# the jitted executable (jit caches by input shapes).
#
# Keys hold *strong references* to the tendency functions themselves (they
# are hashable by identity): keying on ``id(f)`` would let a garbage-
# collected function's address be reused by a new function, silently
# serving it the stale compiled scan.  The cache is bounded (FIFO) so the
# strong refs cannot accumulate without limit.

from collections import OrderedDict

_SCAN_CACHE = OrderedDict()
_SCAN_CACHE_MAX = 128


def _scan_cache_get(key, build):
    fn = _SCAN_CACHE.get(key)
    if fn is None:
        fn = build()
        _SCAN_CACHE[key] = fn
        while len(_SCAN_CACHE) > _SCAN_CACHE_MAX:
            _SCAN_CACHE.popitem(last=False)
    return fn


def _tableau_key(a, b, c):
    return (np.asarray(a).tobytes(), np.asarray(b).tobytes(), np.asarray(c).tobytes())


def _operand_form(fn):
    """``(apply, key)`` of an operand-threading contraction (see
    :class:`qgs_jax.ops.contraction.Contraction`), or ``(None, None)`` for a
    plain callable."""
    apply = getattr(fn, "apply", None)
    key = getattr(fn, "key", None)
    if apply is None or key is None:
        return None, None
    return apply, key


def _float_batch_chunk():
    """PER-DEVICE-step batch chunk for the single-float kernels; 0 (the
    default) disables chunking.  On an NVIDIA H100 (700 W limit,
    ``benchmarks/batch_knee.py``, MAOOAM, 400 steps) chunking never won:
    at B=65536, 16384-member chunks ran 86.9M traj-steps/s against 139.6M
    unchunked, at B=32768 86.9M against 120.0M, and at B=16384 the two
    tied (92.4M, 92.7M).  Env ``QGS_F32_BATCH_CHUNK`` sets a chunk size."""
    import os
    return int(os.environ.get("QGS_F32_BATCH_CHUNK", "0"))


def _chunk_batched(call, chunk_of, batch_devices=1):
    """Wrap ``call(y_pytree) -> y_pytree`` (same leading batch axis) so
    per-device batches larger than the chunk size ``chunk_of()`` are
    evaluated in sequential chunks (``lax.map``) — the shared machinery
    behind :func:`_chunk_df_apply` and :func:`_chunk_plain_step`.

    ``batch_devices`` is the number of devices the GLOBAL batch axis is
    sharded over (the mesh's ensemble size): the knee is per-device, so
    the global threshold scales with it — without this, an 8-device mesh
    at knee/device (already optimal) would be split into 8 sequential
    far-below-knee chunks.

    Batches that do not divide evenly are zero-padded up to ``k * c``
    members (the padded members are re-padded from zeros every step and
    sliced off — their values are discarded, and the QG tendencies are
    finite at the origin, so they cannot poison anything).  Per-member
    arithmetic is unchanged, so chunking is bit-identical."""
    def chunked(y):
        chunk = chunk_of() * max(int(batch_devices), 1)
        B = jax.tree_util.tree_leaves(y)[0].shape[0]
        if chunk <= 0 or B <= chunk:
            return call(y)
        k = -(-B // chunk)               # number of chunks
        c = -(-B // k)                   # per-chunk size (ceil)
        pad = k * c - B
        if pad:
            y = _tmap(lambda x: jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0), y)
        yk = _tmap(lambda x: x.reshape((k, c) + x.shape[1:]), y)
        out = jax.lax.map(call, yk)
        return _tmap(lambda x: x.reshape((k * c,) + x.shape[2:])[:B], out)

    return chunked


def _chunk_plain_step(step, batch_devices=1):
    """Wrap a plain step ``step(y, tt, dt) -> y_new`` so batches larger
    than the f32 chunk size are evaluated in sequential chunks — the
    single-float analogue of :func:`_chunk_df_apply` (semantics in
    :func:`_chunk_batched`)."""
    def stepped(y, tt, dt_):
        return _chunk_batched(lambda yc: step(yc, tt, dt_),
                              _float_batch_chunk, batch_devices)(y)

    return stepped


def _get_plain_scan(f, a, b, c, write_steps, batch_devices=1):
    apply, fkey = _operand_form(f)
    # operand-threading functions are cached by their *structural* key, so
    # every same-shape model (new parameter values, same resolution) reuses
    # one compiled scan with its tensors passed as device arguments —
    # identity keys (plain callables) keep the strong-ref behavior below
    key = (fkey if fkey is not None else f,
           _tableau_key(a, b, c), write_steps, 'plain',
           _float_batch_chunk(), batch_devices)

    def build():
        if apply is None:
            step = _chunk_plain_step(make_rk_step(f, a, b, c), batch_devices)
            return jax.jit(lambda carry0, td: _scan_chunks(
                lambda y, tt, dt_: step(y, tt, dt_), carry0, td, write_steps))

        def run(operands, carry0, td):
            step = _chunk_plain_step(
                make_rk_step(lambda t, x: apply(operands, t, x), a, b, c),
                batch_devices)
            return _scan_chunks(lambda y, tt, dt_: step(y, tt, dt_),
                                carry0, td, write_steps)

        return jax.jit(run)

    fn = _scan_cache_get(key, build)
    if apply is None:
        return fn
    return lambda carry0, td: fn(f.operands, carry0, td)


def _get_tgls_scan(f, fjac, a, b, c, write_steps, adjoint, inverse, boundary):
    f_apply, fkey = _operand_form(f)
    j_apply, jkey = _operand_form(fjac)
    threaded = (f_apply is not None and j_apply is not None
                and boundary is None)
    if threaded:
        key = (fkey, jkey, _tableau_key(a, b, c), write_steps, adjoint,
               inverse, 'tgls')
    else:
        key = (f, fjac, _tableau_key(a, b, c), write_steps, adjoint,
               inverse, boundary)

    def build():
        if not threaded:
            step = make_tgls_step(f, fjac, a, b, c, adjoint=adjoint,
                                  inverse=inverse, boundary=boundary)
            return jax.jit(lambda carry0, td: _scan_chunks(step, carry0, td,
                                                           write_steps))

        def run(ops_f, ops_j, carry0, td):
            step = make_tgls_step(lambda t, x: f_apply(ops_f, t, x),
                                  lambda t, x: j_apply(ops_j, t, x),
                                  a, b, c, adjoint=adjoint, inverse=inverse)
            return _scan_chunks(step, carry0, td, write_steps)

        return jax.jit(run)

    fn = _scan_cache_get(key, build)
    if not threaded:
        return fn
    return lambda carry0, td: fn(f.operands, fjac.operands, carry0, td)


def infer_ndim(f):
    """Infer the state dimension of a batched tendency function by probing
    it with zero states of growing size until the output is consistent —
    the batched analogue of the reference's grow-until-no-exception
    probe (ref ``qgs/integrators/integrate.py:131-143``).  The contraction
    kernels report their true dimension through the output shape, so the
    probe almost always resolves on the first call."""
    for n in range(1, 513):
        try:
            out = f(0., jnp.zeros((1, n)))
        except Exception:
            continue
        m = int(out.shape[-1])
        if m == n:
            return n
        try:
            out2 = f(0., jnp.zeros((1, m)))
        except Exception:
            continue
        if int(out2.shape[-1]) == m:
            return m
    raise ValueError("could not infer the model dimension from the "
                     "tendency function; pass an explicit ic")


def integrate_runge_kutta(f, t0, t, dt, ic=None, forward=True, write_steps=1,
                          b=None, c=None, a=None, squeeze=True,
                          batch_devices=1):
    """Integrate dx/dt = f(t, x) over [t0, t] for a batch of initial
    conditions; reference-compatible wrapper returning
    ``(times, traj)`` with traj shaped (B, ndim, n_records) (squeezed).

    ``f`` must be a *batched* tendency function (B, ndim) -> (B, ndim).
    With ``ic=None`` the state dimension is probed from ``f`` and a zero
    initial condition is used (ref ``integrate.py:131-143``).
    """
    if ic is None:
        ic = jnp.zeros((1, infer_ndim(f)))
    ic = jnp.atleast_2d(jnp.asarray(ic))
    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()

    time = time_grid(t0, t, dt)
    directed = time if forward else time[::-1]
    tts, dts = directed[:-1], np.diff(directed)

    scan_fn = _get_plain_scan(f, a, b, c, write_steps,
                              batch_devices=batch_devices)
    td_all = jnp.stack([jnp.asarray(tts), jnp.asarray(dts)], axis=1)
    _, recs = scan_fn(ic, td_all)
    traj = jnp.moveaxis(recs, 0, -1)           # (B, ndim, n_records)

    if not forward:
        traj = traj[..., ::-1]

    if not squeeze:
        if write_steps > 0:
            rec = _record_indices(len(time), write_steps)
            rec_times = time[rec] if forward else time[::-1][rec][::-1]
            return rec_times, traj
        return time[-1], traj[..., -1]
    if write_steps > 0:
        rec = _record_indices(len(time), write_steps)
        rec_times = time[rec] if forward else time[::-1][rec][::-1]
        return rec_times, jnp.squeeze(traj)
    return time[-1], jnp.squeeze(traj)


def _normalize_df_tableau(a, b, c):
    """Resolve optional tableau arguments for the double-float integrators:
    ``None`` when the (default) RK4 tableau applies — the hand-fused RK4
    step is used — else the full ``(a, b, c)`` for the generic df step."""
    if a is None and b is None and c is None:
        return None
    tab = merge_tableau(a, b, c)
    a_r, b_r, c_r = rk4_tableau()
    if (np.shape(tab[0]) == a_r.shape and np.allclose(tab[0], a_r)
            and np.allclose(tab[1], b_r) and np.allclose(tab[2], c_r)):
        return None
    return tab


def _df_batch_chunk():
    """PER-DEVICE-step batch chunk for the double-float kernels; 0 (the
    default) disables chunking.  On an NVIDIA H100 (700 W limit,
    ``benchmarks/batch_knee.py``, MAOOAM, 400 steps) chunking never won:
    at B=16384, 4096-member chunks ran 8.38M traj-steps/s against 19.77M
    unchunked, at B=8192 8.32M against 13.38M, and at B=4096 the two tied
    (8.53M, 8.52M).  Env ``QGS_DF_BATCH_CHUNK`` sets a chunk size."""
    import os
    return int(os.environ.get("QGS_DF_BATCH_CHUNK", "0"))


def _chunk_df_apply(apply, batch_devices=1):
    """Wrap a df step ``apply(ops, y, tt, dt)`` so batches larger than the
    df chunk size are evaluated in sequential chunks (semantics in
    :func:`_chunk_batched`)."""
    def apply_chunked(ops, y, tt, dt_):
        return _chunk_batched(lambda yc: apply(ops, yc, tt, dt_),
                              _df_batch_chunk, batch_devices)(y)

    return apply_chunked


def _get_df_scan(tensor, write_steps, gather, accumulate, tableau=None,
                 batch_devices=1):
    tab_key = _tableau_key(*tableau) if tableau is not None else 'rk4'
    key = (tensor, write_steps, gather, accumulate, tab_key, 'df',
           _df_batch_chunk(), batch_devices)

    def build():
        from qgs_jax.ops.twofloat import (make_df_rk4_step_dynamic,
                                          make_df_rk_step_dynamic)
        if tableau is None:
            step = make_df_rk4_step_dynamic(tensor, gather=gather,
                                            accumulate=accumulate)
        else:
            step = make_df_rk_step_dynamic(tensor, *tableau, gather=gather,
                                           accumulate=accumulate)
        apply = _chunk_df_apply(step.apply, batch_devices)
        # the compiled scan is shared across every same-layout model
        # (structural key); this outer cache (tensor-identity key) only
        # avoids rebuilding the host-side bucketed layout per call
        exec_fn = _scan_cache_get((step.key, write_steps, 'df_scan_exec',
                                   _df_batch_chunk(), batch_devices),
                                  lambda: jax.jit(
            lambda ops, carry0, td: _scan_chunks(
                lambda y, tt, dt_: apply(ops, y, tt, dt_),
                carry0, td, write_steps)))
        ops = step.operands
        return lambda carry0, td: exec_fn(ops, carry0, td)

    return _scan_cache_get(key, build)


def integrate_runge_kutta_df(tensor, t0, t, dt, ic, forward=True, write_steps=1,
                             squeeze=True, gather="take", accumulate="auto",
                             a=None, b=None, c=None, batch_devices=1):
    """Integrate the model with the fused double-float (2x float32) RK
    step (:mod:`qgs_jax.ops.twofloat`): ~48-bit-mantissa trajectories from
    float32 arithmetic.  Same time-grid/record semantics as
    :func:`integrate_runge_kutta`.  Any explicit Butcher tableau is
    accepted (default RK4, which uses the hand-fused step).

    ``tensor`` is the COO tendency tensor (``QgsTensor.tensor``); ``ic``
    is float64 (B, ndim) and the returned trajectory is float64.
    """
    from qgs_jax.ops.twofloat import df_from_f64, df_to_f64

    ic = jnp.atleast_2d(jnp.asarray(ic, jnp.float64))
    time = time_grid(t0, t, dt)
    directed = time if forward else time[::-1]
    tts, dts = directed[:-1], np.diff(directed)

    tableau = _normalize_df_tableau(a, b, c)
    scan_fn = _get_df_scan(tensor, write_steps, gather, accumulate, tableau,
                           batch_devices=batch_devices)
    td_all = jnp.stack([jnp.asarray(tts), jnp.asarray(dts)], axis=1)
    _, recs = scan_fn(df_from_f64(ic), td_all)
    traj = jnp.moveaxis(df_to_f64(recs), 0, -1)    # (B, ndim, n_records)

    if not forward:
        traj = traj[..., ::-1]

    if write_steps > 0:
        rec = _record_indices(len(time), write_steps)
        rec_times = time[rec] if forward else time[::-1][rec][::-1]
        return rec_times, (jnp.squeeze(traj) if squeeze else traj)
    if squeeze:
        return time[-1], jnp.squeeze(traj[..., -1])
    return time[-1], traj[..., -1]


def _normalize_tg_ic(tg_ic, B, n, dtype=None):
    """Bring a tangent IC into the canonical (B, n, n_tg) block shape:
    1-D = one perturbation broadcast over the batch; 2-D = per-trajectory
    vectors when shaped (B, n), else an (n_tg, n) matrix shared across the
    batch; 3-D with a transposed middle axis is swapped."""
    tg = jnp.asarray(tg_ic) if dtype is None else jnp.asarray(tg_ic, dtype)
    if tg.ndim == 1:
        tg = jnp.broadcast_to(tg[None, :, None], (B, n, 1))
    elif tg.ndim == 2:
        if tg.shape[0] == B and tg.shape[1] == n:
            tg = tg[:, :, None]
        else:   # (n_tg, ndim) matrix shared across the batch
            tg = jnp.broadcast_to(tg.T[None, :, :], (B, n, tg.shape[0]))
    elif tg.ndim == 3 and tg.shape[1] != n:
        tg = jnp.swapaxes(tg, 1, 2)
    return tg


def _get_df_tgls_scan(tensor, jtensor, write_steps, adjoint, inverse,
                      gather, accumulate, tableau=None, batch_devices=1):
    tab_key = _tableau_key(*tableau) if tableau is not None else 'rk4'
    key = (tensor, jtensor, write_steps, adjoint, inverse, gather,
           accumulate, tab_key, 'df_tgls', batch_devices)

    def build():
        from qgs_jax.ops.twofloat import (make_df_tgls_rk4_step_dynamic,
                                          make_df_tgls_rk_step_dynamic)
        if tableau is None:
            step = make_df_tgls_rk4_step_dynamic(
                tensor, jtensor, adjoint=adjoint, inverse=inverse,
                gather=gather, accumulate=accumulate)
        else:
            step = make_df_tgls_rk_step_dynamic(
                tensor, jtensor, *tableau, adjoint=adjoint, inverse=inverse,
                gather=gather, accumulate=accumulate)
        apply = _chunk_df_apply(step.apply, batch_devices)
        exec_fn = _scan_cache_get((step.key, write_steps, 'df_tgls_exec',
                                   _df_batch_chunk(), batch_devices),
                                  lambda: jax.jit(
            lambda ops, carry0, td: _scan_chunks(
                lambda carry, tt, dt_: apply(ops, carry, tt, dt_),
                carry0, td, write_steps)))
        ops = step.operands
        return lambda carry0, td: exec_fn(ops, carry0, td)

    return _scan_cache_get(key, build)


def integrate_runge_kutta_tgls_df(tensor, jtensor, t0, t, dt, ic, tg_ic,
                                  forward=True, adjoint=False, inverse=False,
                                  write_steps=1, mesh=None, gather="take",
                                  accumulate="auto", a=None, b=None, c=None):
    """Integrate the coupled (trajectory, tangent) system with the fused
    double-float (2x float32) TGLS RK step (:mod:`qgs_jax.ops.twofloat`):
    ~48-bit-mantissa trajectories AND fundamental matrices from float32
    arithmetic — the precision tier for the reference's other HOT path
    (ref ``qgs/integrators/integrate.py:227-231,556-614``).

    Same time-grid/record/shape semantics as
    :func:`integrate_runge_kutta_tgls`; any explicit Butcher tableau
    (default RK4, hand-fused), no boundary term.
    ``ic``/``tg_ic`` are float64 and the returned arrays are float64.
    """
    from qgs_jax.ops.twofloat import df_from_f64, df_to_f64

    ic = jnp.atleast_2d(jnp.asarray(ic, jnp.float64))
    B, n = ic.shape
    tg = _normalize_tg_ic(tg_ic, B, n, jnp.float64)

    n_orig = B
    batch_devices = 1
    if mesh is not None and mesh.devices.size > 1 and B >= mesh.devices.size:
        from qgs_jax.parallel.mesh import shard_ensemble
        ic, n_orig = shard_ensemble(ic, mesh)
        tg, _ = shard_ensemble(tg, mesh)
        batch_devices = mesh.devices.size

    time = time_grid(t0, t, dt)
    directed = time if forward else time[::-1]
    tts, dts = directed[:-1], np.diff(directed)

    tableau = _normalize_df_tableau(a, b, c)
    scan_fn = _get_df_tgls_scan(tensor, jtensor, write_steps, adjoint,
                                inverse, gather, accumulate, tableau,
                                batch_devices=batch_devices)
    td_all = jnp.stack([jnp.asarray(tts), jnp.asarray(dts)], axis=1)
    _, recs = scan_fn((df_from_f64(ic), df_from_f64(tg)), td_all)
    traj = jnp.moveaxis(df_to_f64(recs[0])[:, :n_orig], 0, -1)
    fmat = jnp.moveaxis(df_to_f64(recs[1])[:, :n_orig], 0, -1)

    if not forward:
        traj = traj[..., ::-1]
        fmat = fmat[..., ::-1]

    if write_steps > 0:
        rec = _record_indices(len(time), write_steps)
        rec_times = time[rec] if forward else time[::-1][rec][::-1]
        return rec_times, jnp.squeeze(traj), jnp.squeeze(fmat)
    return time[-1], jnp.squeeze(traj[..., -1]), jnp.squeeze(fmat[..., -1])


def integrate_runge_kutta_tgls(f, fjac, t0, t, dt, ic, tg_ic, forward=True,
                               adjoint=False, inverse=False, boundary=None,
                               write_steps=1, b=None, c=None, a=None,
                               mesh=None):
    """Integrate the coupled (trajectory, tangent-linear) system.

    ``tg_ic`` may be (ndim,), (B, ndim) or (B, ndim, n_tg) — a fundamental
    matrix of tangent vectors is propagated in the last case.
    With ``mesh``, the ensemble (batch) axis of both the trajectory and the
    tangent blocks is sharded across the mesh (the (B, n, n_tg) fundamental
    matrices are the memory/compute-heavy part of this workload).
    Returns ``(times, traj, fmatrix)`` (reference shapes, squeezed).
    """
    ic = jnp.atleast_2d(jnp.asarray(ic))
    B, n = ic.shape
    tg = _normalize_tg_ic(tg_ic, B, n)

    n_orig = B
    if mesh is not None and mesh.devices.size > 1 and B >= mesh.devices.size:
        from qgs_jax.parallel.mesh import shard_ensemble
        ic, n_orig = shard_ensemble(ic, mesh)
        tg, _ = shard_ensemble(tg, mesh)

    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()

    time = time_grid(t0, t, dt)
    directed = time if forward else time[::-1]
    tts, dts = directed[:-1], np.diff(directed)

    scan_fn = _get_tgls_scan(f, fjac, a, b, c, write_steps, adjoint, inverse, boundary)
    td_all = jnp.stack([jnp.asarray(tts), jnp.asarray(dts)], axis=1)
    _, recs = scan_fn((ic, tg), td_all)
    traj = jnp.moveaxis(recs[0][:, :n_orig], 0, -1)    # (B, ndim, n_records)
    fmat = jnp.moveaxis(recs[1][:, :n_orig], 0, -1)    # (B, ndim, n_tg, n_records)

    if not forward:
        traj = traj[..., ::-1]
        fmat = fmat[..., ::-1]

    if write_steps > 0:
        rec = _record_indices(len(time), write_steps)
        rec_times = time[rec] if forward else time[::-1][rec][::-1]
        return rec_times, jnp.squeeze(traj), jnp.squeeze(fmat)
    return time[-1], jnp.squeeze(traj), jnp.squeeze(fmat)
