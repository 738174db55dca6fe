"""
Two-float (double-float) arithmetic and contraction kernels
===========================================================

This module implements the classical *double-float* representation — a
value is an unevaluated sum ``hi + lo`` of two float32 — with error-free
transformations (Knuth two-sum, Dekker/Veltkamp split product), giving a
~48-bit effective mantissa from float32 arithmetic.  Whether it earns its
place beside native float64 is decided per platform by measurement (see
:mod:`qgs_jax.utils.backend` and ``chip_smoke.py``'s phase 3).

The tendency contraction is laid out for this arithmetic:

* the state is gathered at the tensor's nonzero coordinates — gathers are
  exact by definition;
* products and the per-row reduction run element-wise in double-float
  arithmetic (the only place precision is actually needed).

All tiers (float32, double-float, float64) share the same
host-precomputed tensor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qgs_jax.utils.backend import backend_policy
from qgs_jax.utils.sparse import COO

_SPLIT = np.float32(4097.0)        # Veltkamp split constant for float32 (2^12 + 1)


# ---------------------------------------------------------------------------
# error-free transformations (all float32 in / float32 out)
# ---------------------------------------------------------------------------

def _opaque(x):
    """Hide a value's defining expression from XLA's simplifier/fuser.

    XLA may rewrite patterns like ``(a + b) - a -> b`` or FMA-contract a
    multiply-add differently at each use site — valid for reals,
    catastrophic for error-free transformations (the rounding-error terms
    fold to zero; observed under ``jit``).  NOTE: the XLA **CPU** backend
    strips these barriers during compilation, so compiled CPU double-float
    results carry ~1e-11-per-step extra error; what XLA:GPU does with
    them is recorded in :mod:`qgs_jax.utils.backend`."""
    return jax.lax.optimization_barrier(x)


def two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly.

    The inputs and the sum are pinned with one optimization barrier: the
    EFT uses each value at several sites, and XLA's simplifier/fuser may
    otherwise rewrite ``(a + b) - a -> b`` or materialize *different* FMA
    contractions of the same expression at different uses, breaking the
    exact-error invariant."""
    a, b = _opaque((a, b))
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Fast two-sum, requires |a| >= |b| (same barrier rationale as
    :func:`two_sum`)."""
    a, b = _opaque((a, b))
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Split a float32 into two ~12-bit-mantissa halves (hi + lo == a
    exactly).

    Implemented by masking the low 12 mantissa bits instead of the
    classical Veltkamp multiply (``t = 4097a; hi = t - (t - a)``): XLA's
    fuser may contract ``t - a`` into an FMA, which computes the
    subtraction *exactly* and silently destroys the split (observed under
    ``jit``).  The bitmask is exact, fusion-proof and
    cheaper."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000), jnp.float32)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker product: p + err == a * b exactly (no FMA needed)."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# ---------------------------------------------------------------------------
# double-float ops: values are (hi, lo) pairs of float32 arrays
# ---------------------------------------------------------------------------

def df_add(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return quick_two_sum(s, e)


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return quick_two_sum(p, e)


def df_scale(x, c):
    """Multiply by an exactly-representable float32 scalar."""
    p, e = two_prod(x[0], c)
    e = e + x[1] * c
    return quick_two_sum(p, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_from_f64(a):
    """float64 array -> (hi, lo) float32 pair.

    ``hi`` passes through an optimization barrier: XLA:GPU may otherwise
    fold the f64 -> f32 -> f64 round trip of ``hi`` away (it allows excess
    precision by default), which makes ``lo`` zero and silently drops the
    low half of every value converted inside ``jit`` (measured on an
    H100: 1.5e-9 split error, 1.7e-10 after 100 MAOOAM steps)."""
    hi = _opaque(jnp.asarray(a, dtype=jnp.float32))
    lo = jnp.asarray(a - hi.astype(jnp.float64), dtype=jnp.float32)
    return hi, lo


def df_to_f64(x):
    return x[0].astype(jnp.float64) + x[1].astype(jnp.float64)


def df_const(value):
    """Python float -> scalar (hi, lo) pair."""
    hi = np.float32(value)
    lo = np.float32(value - np.float64(hi))
    return jnp.float32(hi), jnp.float32(lo)


def df_div_scalar(x, c):
    """Divide a double-float by an exactly-representable float32 scalar
    (classical long-division correction: one rounded quotient + exact
    remainder via two-prod)."""
    c = jnp.float32(c)
    q = x[0] / c
    p, e = two_prod(q, jnp.broadcast_to(c, jnp.shape(q)))
    r = ((x[0] - p) - e + x[1]) / c
    return quick_two_sum(q, r)


def df_reduce_last(x):
    """Pairwise double-float sum over the trailing axis (any width).

    Odd widths carry their leftover lane to a final combine, so no
    power-of-two padding is required (the previous tree silently dropped
    lanes for widths like 24)."""
    hi, lo = x
    width = hi.shape[-1]
    carries = []
    while width > 1:
        half = width // 2
        if width % 2:
            carries.append((hi[..., -1], lo[..., -1]))
        hi, lo = df_add((hi[..., :half], lo[..., :half]),
                        (hi[..., half:2 * half], lo[..., half:2 * half]))
        width = half
    out = (hi[..., 0], lo[..., 0])
    for c in carries:
        out = df_add(out, c)
    return out


def _sloppy_add(x, y):
    """Double-float add without the trailing renormalization: the hi parts
    are combined with an exact two-sum, the error and lo parts accumulate
    into an *unnormalized* lo (|lo| may grow to a few ulp of hi).  Used for
    short reduction trees where one final renormalization suffices; halves
    the barrier/op count of :func:`df_add`."""
    s, e = two_sum(x[0], y[0])
    return s, e + x[1] + y[1]


def _sloppy_reduce_last(x):
    """Pairwise trailing-axis sum with unnormalized intermediate lo parts;
    the result IS renormalized (safe to feed into normalized df ops)."""
    hi, lo = x
    width = hi.shape[-1]
    carries = []
    while width > 1:
        half = width // 2
        if width % 2:
            carries.append((hi[..., -1], lo[..., -1]))
        hi, lo = _sloppy_add((hi[..., :half], lo[..., :half]),
                             (hi[..., half:2 * half], lo[..., half:2 * half]))
        width = half
    out = (hi[..., 0], lo[..., 0])
    for c in carries:
        out = _sloppy_add(out, c)
    return quick_two_sum(out[0], out[1])


def _sloppy_mul(x, y):
    """Double-float product without the trailing renormalization (exact
    two-prod of the hi parts + first-order cross terms)."""
    p, e = two_prod(x[0], y[0])
    return p, e + (x[0] * y[1] + x[1] * y[0])


def _presplit(hi_np):
    """Host-side bitmask split of constant float32 values (see
    :func:`split` — identical arithmetic, done once at build time)."""
    hi_np = np.asarray(hi_np, np.float32)
    s_hi = (hi_np.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    return s_hi, hi_np - s_hi


def _mul_const(vc, y, sloppy):
    """Double-float product of precomputed constants with y.

    ``vc = (vhi, vlo, vhi_split_hi, vhi_split_lo)`` — the constants'
    Veltkamp split is done on host at build time, saving one split per
    slot per evaluation (the values are the tendency-tensor entries, fixed
    for the model's lifetime)."""
    vhi, vlo, shi, slo = vc
    p = vhi * y[0]
    bhi, blo = split(y[0])
    err = ((shi * bhi - p) + shi * blo + slo * bhi) + slo * blo
    e = err + (vhi * y[1] + vlo * y[0])
    return (p, e) if sloppy else quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# contraction layout
# ---------------------------------------------------------------------------
#
# Like the float32/float64 kernels (:mod:`qgs_jax.ops.contraction`), every
# double-float kernel below returns a :class:`~qgs_jax.ops.contraction.
# Contraction`: the packed index tables and pre-split value constants live
# in an ``.operands`` pytree threaded through jit as *arguments*, and the
# pure ``.apply`` is cached by a structural ``.key`` — so same-shape models
# (new parameter values, same sparsity layout) share one compiled
# executable instead of recompiling, and large tensors are shipped as
# device data rather than serialized into the XLA program.

from qgs_jax.ops.contraction import (Contraction, _bucketed_layout,
                                     _cached_apply)


def _idx32(a):
    """Index arrays as int32 (mode counts are far below 2^31): half the
    gather-index traffic of int64."""
    return np.asarray(a, np.int32)


def _one_hot_gather_matrix(idx, n1):
    """(n1, R) index array -> (n1, n1*R) one-hot gather matrix G with
    G[j, flat(i, r)] = 1 iff idx[i, r] == j.  A matmul with G is an exact
    gather (single nonzero per column -> no accumulation rounding)."""
    flat = idx.reshape(-1)
    G = np.zeros((n1, flat.size), dtype=np.float32)
    G[flat, np.arange(flat.size)] = 1.0
    return G


def _df_value_consts(flat_vals):
    """Device constants for a bucket's tensor values: the (hi, lo)
    double-float pair plus hi's Veltkamp split, computed on host once (the
    values are fixed for the model's lifetime) — saves one split per slot
    per evaluation."""
    vhi_np = np.asarray(flat_vals, np.float32)
    shi_np, slo_np = _presplit(vhi_np)
    return tuple(jnp.asarray(a, jnp.float32)[None, :] for a in
                 (vhi_np, flat_vals - vhi_np.astype(np.float64),
                  shi_np, slo_np))


def _df_prep_buckets(buckets, n1, gather):
    """Device operands + static shape descriptor for a bucket list: packed
    take indices (hi block then lo block of the concatenated (B, 2*n1)
    state), pre-split value constants, optional one-hot gather matrices."""
    bops, desc = [], []
    for row_ids, vals, idxs, R_g in buckets:
        flat = [a.reshape(-1) for a in idxs]
        entry = {
            "packed": tuple(jnp.asarray(_idx32(np.concatenate([a, a + n1])))
                            for a in flat),
            "vc": _df_value_consts(vals.reshape(-1)),
        }
        if gather == "matmul":
            entry["onehot"] = tuple(
                jnp.asarray(_one_hot_gather_matrix(a, n1)) for a in idxs)
        bops.append(entry)
        desc.append((row_ids.size, R_g))
    return tuple(bops), tuple(desc)


def _resolve_accumulate(accumulate):
    if accumulate == "auto":
        return backend_policy().accumulate
    return accumulate


def make_df_quadratic(tensor: COO, gather="take", accumulate="auto",
                      factor_pairs="auto"):
    """Double-float tendency contraction
    ``f(xx_hi, xx_lo) -> (out_hi, out_lo)`` over the full (dummy-padded)
    state, built on exact gathers + double-float arithmetic.  Works for
    ANY tensor rank >= 2 — the rank-5 T4 / dynamic-T quartic tendencies run
    through the same machinery (ref ``qgs/functions/sparse_mul.py:85-158``
    runs them at full f64; this is the matching-precision fast tier).

    Entries are grouped by their number ``d`` of non-dummy trailing
    indices (an index 0 gathers the exact constant ``x[0] == 1``, so
    constants fold into the ``d = 1`` group): a group-``d`` entry costs
    ``d`` gathers and ``d`` double-float products.  For rank 3 this is
    exactly the linear/bilinear split; rank 5 adds cubic/quartic groups.
    Each group's rows are compacted into count-buckets (see
    :func:`_bucketed_layout`) and reduced per-row with a pairwise tree.
    The hi and lo components are gathered with ONE take per index set from
    the concatenated (B, 2*n1) state (fewer gather kernels).

    ``gather``: 'take' uses real gather ops (exact by definition);
    'matmul' uses one-hot matmuls at HIGHEST precision (a reduced-precision
    matmul, such as TF32 at DEFAULT precision on a GPU, would truncate the
    gathered values and destroy the double-float accuracy).

    ``accumulate``: 'fast' skips the intermediate renormalizations inside
    the products and reduction trees (one renormalization per row sum;
    ~2x fewer barriers/ops, error still ~2^-45 relative for these short
    trees when the barriers hold); 'strict' renormalizes after every
    double-float op.  'auto' (default) takes the platform's value from
    :func:`qgs_jax.utils.backend.backend_policy`: the XLA **CPU** backend
    strips the EFT barriers, which costs 'fast' the two-sum error terms
    entirely (~1e-8 rel measured) while 'strict' degrades only mildly.

    ``factor_pairs``: for groups with d >= 3 active indices (the quartic
    T4 entries), factor the index products through a shared PAIR alphabet
    (p_q = x_a * x_b computed once per evaluation): each slot then costs
    ceil(d/2) gathers + ceil(d/2) df products instead of d of each — the
    rank-5 analogue of "keep it factored" (SURVEY §7).  'auto' enables it
    whenever such groups exist (gather='take' only); rank-3 tensors are
    untouched."""
    n1 = tensor.shape[0]
    rank = tensor.rank
    if rank < 2:
        raise ValueError(f"need a tensor of rank >= 2, got rank {rank}")
    accumulate = _resolve_accumulate(accumulate)
    sloppy = accumulate == "fast"
    mul = _sloppy_mul if sloppy else df_mul
    reduce_last = _sloppy_reduce_last if sloppy else df_reduce_last

    coords = [np.asarray(c) for c in tensor.coords]
    rows = coords[0]
    data = np.asarray(tensor.data)

    d_list = []
    if rows.size:
        trailing = np.stack(coords[1:], axis=0)            # (r-1, nnz)
        d_of = np.maximum((trailing != 0).sum(axis=0), 1)
        d_list = sorted(set(int(v) for v in d_of))
    if factor_pairs == "auto":
        factor_pairs = gather == "take" and any(d >= 3 for d in d_list)
    if factor_pairs and gather != "take":
        raise ValueError("factor_pairs requires gather='take'")

    # shared pair alphabet across all factored groups: entry indices
    # (i1..id) with d >= 3 become ceil(d/2) gathers of pair products
    # p = x_a * x_b (plus one leftover single index when d is odd)
    pair_ids = {}                                         # (a, b) -> id

    def pair_id(a, b):
        k = (int(a), int(b))
        if k not in pair_ids:
            pair_ids[k] = len(pair_ids)
        return pair_ids[k]

    groups_ops, groups_desc, group_arrays = [], [], []
    for d in d_list:
        mask = d_of == d
        sel = trailing[:, mask]
        m = int(mask.sum())
        if factor_pairs and d >= 3:
            d_eff = (d + 1) // 2
            idx_cols = np.zeros((d_eff, m), np.int64)
            for e in range(m):
                nzidx = sel[:, e][sel[:, e] != 0]
                for h in range(d // 2):
                    # pair ids offset past the state block (n1) — resolved
                    # to absolute alphabet positions after the alphabet is
                    # complete
                    idx_cols[h, e] = n1 + pair_id(nzidx[2 * h],
                                                  nzidx[2 * h + 1])
                if d % 2:
                    idx_cols[d_eff - 1, e] = nzidx[-1]
        else:
            d_eff = d
            # the entry's d active indices in their original axis order,
            # padded with 0 (exact x[0] == 1 gathers) for constants
            idx_cols = np.zeros((d, m), np.int64)
            for e in range(m):
                nzidx = sel[:, e][sel[:, e] != 0]
                idx_cols[:nzidx.size, e] = nzidx
        group_arrays.append((d_eff, rows[mask], data[mask], idx_cols))

    n_pairs = len(pair_ids)
    n_ext = n1 + n_pairs                   # gather-alphabet width
    pair_ab = np.zeros((2, max(n_pairs, 1)), np.int64)
    for (a, b), q in pair_ids.items():
        pair_ab[0, q], pair_ab[1, q] = a, b

    for d_eff, g_rows, g_data, idx_cols in group_arrays:
        buckets, perm = _bucketed_layout(g_rows, g_data, list(idx_cols), n1)
        bops, bdesc = _df_prep_buckets(buckets, n_ext, gather)
        groups_ops.append({"perm": jnp.asarray(_idx32(perm)),
                           "buckets": bops})
        groups_desc.append((d_eff, bdesc))
    desc = tuple(groups_desc)
    key = ("df_quad", n1, n_pairs, gather, accumulate, desc)

    operands = {"groups": tuple(groups_ops)}
    if n_pairs:
        operands["pair_a"] = jnp.asarray(_idx32(pair_ab[0]))
        operands["pair_b"] = jnp.asarray(_idx32(pair_ab[1]))

    def build():
        def apply(ops, xx):
            """xx: (hi, lo) of shape (B, n1) -> (hi, lo) of shape (B, n1)."""
            B = xx[0].shape[0]
            if n_pairs:
                # pair products in df, appended to the gather alphabet
                pa, pb = ops["pair_a"], ops["pair_b"]
                xa = (jnp.take(xx[0], pa, axis=1),
                      jnp.take(xx[1], pa, axis=1))
                xb = (jnp.take(xx[0], pb, axis=1),
                      jnp.take(xx[1], pb, axis=1))
                p = mul(xa, xb)
                ext = (jnp.concatenate([xx[0], p[0]], axis=1),
                       jnp.concatenate([xx[1], p[1]], axis=1))
            else:
                ext = xx
            cat = jnp.concatenate([ext[0], ext[1]], axis=1)  # (B, 2*n_ext)

            def gath(packed_idx, G):
                if gather == "take":
                    g = jnp.take(cat, packed_idx, axis=1)
                    half = packed_idx.shape[0] // 2
                    return g[:, :half], g[:, half:]
                mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
                return mm(xx[0], G), mm(xx[1], G)

            out = None
            for (d, bdesc), gops in zip(desc, ops["groups"]):
                parts_hi, parts_lo = [], []
                for (N_g, R_g), bop in zip(bdesc, gops["buckets"]):
                    onehot = bop.get("onehot")
                    X = gath(bop["packed"][0], onehot and onehot[0])
                    t = _mul_const(bop["vc"], X, sloppy)
                    for q in range(1, d):
                        t = mul(t, gath(bop["packed"][q],
                                        onehot and onehot[q]))
                    s = reduce_last((t[0].reshape(B, N_g, R_g),
                                     t[1].reshape(B, N_g, R_g)))
                    parts_hi.append(s[0])
                    parts_lo.append(s[1])
                z = jnp.zeros((B, 1), jnp.float32)
                hi = jnp.concatenate(parts_hi + [z], axis=1)
                lo = jnp.concatenate(parts_lo + [z], axis=1)
                # exact placement: each row lives in exactly one bucket
                g_out = (jnp.take(hi, gops["perm"], axis=1),
                         jnp.take(lo, gops["perm"], axis=1))
                out = g_out if out is None else df_add(out, g_out)
            if out is None:
                z = jnp.zeros((B, n1), jnp.float32)
                return z, z
            return out

        return apply

    return Contraction(_cached_apply(key, build), operands, key)


# ---------------------------------------------------------------------------
# double-float Runge-Kutta steps
# ---------------------------------------------------------------------------

def _pad_dummy(y):
    """Prepend the exact dummy-1 variable to a (hi, lo) state pair."""
    B = y[0].shape[0]
    one = jnp.ones((B, 1), jnp.float32)
    zero = jnp.zeros((B, 1), jnp.float32)
    return (jnp.concatenate([one, y[0]], axis=1),
            jnp.concatenate([zero, y[1]], axis=1))


def _axpy(y, c, k):
    """y + c * k in double-float (c a scalar (hi, lo) pair)."""
    ck = df_mul(k, (jnp.full_like(k[0], c[0]), jnp.full_like(k[0], c[1])))
    return df_add(y, ck)


def _df_split_scalar(dt):
    """Traced float64 scalar -> (hi, lo) float32 pair (exact split; the
    barrier keeps XLA:GPU from folding the round trip, see
    :func:`df_from_f64`)."""
    dt64 = jnp.asarray(dt, jnp.float64)
    hi = _opaque(dt64.astype(jnp.float32))
    return hi, (dt64 - hi.astype(jnp.float64)).astype(jnp.float32)


def _check_explicit_tableau(a, b, c):
    """Validate an explicit Butcher tableau for the double-float steps
    (strictly lower-triangular ``a``); returns float64 arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = len(b)
    if a.shape != (s, s) or c.shape != (s,):
        raise ValueError(
            f"inconsistent Butcher tableau shapes: a {a.shape}, b ({s},), "
            f"c {c.shape}")
    if np.any(np.triu(a) != 0.0):
        raise ValueError(
            "precision='twofloat' supports explicit Runge-Kutta tableaux "
            "only (a must be strictly lower triangular)")
    return a, b, c


def _df_rk4_core(tensor: COO, gather, accumulate):
    """Shared internals of the fused double-float RK4 step: a Contraction
    ``apply(ops, y, dt_df, half_dt, sixth_dt)`` taking the timestep
    constants as (hi, lo) scalar pairs."""
    quad = make_df_quadratic(tensor, gather=gather, accumulate=accumulate)
    key = ("df_rk4_core", quad.key)

    def build():
        qa = quad.apply

        def f(ops, y):
            out = qa(ops, _pad_dummy(y))
            return out[0][:, 1:], out[1][:, 1:]

        def apply(ops, y, dt_df, half_dt, sixth_dt):
            k1 = f(ops, y)
            k2 = f(ops, _axpy(y, half_dt, k1))
            k3 = f(ops, _axpy(y, half_dt, k2))
            k4 = f(ops, _axpy(y, dt_df, k3))
            ksum = df_add(df_add(k1, k4),
                          df_scale(df_add(k2, k3), jnp.float32(2.0)))
            return _axpy(y, sixth_dt, ksum)

        return apply

    return Contraction(_cached_apply(key, build), quad.operands, key)


def make_df_rk4_step(tensor: COO, dt, gather="take", accumulate="auto"):
    """Fused double-float RK4 step over the batched model state
    ``y -> y_new`` with (hi, lo) pairs of shape (B, ndim); ``dt`` is baked
    in at build time (constants computed exactly on host)."""
    core = _df_rk4_core(tensor, gather, accumulate)
    key = ("df_rk4_baked", core.key, float(dt))

    def build():
        ca = core.apply
        dt_df = df_const(dt)
        half_dt = df_const(dt / 2.0)
        sixth_dt = df_const(dt / 6.0)

        def apply(ops, y):
            return ca(ops, y, dt_df, half_dt, sixth_dt)

        return apply

    return Contraction(_cached_apply(key, build), core.operands, key)


def make_df_rk4_step_dynamic(tensor: COO, gather="take", accumulate="auto"):
    """Fused double-float RK4 step ``step(y, tt, dt) -> y_new`` taking the
    timestep as a traced float64 scalar — the signature used by the generic
    scan machinery (:func:`qgs_jax.integrators.rk._scan_chunks`), so the
    final (possibly shorter) grid step and backward integration work.  The
    model is autonomous, ``tt`` is unused."""
    core = _df_rk4_core(tensor, gather, accumulate)
    key = ("df_rk4_dyn", core.key)

    def build():
        ca = core.apply

        def apply(ops, y, tt, dt):
            del tt
            dt_df = _df_split_scalar(dt)
            half_dt = (jnp.float32(0.5) * dt_df[0],
                       jnp.float32(0.5) * dt_df[1])
            sixth_dt = df_div_scalar(dt_df, 6.0)
            return ca(ops, y, dt_df, half_dt, sixth_dt)

        return apply

    return Contraction(_cached_apply(key, build), core.operands, key)


def make_df_rk_step_dynamic(tensor: COO, a, b, c, gather="take",
                            accumulate="auto"):
    """Double-float RK step for an ARBITRARY explicit Butcher tableau
    ``step(y, tt, dt) -> y_new`` (the reference integrates any explicit
    tableau at full precision, ref ``qgs/integrators/integrate.py:29``;
    this closes the twofloat tier's former RK4-only restriction).

    Each tableau coefficient is split into an exact (hi, lo) pair on host;
    the per-stage ``dt * a[i,l]`` products run as scalar double-float
    multiplies (~2^-48 relative, consistent with the tier's promise).  The
    RK4 tableau has a hand-fused fast path — use
    :func:`make_df_rk4_step_dynamic` for it."""
    a, b, c = _check_explicit_tableau(a, b, c)
    quad = make_df_quadratic(tensor, gather=gather, accumulate=accumulate)
    s = len(b)
    key = ("df_rk_dyn", quad.key, a.tobytes(), b.tobytes(), c.tobytes())

    def build():
        qa = quad.apply
        a_consts = [[df_const(float(a[i, l])) for l in range(s)]
                    for i in range(s)]
        b_consts = [df_const(float(b[i])) for i in range(s)]

        def f(ops, y):
            out = qa(ops, _pad_dummy(y))
            return out[0][:, 1:], out[1][:, 1:]

        def apply(ops, y, tt, dt):
            del tt                       # every qgs tendency is autonomous
            dt_df = _df_split_scalar(dt)
            k = []
            for i in range(s):
                y_s = y
                for l in range(i):
                    if a[i, l] != 0.0:
                        y_s = _axpy(y_s, df_mul(dt_df, a_consts[i][l]), k[l])
                k.append(f(ops, y_s))
            y_new = y
            for i in range(s):
                if b[i] != 0.0:
                    y_new = _axpy(y_new, df_mul(dt_df, b_consts[i]), k[i])
            return y_new

        return apply

    return Contraction(_cached_apply(key, build), quad.operands, key)


def make_df_tangent_contraction(jtensor: COO, adjoint=False, inverse=False,
                                accumulate="auto"):
    """Double-float tangent-linear contraction
    ``hom(xx_df, dm_df) -> df (B, n, n_tg)`` with

        hom[b, i, t] = sum_e val_e * (prod_a xx[b, coords[a, e]])
                                   * dm[b, coords[1, e] - 1, t]

    scattered at output row ``coords[0, e] - 1`` — the double-float analogue
    of the Jacobian-tensor tangent system (ref
    ``qgs/integrators/integrate.py:227-231``: ``Df = sparse_mul2(...)`` then
    ``J @ dx`` / ``J^T @ dx`` for the adjoint, ``-J`` for the inverse).
    Instead of materializing the dense Jacobian, the product is contracted
    directly in COO form with the same bucketed-gather layout as the
    quadratic kernel.

    ``xx_df`` is the dummy-padded state (B, n1); ``dm_df`` the tangent block
    (B, n, n_tg) WITHOUT the dummy row (its tangent is identically zero, so
    entries gathering/scattering index 0 are dropped on host).

    ``adjoint`` transposes the Jacobian by swapping the scatter/gather mode
    indices on host; ``inverse`` negates the values on host — both exact,
    zero runtime cost, and both live purely in the operand values (every
    variant of the same shape shares one compiled program).  Works for any
    tensor rank >= 3 (the rank-5 T4 / dynamic-T Jacobians gather the state
    at each trailing coordinate)."""
    n1 = jtensor.shape[0]
    n = n1 - 1
    accumulate = _resolve_accumulate(accumulate)
    sloppy = accumulate == "fast"
    mul = _sloppy_mul if sloppy else df_mul
    reduce_last = _sloppy_reduce_last if sloppy else df_reduce_last

    coords = [np.asarray(c) for c in jtensor.coords]
    data = np.asarray(jtensor.data)
    if inverse:
        data = -data
    if adjoint:
        coords[0], coords[1] = coords[1], coords[0]
    # output row 0 (dummy) is discarded and the dummy's tangent row is 0
    keep = (coords[0] != 0) & (coords[1] != 0)
    rows = coords[0][keep] - 1
    dm_idx = coords[1][keep] - 1
    x_cols = [c[keep] for c in coords[2:]]
    vals = data[keep]

    buckets, perm = _bucketed_layout(rows, vals, [dm_idx] + x_cols, n)

    bops, bdesc = [], []
    for row_ids, bvals, idxs, R_g in buckets:
        dm_flat = idxs[0].reshape(-1)
        bops.append({
            "packed_dm": jnp.asarray(_idx32(
                np.concatenate([dm_flat, dm_flat + n]))),
            "packed_xs": tuple(jnp.asarray(_idx32(
                np.concatenate([x.reshape(-1), x.reshape(-1) + n1])))
                for x in idxs[1:]),
            "vc": _df_value_consts(bvals.reshape(-1)),
        })
        bdesc.append((row_ids.size, R_g))
    desc = tuple(bdesc)
    key = ("df_tangent", n1, accumulate, len(coords) - 2, desc)

    def build():
        def apply(ops, xx, dm):
            """xx: df (B, n1); dm: df (B, n, n_tg) -> df (B, n, n_tg)."""
            B = xx[0].shape[0]
            n_tg = dm[0].shape[-1]
            cat_x = jnp.concatenate([xx[0], xx[1]], axis=1)     # (B, 2*n1)
            cat_dm = jnp.concatenate([dm[0], dm[1]], axis=1)    # (B, 2*n, t)

            parts_hi, parts_lo = [], []
            for (N_g, R_g), bop in zip(desc, ops["buckets"]):
                V = bop["vc"]
                packed_xs = bop["packed_xs"]
                # coefficient: val * prod_a xx[k_a]  (df, (B, N_g*R_g))
                if packed_xs:
                    g = jnp.take(cat_x, packed_xs[0], axis=1)
                    half = packed_xs[0].shape[0] // 2
                    t = _mul_const(V, (g[:, :half], g[:, half:]), sloppy)
                    for pk in packed_xs[1:]:
                        g = jnp.take(cat_x, pk, axis=1)
                        half = pk.shape[0] // 2
                        t = mul(t, (g[:, :half], g[:, half:]))
                else:
                    t = (jnp.broadcast_to(V[0], (B, V[0].shape[1])),
                         jnp.broadcast_to(V[1], (B, V[1].shape[1])))
                # tangent gather: (B, N_g*R_g, n_tg)
                gdm = jnp.take(cat_dm, bop["packed_dm"], axis=1)
                half = bop["packed_dm"].shape[0] // 2
                dmg = (gdm[:, :half], gdm[:, half:])
                tt = mul((t[0][..., None], t[1][..., None]), dmg)
                # reduce the R_g slots per output row
                s = reduce_last((
                    tt[0].reshape(B, N_g, R_g, n_tg).swapaxes(-1, -2),
                    tt[1].reshape(B, N_g, R_g, n_tg).swapaxes(-1, -2)))
                parts_hi.append(s[0])
                parts_lo.append(s[1])
            z = jnp.zeros((B, 1, n_tg), jnp.float32)
            hi = jnp.concatenate(parts_hi + [z], axis=1)
            lo = jnp.concatenate(parts_lo + [z], axis=1)
            return (jnp.take(hi, ops["perm"], axis=1),
                    jnp.take(lo, ops["perm"], axis=1))

        return apply

    operands = {"buckets": tuple(bops), "perm": jnp.asarray(_idx32(perm))}
    return Contraction(_cached_apply(key, build), operands, key)


def df_matmul(A, B, sloppy=True):
    """Dense double-float matmul ``(…, m, k) @ (…, k, n) -> (…, m, n)``.

    Expands the k products (df Dekker multiplies) and reduces them with the
    pairwise double-float tree — O(m·k·n) elementwise work with an (…, m, n, k)
    temporary.  Built for the small (B, n, n) blocks of the Lyapunov
    machinery, not for large matrices."""
    mul = _sloppy_mul if sloppy else df_mul
    reduce_last = _sloppy_reduce_last if sloppy else df_reduce_last
    Ah, Al = A[0][..., :, :, None], A[1][..., :, :, None]   # (…, m, k, 1)
    Bh, Bl = B[0][..., None, :, :], B[1][..., None, :, :]   # (…, 1, k, n)
    Ph, Pl = mul((Ah, Al), (Bh, Bl))                        # (…, m, k, n)
    return reduce_last((jnp.swapaxes(Ph, -1, -2),
                        jnp.swapaxes(Pl, -1, -2)))


def _df_t(A):
    return (jnp.swapaxes(A[0], -1, -2), jnp.swapaxes(A[1], -1, -2))


def trisolve_mp(R, B, lower=False):
    """Mixed-precision triangular solve ``R X = B`` (f64 in / f64 out)
    built from two float32 triangular solves.

    Used by the double-float Ginelli backward pass.  Scheme: one batched
    **f32** solve, one **f64 residual** (a matmul), one f32 correction
    solve:

        X0 = solve_f32(R, B);  D = B - R X0;  X = X0 + solve_f32(R, D)

    Relative error ~ eps32^2 cond(R)^2 + eps64 cond(R) — f64-grade for the
    QR-cadence R factors (cond grows only like exp(spread*dt) per
    window)."""
    R32 = R.astype(jnp.float32)
    X0 = jax.scipy.linalg.solve_triangular(
        R32, B.astype(jnp.float32), lower=lower).astype(jnp.float64)
    D = B - jnp.matmul(R, X0, precision=jax.lax.Precision.HIGHEST)
    dX = jax.scipy.linalg.solve_triangular(
        R32, D.astype(jnp.float32), lower=lower)
    return X0 + dX.astype(jnp.float64)


def cholqr_df(M):
    """Mixed-precision CholeskyQR of a double-float matrix stack
    ``M (…, n, k)``: returns ``(Q_df, R64)`` with Q orthonormal to ~1e-14
    and R (upper, float64 values) accurate to ~1e-14 relative — WITHOUT any
    float64 arithmetic: double-float matmuls plus f32 Cholesky and
    triangular solves (``qr_method='mixed'`` of the double-float Benettin
    windows).

    Scheme: the Gram matrix G = M^T M is computed in double-float; its f32
    Cholesky factor L is corrected to first order with
    dL = L Phi(L^{-1} E L^{-T}), E = G - L L^T (Phi = strict lower + half
    diagonal), giving R to ~eps32^2 — the Benettin exponents' source.
    Q solves Q R = M by an f32 triangular solve plus ONE double-float
    residual correction (dQ = (M - Q0 R) R^{-1}, the residual computed in
    df, the correction solve in f32 — relative error eps32 of an
    eps32-sized quantity): Q = M R^{-1} to ~eps32^2, which preserves the
    *flag* (nested column spans) of the full double-float M — the quantity
    the Benettin telescope is first-order sensitive to (feeding forward
    the flag of M_hi alone costs ~1e-7 exponent error, measured) — and
    makes Q orthonormal to ~eps32^2 automatically (Q^T Q = R^{-T} G R^{-1}
    with R^T R = G to eps32^2).
    Requires cond(M)^2 < 1/eps32 (QR-cadence windows satisfy this by
    construction — cond grows like exp(spread * dt) per window)."""
    sloppy = backend_policy().accumulate == "fast"
    Mh, Ml = M
    z = jnp.zeros_like
    G = df_matmul(_df_t(M), M, sloppy=sloppy)
    L = jnp.linalg.cholesky(G[0])
    # E = G - L L^T in df (the L products are exact Dekker two-prods)
    LLt = df_matmul((L, z(L)), (jnp.swapaxes(L, -1, -2), z(L)),
                    sloppy=sloppy)
    E = df_add(G, df_neg(LLt))
    Eh = E[0] + E[1]                        # |E| ~ eps32 |G|: f32 suffices
    X = jax.scipy.linalg.solve_triangular(L, Eh, lower=True)
    X = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(X, -1, -2), lower=True), -1, -2)
    k = L.shape[-1]
    eye = jnp.eye(k, dtype=L.dtype)
    Phi = jnp.tril(X, -1) + 0.5 * X * eye
    dL = jnp.matmul(L, Phi, precision=jax.lax.Precision.HIGHEST)
    R64 = (jnp.swapaxes(L, -1, -2).astype(jnp.float64)
           + jnp.swapaxes(dL, -1, -2).astype(jnp.float64))
    R_df = (jnp.swapaxes(L, -1, -2), jnp.swapaxes(dL, -1, -2))
    # Q R = M: f32 solve + one df residual correction
    Q0 = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(Mh, -1, -2), lower=True), -1, -2)
    D = df_add(M, df_neg(df_matmul((Q0, z(Q0)), R_df, sloppy=sloppy)))
    Dh = D[0] + D[1]                        # |D| ~ eps32 |M|
    dQ = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(Dh, -1, -2), lower=True), -1, -2)
    Q = quick_two_sum(Q0, dQ)
    return Q, R64


def _df_tgls_rk4_core(tensor: COO, jtensor: COO, adjoint, inverse,
                      gather, accumulate):
    """Shared internals of the fused double-float TGLS RK4 step: a
    Contraction ``apply(ops, (y, dm), dt_df, half_dt, sixth_dt)``
    propagating the coupled (trajectory, tangent/fundamental-matrix) system
    in double-float (ref ``qgs/integrators/integrate.py:556-614``)."""
    quad = make_df_quadratic(tensor, gather=gather, accumulate=accumulate)
    tang = make_df_tangent_contraction(jtensor, adjoint=adjoint,
                                       inverse=inverse, accumulate=accumulate)
    key = ("df_tgls_core", quad.key, tang.key)
    operands = {"q": quad.operands, "tg": tang.operands}

    def build():
        qa, ta = quad.apply, tang.apply

        def rhs(ops, y, dm):
            xx = _pad_dummy(y)
            out = qa(ops["q"], xx)
            return (out[0][:, 1:], out[1][:, 1:]), ta(ops["tg"], xx, dm)

        def apply(ops, carry, dt_df, half_dt, sixth_dt):
            y, dm = carry
            k1, m1 = rhs(ops, y, dm)
            k2, m2 = rhs(ops, _axpy(y, half_dt, k1), _axpy(dm, half_dt, m1))
            k3, m3 = rhs(ops, _axpy(y, half_dt, k2), _axpy(dm, half_dt, m2))
            k4, m4 = rhs(ops, _axpy(y, dt_df, k3), _axpy(dm, dt_df, m3))
            two = jnp.float32(2.0)
            ks = df_add(df_add(k1, k4), df_scale(df_add(k2, k3), two))
            ms = df_add(df_add(m1, m4), df_scale(df_add(m2, m3), two))
            return _axpy(y, sixth_dt, ks), _axpy(dm, sixth_dt, ms)

        return apply

    return Contraction(_cached_apply(key, build), operands, key)


def make_df_tgls_rk4_step(tensor: COO, jtensor: COO, dt, adjoint=False,
                          inverse=False, gather="take", accumulate="auto"):
    """Fused double-float TGLS RK4 step ``(y, dm) -> (y', dm')`` with (hi,
    lo) pairs of shape (B, ndim) / (B, ndim, n_tg); ``dt`` baked in (its
    double-float split computed exactly on host).  The model is autonomous
    (every qgs tendency ignores t), so no time argument is carried."""
    core = _df_tgls_rk4_core(tensor, jtensor, adjoint, inverse, gather,
                             accumulate)
    key = ("df_tgls_baked", core.key, float(dt))

    def build():
        ca = core.apply
        dt_df = df_const(dt)
        half_dt = df_const(dt / 2.0)
        sixth_dt = df_const(dt / 6.0)

        def apply(ops, carry):
            return ca(ops, carry, dt_df, half_dt, sixth_dt)

        return apply

    return Contraction(_cached_apply(key, build), core.operands, key)


def make_df_tgls_rk4_step_dynamic(tensor: COO, jtensor: COO, adjoint=False,
                                  inverse=False, gather="take",
                                  accumulate="auto"):
    """Fused double-float TGLS RK4 step ``step(carry, tt, dt) -> carry`` with
    the timestep as a traced float64 scalar — the signature used by
    :func:`qgs_jax.integrators.rk._scan_chunks`."""
    core = _df_tgls_rk4_core(tensor, jtensor, adjoint, inverse, gather,
                             accumulate)
    key = ("df_tgls_dyn", core.key)

    def build():
        ca = core.apply

        def apply(ops, carry, tt, dt):
            del tt
            dt_df = _df_split_scalar(dt)
            half_dt = (jnp.float32(0.5) * dt_df[0],
                       jnp.float32(0.5) * dt_df[1])
            sixth_dt = df_div_scalar(dt_df, 6.0)
            return ca(ops, carry, dt_df, half_dt, sixth_dt)

        return apply

    return Contraction(_cached_apply(key, build), core.operands, key)


def make_df_tgls_rk_step_dynamic(tensor: COO, jtensor: COO, a, b, c,
                                 adjoint=False, inverse=False, gather="take",
                                 accumulate="auto"):
    """Double-float TGLS step for an ARBITRARY explicit Butcher tableau
    ``step((y, dm), tt, dt) -> (y', dm')`` — the coupled analogue of
    :func:`make_df_rk_step_dynamic` (tableau coefficients split exactly on
    host, ``dt * coeff`` as scalar double-float products)."""
    a, b, c = _check_explicit_tableau(a, b, c)
    quad = make_df_quadratic(tensor, gather=gather, accumulate=accumulate)
    tang = make_df_tangent_contraction(jtensor, adjoint=adjoint,
                                       inverse=inverse, accumulate=accumulate)
    s = len(b)
    key = ("df_tgls_rk_dyn", quad.key, tang.key, a.tobytes(), b.tobytes(),
           c.tobytes())
    operands = {"q": quad.operands, "tg": tang.operands}

    def build():
        qa, ta = quad.apply, tang.apply
        a_consts = [[df_const(float(a[i, l])) for l in range(s)]
                    for i in range(s)]
        b_consts = [df_const(float(b[i])) for i in range(s)]

        def rhs(ops, y, dm):
            xx = _pad_dummy(y)
            out = qa(ops["q"], xx)
            return (out[0][:, 1:], out[1][:, 1:]), ta(ops["tg"], xx, dm)

        def apply(ops, carry, tt, dt):
            del tt
            y, dm = carry
            dt_df = _df_split_scalar(dt)
            k, km = [], []
            for i in range(s):
                y_s, dm_s = y, dm
                for l in range(i):
                    if a[i, l] != 0.0:
                        cdf = df_mul(dt_df, a_consts[i][l])
                        y_s = _axpy(y_s, cdf, k[l])
                        dm_s = _axpy(dm_s, cdf, km[l])
                ki, mi = rhs(ops, y_s, dm_s)
                k.append(ki)
                km.append(mi)
            y_new, dm_new = y, dm
            for i in range(s):
                if b[i] != 0.0:
                    cdf = df_mul(dt_df, b_consts[i])
                    y_new = _axpy(y_new, cdf, k[i])
                    dm_new = _axpy(dm_new, cdf, km[i])
            return y_new, dm_new

        return apply

    return Contraction(_cached_apply(key, build), operands, key)
