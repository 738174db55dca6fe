"""
Tensor-contraction kernels (device compute path)
================================================

The entire model reduces to contractions of the precomputed tendency tensor
with the state vector ``xx = [1, x]``:

* tendencies:    f_i  = sum_{jk}  T[i,j,k] xx_j xx_k            (rank 3)
* Jacobian:      J_im = sum_{j}  JT[i,j,m] xx_j                 (rank 3)
* T^4 variants:  rank-5 analogues.

This module provides interchangeable device implementations:

* **bucketed** (the auto mode): count-bucketed gather/row-sum — rows
  grouped by exact nonzero count (no padding slots), entries grouped by
  active-index count, rank-5 quartic entries pair-factored through a
  shared pair alphabet; each bucket's gather, multiply and reduction fuse
  into one kernel.  This replaces the reference's Numba scalar COO loop
  (ref ``qgs/functions/sparse_mul.py:14-158``).
* **dense**: the densified tensor matricized into one
  (B, n1^2) x (n1^2, n1) matmul.
* **coo (gather-scatter)**: gather at the nonzero coordinates, multiply,
  scatter-add through a precomputed one-hot matrix (a single
  (B, nnz) x (nnz, n) matmul).
* **rowsum / rowsum_fm**: flat row-grouped gathers + an elementwise per-row
  reduction (kept as comparison rows).
* **pairsum**: the pair-factored quartic kernel on the flat layout.

Tensor buffers are ARGUMENTS, not baked constants
-------------------------------------------------
Every factory returns a :class:`Contraction`: a callable whose device
buffers (tensor values, index tables, one-hot matrices) live in a
``.operands`` pytree and whose computation is a pure ``.apply(operands,
*args)``.  Jitted consumers (the integrator scans, ``jit_contraction``)
thread ``.operands`` through as arguments instead of closing over them, so

* the tensor is shipped to the device as data, not serialized into the
  XLA program, so program size does not grow with the mode count, and
* executables are cached by the *structural* ``.key`` (kernel kind,
  shapes, dtype, precision): a new parameter set of the same resolution
  reuses the already-compiled program with new operand values — no
  recompile per configuration.

All functions are batched over a leading ensemble axis; vmap/jit compose.
"""

from __future__ import annotations

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np

from qgs_jax.utils.sparse import COO


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _resolve_precision(precision):
    """Matmul precision for the contraction kernels.  At DEFAULT precision
    XLA:GPU may run an f32 matmul in TF32 (10-bit mantissa, ~1e-3
    relative), which would silently break the float32 tier's ~1e-6
    promise: the one-hot matmuls of the Jacobian scatter and the dense
    path would round every tensor value.  Default HIGHEST (true f32);
    pass 'default' explicitly where tendency-level accuracy does not
    matter."""
    return jax.lax.Precision.HIGHEST if precision is None else precision


# ---------------------------------------------------------------------------
# operand-threading machinery
# ---------------------------------------------------------------------------

class Contraction:
    """A contraction kernel whose device buffers are jit *arguments*.

    ``apply(operands, *args)`` is the pure computation; ``operands`` is a
    pytree of device arrays (tensor values / index tables); ``key`` is a
    hashable structural descriptor (kernel kind + static shapes + dtype +
    precision) under which compiled executables are shared — two models
    with the same key differ only in operand *values*, so they can (and
    do) run the same compiled program.

    Calling the object directly evaluates ``apply(self.operands, *args)``
    eagerly (or inlined, inside an outer trace)."""

    __slots__ = ("apply", "operands", "key", "__weakref__")

    def __init__(self, apply, operands, key):
        self.apply = apply
        self.operands = operands
        self.key = key

    def __call__(self, *args):
        return self.apply(self.operands, *args)


_APPLY_CACHE = OrderedDict()
_APPLY_CACHE_MAX = 256


def _cached_apply(key, build):
    """One apply function per structural key: instances sharing a key share
    the function object, which is what lets downstream ``jax.jit`` caches
    (keyed on function identity) serve every same-structure model from one
    compiled executable."""
    fn = _APPLY_CACHE.get(key)
    if fn is None:
        fn = build()
        _APPLY_CACHE[key] = fn
        while len(_APPLY_CACHE) > _APPLY_CACHE_MAX:
            _APPLY_CACHE.popitem(last=False)
    return fn


_JIT_CACHE = OrderedDict()
_JIT_CACHE_MAX = 256


def jit_contraction(c):
    """Jit a :class:`Contraction`, threading its operands as call-time
    arguments; the jitted executable is shared across every Contraction
    with the same structural key.  Plain callables fall back to a regular
    ``jax.jit``.  The returned wrapper re-exports ``apply`` / ``operands``
    / ``key`` so integrator scan caches can thread the operands further."""
    apply = getattr(c, "apply", None)
    if apply is None:
        return jax.jit(c)
    jitted = _JIT_CACHE.get(c.key)
    if jitted is None:
        jitted = jax.jit(apply)
        _JIT_CACHE[c.key] = jitted
        while len(_JIT_CACHE) > _JIT_CACHE_MAX:
            _JIT_CACHE.popitem(last=False)

    operands = c.operands

    def fn(*args):
        return jitted(operands, *args)

    fn.apply = apply
    fn.operands = operands
    fn.key = c.key
    return fn


def _dtype_key(dtype):
    return np.dtype(dtype).name


def _prec_key(precision):
    return str(precision)


def _idx(a):
    """Index arrays as int32 (mode counts are far below 2^31): half the
    gather-index traffic of int64."""
    return np.asarray(a, np.int32)


# ---------------------------------------------------------------------------
# Dense rank-3 kernels
# ---------------------------------------------------------------------------

def _dense_matricized(tensor: COO, np_dtype, layout):
    """Assemble the matricized dense tensor directly in the target dtype
    (no (n1)^3 float64 intermediate).

    ``layout='jk_i'``: out[j*n1+k, i] = T[i,j,k]  (quadratic contraction)
    ``layout='k_ij'``: out[k, i*n1+j] = T[i,j,k]  (bilinear / Jacobian)
    """
    n1 = tensor.shape[0]
    i, j, k = tensor.coords[0], tensor.coords[1], tensor.coords[2]
    if layout == "jk_i":
        out = np.zeros((n1 * n1, n1), dtype=np_dtype)
        np.add.at(out, (j * n1 + k, i), tensor.data.astype(np_dtype))
    else:
        out = np.zeros((n1, n1 * n1), dtype=np_dtype)
        np.add.at(out, (k, i * n1 + j), tensor.data.astype(np_dtype))
    return out


def make_dense_quadratic(tensor: COO, dtype=None, precision=None):
    """Return ``f(xx) -> out`` with ``out[b,i] = sum_jk T[i,j,k] xx[b,j] xx[b,k]``.

    The matricized (n1^2, n1) tensor is an operand (device argument), so
    high-resolution configurations neither blow up the compile request nor
    recompile when the parameters change (one executable per shape)."""
    dtype = dtype or _default_dtype()
    precision = _resolve_precision(precision)
    n1 = tensor.shape[0]
    key = ("dense_quad", n1, _dtype_key(dtype), _prec_key(precision))

    def build():
        def apply(ops, xx):
            outer = (xx[:, :, None] * xx[:, None, :]).reshape(
                xx.shape[0], n1 * n1)
            return jnp.matmul(outer, ops["T2T"], precision=precision)

        return apply

    T2T = jnp.asarray(_dense_matricized(tensor, np.dtype(dtype), "jk_i"))
    return Contraction(_cached_apply(key, build), {"T2T": T2T}, key)


def make_dense_bilinear(jtensor: COO, dtype=None, precision=None):
    """Return ``J(xx) -> (B, n1, n1)`` with ``J[b,i,j] = sum_k JT[i,j,k] xx[b,k]``
    (reference convention: the Jacobian column is axis 1 of the jacobian
    tensor, contraction over the trailing axis, ref ``sparse_mul.py:14-45``)."""
    dtype = dtype or _default_dtype()
    precision = _resolve_precision(precision)
    n1 = jtensor.shape[0]
    key = ("dense_bil", n1, _dtype_key(dtype), _prec_key(precision))

    def build():
        def apply(ops, xx):
            return jnp.matmul(xx, ops["J2"], precision=precision).reshape(
                xx.shape[0], n1, n1)

        return apply

    J2 = jnp.asarray(_dense_matricized(jtensor, np.dtype(dtype), "k_ij"))
    return Contraction(_cached_apply(key, build), {"J2": J2}, key)


# ---------------------------------------------------------------------------
# COO gather-scatter kernels (any rank)
# ---------------------------------------------------------------------------

def _empty_contraction(n1, dtype):
    key = ("empty", n1, _dtype_key(dtype))

    def build():
        def apply(ops, xx):
            return jnp.zeros((xx.shape[0], n1), dtype=dtype)

        return apply

    return Contraction(_cached_apply(key, build), {}, key)


def make_coo_contraction(tensor: COO, dtype=None, precision=None):
    """Return ``f(xx) -> out`` for a COO tensor of any rank r >= 2:
    ``out[b, i] = sum_e val[e] * prod_{axis=1..r-1} xx[b, coords[axis, e]]``.

    The scatter to the output index runs as a dense matmul with a one-hot
    (nnz, n1) matrix — deterministic summation order."""
    dtype = dtype or _default_dtype()
    precision = _resolve_precision(precision)
    coords = tensor.coords
    rank = tensor.rank
    n1 = tensor.shape[0]
    if tensor.nnz == 0:
        return _empty_contraction(n1, dtype)

    nnz = tensor.nnz
    key = ("coo_quad", n1, rank, nnz, _dtype_key(dtype), _prec_key(precision))

    def build():
        def apply(ops, xx):
            prod = ops["val"][None, :]
            for idx in ops["idxs"]:
                prod = prod * xx[:, idx]
            return jnp.matmul(prod, ops["S"], precision=precision)

        return apply

    scatter = np.zeros((nnz, n1), dtype=np.dtype(dtype))
    scatter[np.arange(nnz), coords[0]] = 1.0
    operands = {
        "val": jnp.asarray(tensor.data, dtype=dtype),
        "idxs": tuple(jnp.asarray(_idx(coords[axis]))
                      for axis in range(1, rank)),
        "S": jnp.asarray(scatter),
    }
    return Contraction(_cached_apply(key, build), operands, key)


def default_max_buckets():
    """Default bucket-ladder size (env ``QGS_BUCKET_MAX``).  Program size
    — and thus compile latency at high resolution — scales with
    the bucket count (one gather/reduce subgraph per bucket); padding
    waste shrinks with it.  With the optimal-DP ladder placement below,
    16 buckets cost well under 1% extra slots on the qgs tensors
    (measured at ndim 228-754), so 16 is the default (r04's quantile
    ladder needed 48 for ~0.1%; compile time dropped proportionally)."""
    import os
    return int(os.environ.get("QGS_BUCKET_MAX", "16"))


def _count_thresholds(counts, max_buckets):
    """Optimal count ladder for :func:`_bucketed_layout`: at most
    ``max_buckets`` thresholds over the distinct nonzero row counts.
    Rows pad up to their threshold with zero slots (contributing exactly
    0 — bit-identical results), so the ladder is chosen by dynamic
    programming to minimize the TOTAL number of padded slots, weighted by
    how many rows carry each count — strictly better placement than a
    count-quantile ladder at the same size, which is what lets the
    default size (and with it program size / compile time) drop."""
    counts = np.asarray(counts)
    nzc = counts[counts > 0]
    distinct, w = np.unique(nzc, return_counts=True)        # ascending
    m = distinct.size
    if m <= max_buckets:
        return [int(c) for c in distinct]
    d = distinct.astype(np.float64)
    W = np.concatenate([[0.0], np.cumsum(w.astype(np.float64))])
    S = np.concatenate([[0.0], np.cumsum(w * d)])
    # dp over "first j distinct counts covered by t thresholds"; a segment
    # (i, j] pads its rows to distinct[j-1]:
    #   cost(i, j) = d[j-1] * (W[j] - W[i]) - (S[j] - S[i])
    K = int(max_buckets)
    dp = np.full(m + 1, np.inf)
    dp[0] = 0.0
    parents = []
    for _ in range(K):
        ndp = np.full(m + 1, np.inf)
        par = np.zeros(m + 1, np.int64)
        for j in range(1, m + 1):
            cand = dp[:j] + d[j - 1] * (W[j] - W[:j]) - (S[j] - S[:j])
            k = int(np.argmin(cand))
            ndp[j] = cand[k]
            par[j] = k
        parents.append(par)
        dp = ndp
    # walk the segment right-endpoints back from j = m (the max count is
    # always a threshold)
    thresholds = []
    j = m
    for par in reversed(parents):
        if j == 0:
            break
        thresholds.append(int(distinct[j - 1]))
        j = int(par[j])
    return sorted(thresholds)


def _bucketed_layout(rows, data, idx_cols, n1, max_buckets=None,
                     thresholds=None):
    """Compact a group's entries into count-buckets.

    A flat (n1, R_max) layout wastes 1.6-3.1x of its slots on zero padding
    for the qgs tensors (per-row counts are skewed — measured in
    RESOLUTION_r04.json ``padded_slots``), and every padding slot costs
    real gather traffic.  Instead, rows are bucketed by entry count (one
    bucket per distinct count — fully dense) and each bucket gets its own
    (n_rows_g, R_g) layout over only its own rows; empty rows occupy
    nothing.  Results are re-assembled into the (B, n1) output with a
    static column permutation (each row lives in exactly one bucket, so
    assembly is exact placement, no accumulation).

    ``max_buckets`` bounds the program size: every bucket emits its own
    gather/reduce subgraph, and high-resolution tensors have hundreds of
    distinct row counts (the double-float kernel at ndim 228 took ~15 min
    to compile with exact buckets).  Beyond the bound, thresholds
    are placed by the DP of :func:`_count_thresholds` (minimum total
    padded slots) — rows pad up to their threshold with zero slots, which
    contribute exactly 0 (bit-identical results, a few percent extra
    slots).  The default bound comes from :func:`default_max_buckets`
    (env ``QGS_BUCKET_MAX``, 16).

    Returns ``(buckets, perm)`` where each bucket is
    ``(row_ids, vals (N_g, R_g), [idx arrays (N_g, R_g)...], R_g)`` and
    ``perm`` maps output column i to its position in the concatenated
    bucket results (with one trailing zero column for empty rows).

    ``thresholds`` overrides the count ladder (it must cover the maximum
    row count) — the model-axis sharded kernel passes the GLOBAL ladder so
    every device shard uses identical bucket shapes."""
    rows = np.asarray(rows)
    data = np.asarray(data)
    counts = np.bincount(rows, minlength=n1)
    buckets = []
    if rows.size:
        if thresholds is None:
            if max_buckets is None:
                max_buckets = default_max_buckets()
            thresholds = _count_thresholds(counts, max_buckets)
        thr = np.asarray(thresholds)
        # smallest threshold >= count, per row
        row_thr = np.zeros(n1, np.int64)
        nz = counts > 0
        row_thr[nz] = thr[np.searchsorted(thr, counts[nz])]
        # single O(nnz log nnz) pass: stable-sort entries by row (original
        # order preserved within each row — the deterministic slot order),
        # compute each entry's occurrence index within its row, then place
        # every bucket with pure fancy indexing (the former per-bucket
        # entry rescan was O(nnz * n_buckets) of Python loop — seconds of
        # host time per model at ndim 600+)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        run_starts = np.concatenate(
            ([0], np.cumsum(np.bincount(sorted_rows, minlength=n1))))
        occ = np.arange(rows.size) - run_starts[sorted_rows]
        entry_thr = row_thr[sorted_rows]
        for R_g in thresholds:
            row_ids = np.nonzero(nz & (row_thr == R_g))[0]
            if row_ids.size == 0:
                continue
            pos_of_row = np.full(n1, -1, np.int64)
            pos_of_row[row_ids] = np.arange(row_ids.size)
            sel = entry_thr == R_g
            p = pos_of_row[sorted_rows[sel]]
            slot = occ[sel]
            e_sel = order[sel]
            vals = np.zeros((row_ids.size, R_g))
            vals[p, slot] = data[e_sel]
            idxs = []
            for col in idx_cols:
                a = np.zeros((row_ids.size, R_g), np.int64)
                a[p, slot] = np.asarray(col)[e_sel]
                idxs.append(a)
            buckets.append((row_ids, vals, idxs, R_g))
    n_cols = sum(b[0].size for b in buckets)
    perm = np.full(n1, n_cols, np.int64)          # default: the zero column
    off = 0
    for row_ids, *_ in buckets:
        perm[row_ids] = off + np.arange(row_ids.size)
        off += row_ids.size
    return buckets, perm


def _active_index_groups(tensor, factor_pairs):
    """Group the tensor's entries by their number ``d`` of non-dummy
    trailing indices (index 0 gathers the exact constant x[0] == 1, so
    pure constants fold into d = 1 by gathering index 0).  With
    ``factor_pairs``, groups with d >= 3 are rewritten through a shared
    pair alphabet: ceil(d/2) gathers of precomputed pair products
    p = x_a * x_b instead of d state gathers.

    Returns ``(groups, pair_ab, n_ext)`` with groups a list of
    ``(d_eff, rows, data, idx_cols (d_eff, m))``; index values >= n1
    reference the pair block of the extended gather alphabet
    ``[x, p]`` of width ``n_ext``."""
    n1 = tensor.shape[0]
    coords = [np.asarray(c) for c in tensor.coords]
    rows = coords[0]
    data = np.asarray(tensor.data)
    groups = []
    pair_ids = {}

    def pair_id(a, b):
        k = (int(a), int(b))
        if k not in pair_ids:
            pair_ids[k] = len(pair_ids)
        return pair_ids[k]

    if rows.size:
        trailing = np.stack(coords[1:], axis=0)
        d_of = np.maximum((trailing != 0).sum(axis=0), 1)
        for d in sorted(set(int(v) for v in d_of)):
            mask = d_of == d
            sel = trailing[:, mask]
            m = int(mask.sum())
            if factor_pairs and d >= 3:
                d_eff = (d + 1) // 2
                idx_cols = np.zeros((d_eff, m), np.int64)
                for e in range(m):
                    nz = sel[:, e][sel[:, e] != 0]
                    for h in range(d // 2):
                        idx_cols[h, e] = n1 + pair_id(nz[2 * h],
                                                      nz[2 * h + 1])
                    if d % 2:
                        idx_cols[d_eff - 1, e] = nz[-1]
            else:
                d_eff = d
                idx_cols = np.zeros((d, m), np.int64)
                for e in range(m):
                    nz = sel[:, e][sel[:, e] != 0]
                    idx_cols[:nz.size, e] = nz
            groups.append((d_eff, rows[mask], data[mask], idx_cols))
    n_pairs = len(pair_ids)
    pair_ab = np.zeros((2, max(n_pairs, 1)), np.int64)
    for (a, b), q in pair_ids.items():
        pair_ab[0, q], pair_ab[1, q] = a, b
    return groups, (pair_ab if n_pairs else None), n1 + n_pairs


def make_bucketed_contraction(tensor: COO, dtype=None, factor_pairs="auto"):
    """Count-bucketed gather row-sum contraction (any rank >= 2): the
    zero-padding-free float analogue of the double-float kernel's layout.

    The plain rowsum layout pads every row to the maximum count R — 1.6x
    (MAOOAM) to 3.1x (T4 quartic) wasted slots, each costing real gather
    traffic on a gather-issue-bound path (the measured ~245 GB/s plateau
    is layout-insensitive: RESOLUTION_r04 ``gather_bm``/``gather_fm``
    microbenchmarks).  Bucketing rows by exact count removes the padding
    entirely, cutting the dominant traffic by the same factor.  Entries
    are additionally grouped by active-index count d (constants/linear/
    bilinear/...) so each group does only the gathers it needs, and rank-5
    quartic groups are pair-factored through a shared pair alphabet
    (``factor_pairs``, default on for d >= 3 — see
    :func:`make_pairsum_contraction`).

    Deterministic summation (fixed slot order per row); exact-placement
    reassembly via a static permutation."""
    dtype = dtype or _default_dtype()
    n1 = tensor.shape[0]
    if tensor.nnz == 0:
        return _empty_contraction(n1, dtype)
    if factor_pairs == "auto":
        factor_pairs = tensor.rank >= 4

    groups, pair_ab, n_ext = _active_index_groups(tensor, factor_pairs)

    groups_ops, groups_desc = [], []
    for d_eff, g_rows, g_data, idx_cols in groups:
        buckets, perm = _bucketed_layout(g_rows, g_data, list(idx_cols), n1)
        bops, bdesc = [], []
        for row_ids, vals, idxs, R_g in buckets:
            bops.append({
                "V": jnp.asarray(vals.reshape(-1), dtype=dtype),
                "idx": tuple(jnp.asarray(_idx(a.reshape(-1)))
                             for a in idxs),
            })
            bdesc.append((row_ids.size, R_g))
        groups_ops.append({"perm": jnp.asarray(_idx(perm)),
                           "buckets": tuple(bops)})
        groups_desc.append((d_eff, tuple(bdesc)))
    desc = tuple(groups_desc)
    n_pairs = 0 if pair_ab is None else pair_ab.shape[1]
    key = ("bucketed", n1, n_pairs, desc, _dtype_key(dtype))

    def build():
        def apply(ops, xx):
            B = xx.shape[0]
            if n_pairs:
                p = (jnp.take(xx, ops["pair_a"], axis=1)
                     * jnp.take(xx, ops["pair_b"], axis=1))
                ext = jnp.concatenate([xx, p], axis=1)       # (B, n_ext)
            else:
                ext = xx
            out = None
            for (d_eff, bdesc), gops in zip(desc, ops["groups"]):
                parts = []
                for (N_g, R_g), bop in zip(bdesc, gops["buckets"]):
                    prod = bop["V"][None, :]
                    for idxf in bop["idx"]:
                        prod = prod * jnp.take(ext, idxf, axis=1)
                    parts.append(prod.reshape(B, N_g, R_g).sum(axis=-1))
                z = jnp.zeros((B, 1), dtype=ext.dtype)
                g_out = jnp.take(jnp.concatenate(parts + [z], axis=1),
                                 gops["perm"], axis=1)
                out = g_out if out is None else out + g_out
            return out

        return apply

    operands = {"groups": tuple(groups_ops)}
    if n_pairs:
        operands["pair_a"] = jnp.asarray(_idx(pair_ab[0]))
        operands["pair_b"] = jnp.asarray(_idx(pair_ab[1]))
    return Contraction(_cached_apply(key, build), operands, key)


def _row_grouped(rows, n1, data, idx_cols):
    """Pad entries into a (n1, R) row-major layout (R = max row count);
    returns ``(vals, idx_slots, R)``."""
    counts = np.bincount(rows, minlength=n1)
    R = max(int(counts.max()), 1) if rows.size else 1
    vals = np.zeros((n1, R))
    idx_slots = [np.zeros((n1, R), np.int32) for _ in idx_cols]
    ptr = np.zeros(n1, np.int64)
    for e in range(rows.size):
        i = rows[e]
        vals[i, ptr[i]] = data[e]
        for out, col in zip(idx_slots, idx_cols):
            out[i, ptr[i]] = col[e]
        ptr[i] += 1
    return vals, idx_slots, R


def make_rowsum_contraction(tensor: COO, dtype=None, feature_major=False):
    """Return ``f(xx) -> out`` for a COO tensor of any rank r >= 2, with the
    per-row reduction done as an elementwise sum instead of a one-hot
    scatter matmul.

    Entries are padded into a row-grouped ``(n1, R)`` layout (R = max
    nonzeros per output row; padding slots carry value 0, contributing
    exactly 0): gather the state at each contraction index, multiply, and
    ``sum`` over the R slots.  This removes the (B, nnz) x (nnz, n1)
    scatter matmul entirely — that matmul is B*nnz*n1 MACs of
    mostly-padding work; the row-sum does B*n1*R exact elementwise ops.
    Deterministic summation order (fixed slot order per row).

    ``feature_major=True`` transposes the state to (n1, B) and gathers
    ROWS instead of columns: a batch-major gather fetches (B, 1) strided
    column slices (one scalar per batch lane — the access pattern behind
    the ~245 GB/s plateau measured at ndim >= 104 in RESOLUTION_r03),
    while a feature-major gather fetches contiguous (1, B) rows — full
    vector loads.  Same arithmetic, same summation order; two cheap
    transposes per evaluation."""
    dtype = dtype or _default_dtype()
    rank = tensor.rank
    n1 = tensor.shape[0]
    if tensor.nnz == 0:
        return _empty_contraction(n1, dtype)

    rows = np.asarray(tensor.coords[0])
    vals, idx_slots, R = _row_grouped(
        rows, n1, tensor.data, [np.asarray(tensor.coords[a])
                                for a in range(1, rank)])

    key = ("rowsum", n1, R, rank, bool(feature_major), _dtype_key(dtype))

    def build():
        if feature_major:
            def apply(ops, xx):
                xT = xx.T                                   # (n1, B)
                prod = ops["V"][:, None]
                for idxf in ops["idx_flats"]:
                    prod = prod * jnp.take(xT, idxf, axis=0)  # (n1*R, B)
                return prod.reshape(n1, R, xT.shape[1]).sum(axis=1).T
        else:
            def apply(ops, xx):
                prod = ops["V"][None, :]
                for idxf in ops["idx_flats"]:
                    prod = prod * jnp.take(xx, idxf, axis=1)
                return prod.reshape(xx.shape[0], n1, R).sum(axis=-1)

        return apply

    operands = {
        "V": jnp.asarray(vals.reshape(-1), dtype=dtype),
        "idx_flats": tuple(jnp.asarray(s.reshape(-1)) for s in idx_slots),
    }
    return Contraction(_cached_apply(key, build), operands, key)


def make_pairsum_contraction(tensor: COO, dtype=None, feature_major=True):
    """Pair-factored row-sum contraction for the quartic (rank-5) tensors:
    ``out[b,i] = sum_e val_e * x[j_e] x[k_e] x[l_e] x[m_e]`` evaluated as

        p_q   = x[a_q] * x[b_q]          over the tensor's distinct
                                         index PAIRS (j,k) / (l,m)
        out_i = sum_slots val * p[q1] * p[q2]

    The pair alphabet is shared across all entries, so the per-slot work
    drops from 4 state gathers + 3 multiplies to 2 pair gathers + 2
    multiplies, plus an O(n_pairs) precompute — the dominant gather
    traffic halves (the T4 tier ran at 21% of the HBM roofline in
    RESOLUTION_r03; this is the rank-5 analogue of "keep it factored",
    SURVEY §7, ref ``qgs/tensors/qgtensor.py:1060-1123``).  Requires an
    even number of trailing indices (rank 5: the four quartic indices; a
    rank-3 tensor would just reproduce :func:`make_rowsum_contraction`).

    Deterministic: fixed pair order, fixed slot order per row."""
    dtype = dtype or _default_dtype()
    rank = tensor.rank
    n1 = tensor.shape[0]
    if (rank - 1) % 2 != 0:
        raise ValueError(f"pairsum needs an even number of trailing "
                         f"indices, got rank {rank}")
    if tensor.nnz == 0:
        return _empty_contraction(n1, dtype)

    n_half = (rank - 1) // 2
    coords = [np.asarray(c) for c in tensor.coords]
    rows = coords[0]
    trail = np.stack(coords[1:], axis=0)                  # (2*n_half, nnz)
    # pair alphabet: distinct (first, second) index pairs across all slots
    pair_cols = np.concatenate(
        [trail[2 * h:2 * h + 2] for h in range(n_half)], axis=1)  # (2, n_half*nnz)
    pair_keys = pair_cols[0] * n1 + pair_cols[1]
    uniq, inverse = np.unique(pair_keys, return_inverse=True)
    n_pairs = uniq.size
    pair_a = (uniq // n1).astype(np.int64)
    pair_b = (uniq % n1).astype(np.int64)
    # per-entry pair ids, one per half
    pair_ids = inverse.reshape(n_half, tensor.nnz)

    vals, idx_slots, R = _row_grouped(rows, n1, tensor.data,
                                      list(pair_ids))

    key = ("pairsum", n1, R, n_pairs, n_half, bool(feature_major),
           _dtype_key(dtype))

    def build():
        if feature_major:
            def apply(ops, xx):
                xT = xx.T                                   # (n1, B)
                p = (jnp.take(xT, ops["pair_a"], axis=0)
                     * jnp.take(xT, ops["pair_b"], axis=0))  # (n_pairs, B)
                prod = ops["V"][:, None]
                for idxf in ops["idx_flats"]:
                    prod = prod * jnp.take(p, idxf, axis=0)  # (n1*R, B)
                return prod.reshape(n1, R, xT.shape[1]).sum(axis=1).T
        else:
            def apply(ops, xx):
                p = (jnp.take(xx, ops["pair_a"], axis=1)
                     * jnp.take(xx, ops["pair_b"], axis=1))  # (B, n_pairs)
                prod = ops["V"][None, :]
                for idxf in ops["idx_flats"]:
                    prod = prod * jnp.take(p, idxf, axis=1)
                return prod.reshape(xx.shape[0], n1, R).sum(axis=-1)

        return apply

    operands = {
        "V": jnp.asarray(vals.reshape(-1), dtype=dtype),
        "pair_a": jnp.asarray(_idx(pair_a)),
        "pair_b": jnp.asarray(_idx(pair_b)),
        "idx_flats": tuple(jnp.asarray(_idx(s.reshape(-1)))
                           for s in idx_slots),
    }
    return Contraction(_cached_apply(key, build), operands, key)


def make_coo_jacobian(jtensor: COO, dtype=None, precision=None):
    """Return ``J(xx) -> (B, n1, n1)`` for a COO Jacobian tensor of rank r:
    ``J[b, i, j] = sum_e val[e] * prod_{axis=2..r-1} xx[b, coords[axis,e]]``
    scattered at ``(i, j) = (coords[0,e], coords[1,e])`` — the reference's
    ``sparse_mul2``/``sparse_mul4`` convention (column at axis 1, contraction
    over the trailing axes)."""
    dtype = dtype or _default_dtype()
    precision = _resolve_precision(precision)
    coords = jtensor.coords
    rank = jtensor.rank
    n1 = jtensor.shape[0]
    if jtensor.nnz == 0:
        key = ("empty_jac", n1, _dtype_key(dtype))

        def build_empty():
            def apply(ops, xx):
                return jnp.zeros((xx.shape[0], n1, n1), dtype=dtype)

            return apply

        return Contraction(_cached_apply(key, build_empty), {}, key)

    nnz = jtensor.nnz
    flat_out = coords[0] * n1 + coords[1]
    small = nnz * n1 * n1 <= 2e7

    key = ("coo_jac", n1, rank, nnz, small, _dtype_key(dtype),
           _prec_key(precision))

    def build():
        if small:
            # one-hot matmul scatter
            def apply(ops, xx):
                prod = ops["val"][None, :]
                for idx in ops["idxs"]:
                    prod = prod * xx[:, idx]
                return jnp.matmul(prod, ops["S"],
                                  precision=precision).reshape(
                    xx.shape[0], n1, n1)
        else:
            # large rank-5 jacobians: scatter-add (the one-hot matrix would
            # be nnz x n1^2 — hundreds of MB)
            def apply(ops, xx):
                prod = ops["val"][None, :]
                for idx in ops["idxs"]:
                    prod = prod * xx[:, idx]
                flat = jnp.zeros((xx.shape[0], n1 * n1), dtype=dtype)
                flat = flat.at[:, ops["out_idx"]].add(prod)
                return flat.reshape(xx.shape[0], n1, n1)

        return apply

    operands = {
        "val": jnp.asarray(jtensor.data, dtype=dtype),
        "idxs": tuple(jnp.asarray(_idx(coords[axis]))
                      for axis in range(2, rank)),
    }
    if small:
        scatter = np.zeros((nnz, n1 * n1), dtype=np.dtype(dtype))
        scatter[np.arange(nnz), flat_out] = 1.0
        operands["S"] = jnp.asarray(scatter)
    else:
        operands["out_idx"] = jnp.asarray(_idx(flat_out))
    return Contraction(_cached_apply(key, build), operands, key)


def make_bucketed_tangent(jtensor: COO, dtype=None, adjoint=False,
                          inverse=False):
    """Count-bucketed direct tangent contraction ``hom(xx, dm) ->
    (B, n, n_tg)`` — the float analogue of
    :func:`qgs_jax.ops.twofloat.make_df_tangent_contraction` and the
    gather-kernel alternative to :func:`make_direct_tangent`'s flat
    scatter matmul: per slot, gather the coefficient state values and the
    tangent rows, multiply, and reduce the slots per output row (padding-
    free bucketed layout, fused row-sum — the layout that removed the
    r03 gather plateau, see :func:`make_bucketed_contraction`).  Index
    conventions identical to ``make_direct_tangent`` (ref
    ``qgs/integrators/integrate.py:227-231``); adjoint/inverse are exact
    host-side operand transforms."""
    dtype = dtype or _default_dtype()
    n1 = jtensor.shape[0]
    n = n1 - 1
    coords = [np.asarray(c) for c in jtensor.coords]
    data = np.asarray(jtensor.data)
    if inverse:
        data = -data
    if adjoint:
        coords[0], coords[1] = coords[1], coords[0]
    keep = (coords[0] != 0) & (coords[1] != 0)
    rows = coords[0][keep] - 1
    if rows.size == 0:
        key = ("empty_tangent", n, _dtype_key(dtype))

        def build_empty():
            def apply(ops, xx, dm):
                return jnp.zeros((xx.shape[0], n, dm.shape[-1]), dtype=dtype)

            return apply

        return Contraction(_cached_apply(key, build_empty), {}, key)

    dm_idx = coords[1][keep] - 1
    x_cols = [c[keep] for c in coords[2:]]
    vals = data[keep]

    buckets, perm = _bucketed_layout(rows, vals, [dm_idx] + x_cols, n)
    bops, bdesc = [], []
    for row_ids, bvals, idxs, R_g in buckets:
        bops.append({
            "V": jnp.asarray(bvals.reshape(-1), dtype=dtype),
            "dm_idx": jnp.asarray(_idx(idxs[0].reshape(-1))),
            "x_idx": tuple(jnp.asarray(_idx(a.reshape(-1)))
                           for a in idxs[1:]),
        })
        bdesc.append((row_ids.size, R_g))
    desc = tuple(bdesc)
    n_x = len(coords) - 2
    key = ("bucketed_tangent", n1, n_x, desc, _dtype_key(dtype))

    def build():
        def apply(ops, xx, dm):
            """xx: (B, n1) dummy-padded state; dm: (B, n, n_tg)."""
            B, n_tg = xx.shape[0], dm.shape[-1]
            parts = []
            for (N_g, R_g), bop in zip(desc, ops["buckets"]):
                coef = bop["V"][None, :]
                for idxf in bop["x_idx"]:
                    coef = coef * jnp.take(xx, idxf, axis=1)  # (B, Ng*Rg)
                dmg = jnp.take(dm, bop["dm_idx"], axis=1)     # (B,Ng*Rg,t)
                prod = coef[:, :, None] * dmg
                parts.append(prod.reshape(B, N_g, R_g, n_tg).sum(axis=2))
            z = jnp.zeros((B, 1, n_tg), dtype=dm.dtype)
            return jnp.take(jnp.concatenate(parts + [z], axis=1),
                            ops["perm"], axis=1)

        return apply

    operands = {"buckets": tuple(bops), "perm": jnp.asarray(_idx(perm))}
    return Contraction(_cached_apply(key, build), operands, key)


def make_direct_tangent(jtensor: COO, dtype=None, precision=None,
                        adjoint=False, inverse=False):
    """Direct tangent-linear contraction ``hom(xx, dm) -> (B, n, n_tg)``:

        hom[b, i, t] = sum_e val_e * (prod_a xx[b, coords[a, e]])
                                   * dm[b, coords[1, e] - 1, t]

    without materializing the Jacobian.  The J-then-multiply route costs a
    batched (n, n) x (n, n_tg) matmul per member — tiny per-batch
    matmuls; here the per-entry products are flattened into ONE
    (B*n_tg, nnz) x (nnz, n1) scatter matmul.  Same index conventions as the
    double-float version (:func:`qgs_jax.ops.twofloat.make_df_tangent_contraction`);
    ``adjoint`` transposes and ``inverse`` negates on host, exactly —
    both live purely in operand values, so every variant shares one
    compiled program per shape.  ``dm`` carries no dummy row (its tangent
    is identically zero)."""
    dtype = dtype or _default_dtype()
    precision = _resolve_precision(precision)
    n1 = jtensor.shape[0]
    n = n1 - 1
    coords = [np.asarray(c) for c in jtensor.coords]
    data = np.asarray(jtensor.data)
    if inverse:
        data = -data
    if adjoint:
        coords[0], coords[1] = coords[1], coords[0]
    keep = (coords[0] != 0) & (coords[1] != 0)
    rows = coords[0][keep] - 1
    nnz = int(rows.size)
    if nnz == 0:
        key = ("empty_tangent", n, _dtype_key(dtype))

        def build_empty():
            def apply(ops, xx, dm):
                return jnp.zeros((xx.shape[0], n, dm.shape[-1]), dtype=dtype)

            return apply

        return Contraction(_cached_apply(key, build_empty), {}, key)

    n_xidx = len(coords) - 2
    key = ("direct_tangent", n1, nnz, n_xidx, _dtype_key(dtype),
           _prec_key(precision))

    def build():
        def apply(ops, xx, dm):
            """xx: (B, n1) dummy-padded state; dm: (B, n, n_tg)."""
            B, n_tg = xx.shape[0], dm.shape[-1]
            coef = ops["val"][None, :]
            for idx in ops["x_idxs"]:
                coef = coef * xx[:, idx]                   # (B, nnz)
            prod = coef[:, :, None] * jnp.take(dm, ops["dm_idx"], axis=1)
            # one flat scatter matmul: (B*n_tg, nnz) @ (nnz, n)
            flat = prod.transpose(0, 2, 1).reshape(B * n_tg, nnz)
            out = jnp.matmul(flat, ops["S"], precision=precision)
            return out.reshape(B, n_tg, n).transpose(0, 2, 1)

        return apply

    scatter = np.zeros((nnz, n), dtype=np.dtype(dtype))
    scatter[np.arange(nnz), rows] = 1.0
    operands = {
        "val": jnp.asarray(data[keep], dtype=dtype),
        "dm_idx": jnp.asarray(_idx(coords[1][keep] - 1)),
        "x_idxs": tuple(jnp.asarray(_idx(c[keep])) for c in coords[2:]),
        "S": jnp.asarray(scatter),
    }
    return Contraction(_cached_apply(key, build), operands, key)


# ---------------------------------------------------------------------------
# Tendency-function factories
# ---------------------------------------------------------------------------

def _with_dummy(x):
    """Prepend the dummy constant 1 along the last axis."""
    ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
    return jnp.concatenate([ones, x], axis=-1)


def make_tendency_fns(tensor: COO, jtensor: COO, mode="auto", dtype=None,
                      precision=None):
    """Build the batched tendency and Jacobian functions from a tendency
    tensor and its Jacobian tensor (any rank >= 3).

    Returns ``(f_batch, jac_batch)`` — :class:`Contraction` objects — with

    * ``f_batch(t, x)``: (B, ndim) -> (B, ndim)
    * ``jac_batch(t, x)``: (B, ndim) -> (B, ndim, ndim)

    ``mode``: 'dense' | 'coo' | 'rowsum' | 'rowsum_fm' (feature-major
    gathers) | 'pairsum' (pair-factored quartic kernel) | 'bucketed'
    (count-bucketed, padding-free layout + pair factoring) | 'auto'.
    ``precision``: matmul precision for the contraction (default HIGHEST —
    see :func:`_resolve_precision`; pass 'default' for raw-bf16 speed).
    """
    dtype = dtype or _default_dtype()
    rank = tensor.rank
    if mode == "auto":
        # the count-bucketed gather kernel at every size; which kernel
        # wins on the GPU at high ndim is not measured yet — 'dense',
        # 'rowsum' and 'coo' remain as explicit modes
        mode = "bucketed"

    if mode == "dense" and rank == 3:
        quad = make_dense_quadratic(tensor, dtype, precision)
        bil = make_dense_bilinear(jtensor, dtype, precision)
    elif mode == "bucketed":
        quad = make_bucketed_contraction(tensor, dtype)
        bil = make_coo_jacobian(jtensor, dtype, precision)
    elif mode == "pairsum":
        quad = make_pairsum_contraction(tensor, dtype, feature_major=False)
        bil = make_coo_jacobian(jtensor, dtype, precision)
    elif mode in ("rowsum", "rowsum_fm"):
        quad = make_rowsum_contraction(tensor, dtype,
                                       feature_major=mode == "rowsum_fm")
        bil = make_coo_jacobian(jtensor, dtype, precision)
    elif mode == "coo":
        quad = make_coo_contraction(tensor, dtype, precision)
        bil = make_coo_jacobian(jtensor, dtype, precision)
    elif mode == "dense":
        raise ValueError(
            f"mode='dense' supports rank-3 tensors only (got rank {rank}: "
            f"a densified quartic tensor would be (ndim+1)^{rank - 1} "
            f"entries); use 'bucketed' or 'pairsum'")
    else:
        raise ValueError(
            f"unknown contraction mode {mode!r}: expected 'auto', 'dense', "
            f"'coo', 'rowsum', 'rowsum_fm', 'pairsum' or 'bucketed'")

    fkey = ("f_batch", quad.key)
    jkey = ("jac_batch", bil.key)
    quad_apply, bil_apply = quad.apply, bil.apply

    def build_f():
        def apply(ops, t, x):
            return quad_apply(ops, _with_dummy(x))[:, 1:]

        return apply

    def build_j():
        def apply(ops, t, x):
            return bil_apply(ops, _with_dummy(x))[:, 1:, 1:]

        return apply

    f_batch = Contraction(_cached_apply(fkey, build_f), quad.operands, fkey)
    jac_batch = Contraction(_cached_apply(jkey, build_j), bil.operands, jkey)
    return f_batch, jac_batch


def single_state(f_batch):
    """Wrap a batched function into a single-state one (reference API shape)."""
    apply0 = getattr(f_batch, "apply", None)
    if apply0 is None:
        def f(t, x):
            return f_batch(t, x[None, :])[0]

        return f

    key = ("single", f_batch.key)

    def build():
        def apply(ops, t, x):
            return apply0(ops, t, x[None, :])[0]

        return apply

    return Contraction(_cached_apply(key, build), f_batch.operands, key)
