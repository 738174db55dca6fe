"""
Mode-space (tensor-parallel) sharded tendency evaluation
========================================================

For high-resolution truncations, the tendency contraction is sharded
across a ``'model'`` mesh axis, combined with an ``'ensemble'`` (data
parallel) axis — the qgs analogue of data x tensor parallelism (see
SURVEY.md §2, "Parallelism strategies"; the reference's integrator pool,
ref ``qgs/integrators/integrator.py:121-142``, can only scale the
ensemble axis).  Two kernels:

* **bucketed** (default, round 5): OUTPUT rows — whole count-buckets of
  the count-bucketed gather kernel
  (:func:`qgs_jax.ops.contraction.make_bucketed_contraction`, the
  default contraction) — are partitioned across the model
  axis.  Output rows are disjoint, so there is NO psum: each device
  reduces only its own rows and one ``all_gather`` of the compact
  per-device row block replicates the result (half the collective bytes
  of a psum).  Per-row arithmetic
  is IDENTICAL to the unsharded bucketed kernel (same global count
  ladder, same slot order), so results are bit-identical to it.

    state  (B, n)             P('ensemble', None)   [model-replicated]
    layout (n_model, ...)     P('model', None)      [row buckets]
    output (B, n)             P('ensemble', None), all_gather over 'model'

* **dense**: the matricized (n1^2, n1) tensor sharded along its reduction
  axis, one psum per evaluation — kept as the matmul/collective comparison
  row (it materializes a (B, n1^2) outer product per stage).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:                                   # jax >= 0.8 top-level name
    from jax import shard_map as _shard_map
    _NOREP_KW = "check_vma"
except ImportError:                    # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map
    _NOREP_KW = "check_rep"


def shard_map(fn, mesh, in_specs, out_specs, check_replication=True):
    kw = {} if check_replication else {_NOREP_KW: False}
    return _shard_map(fn, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, **kw)

from qgs_jax.utils.sparse import COO

MODEL_AXIS = "model"
ENSEMBLE_AXIS = "ensemble"


def make_sharded_tendency(tensor: COO, mesh: Mesh, dtype=None,
                          overlap_chunks=1, kernel="auto"):
    """Build a batched tendency function sharded over the mesh's
    ``'model'`` axis, with the batch axis sharded over ``'ensemble'``.

    Returns ``f(t, x)`` mapping (B, ndim) -> (B, ndim), to be called inside
    ``jax.jit`` with ``x`` sharded ``P('ensemble', None)``.

    ``kernel='auto'`` (= ``'bucketed'``) partitions the count-bucketed
    gather kernel's output rows across the model axis (disjoint rows, no
    psum — see the module docstring); ``'dense'`` is the psum'd matricized
    matmul comparison path.

    ``overlap_chunks > 1`` (dense kernel) splits the local batch into chunks
    with one ``psum`` per chunk: chunk k+1's partial contraction is
    independent of chunk k's all-reduce, so the XLA scheduler can overlap
    the NVLink collective with the matmul (total collective bytes are
    unchanged — the batch axis is split, not the reduction axis).  On a
    single card or a virtual CPU mesh both variants are bitwise-identical
    programs modulo scheduling.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if kernel in ("auto", "bucketed"):
        if overlap_chunks != 1:
            # the knob belongs to the dense psum pipeline; silently
            # ignoring it would let a caller believe they are running the
            # chunked-psum overlap program
            raise ValueError(
                "overlap_chunks applies to the dense kernel only (the "
                "bucketed row-partitioned kernel has no psum to overlap) "
                "— pass kernel='dense' to use it")
        return make_bucketed_sharded_tendency(tensor, mesh, dtype=dtype)
    if kernel != "dense":
        raise ValueError(f"unknown sharded kernel {kernel!r}: expected "
                         "'auto', 'bucketed' or 'dense'")
    n1 = tensor.shape[0]
    # matricize so that row (j, k) column i holds T[i, j, k]
    T = tensor.todense().transpose(1, 2, 0).reshape(n1 * n1, n1)

    n_model = mesh.shape[MODEL_AXIS]
    # pad the reduction axis to a multiple of the model-axis size
    red = n1 * n1
    red_pad = ((red + n_model - 1) // n_model) * n_model
    T_pad = np.zeros((red_pad, n1), dtype=np.dtype(dtype))
    T_pad[:red] = T
    # place the tensor slices directly with their P('model', None) layout —
    # required for correctness in multi-process runs (an uncommitted local
    # array cannot be auto-resharded onto a multi-host mesh) and avoids a
    # layout round-trip in the single-process case too.
    T_dev = jax.make_array_from_callback(
        T_pad.shape, NamedSharding(mesh, P(MODEL_AXIS, None)),
        lambda idx: T_pad[idx])

    @partial_shard_map(mesh)
    def _tendency_core(T_local, xx):
        # T_local: (red_pad / n_model, n1) — this device's tensor slice
        # xx:      (B / n_ens, n1)        — this device's ensemble slice
        B = xx.shape[0]
        outer = (xx[:, :, None] * xx[:, None, :]).reshape(B, red)
        outer_pad = jnp.pad(outer, ((0, 0), (0, red_pad - red)))
        lo = jax.lax.axis_index(MODEL_AXIS).astype(jnp.int32) * T_local.shape[0]
        local = jax.lax.dynamic_slice(outer_pad, (jnp.int32(0), lo),
                                      (B, T_local.shape[0]))
        # HIGHEST: at DEFAULT precision an f32 matmul may run in TF32 on
        # the GPU (~1e-3 rel)
        if overlap_chunks > 1:
            if B % overlap_chunks != 0:
                raise ValueError(
                    f"overlap_chunks={overlap_chunks} must divide the "
                    f"per-device batch ({B}) — refusing to silently fall "
                    f"back to the unchunked program")
            c = B // overlap_chunks
            parts = [jax.lax.psum(
                jnp.matmul(local[k * c:(k + 1) * c], T_local,
                           precision=jax.lax.Precision.HIGHEST),
                MODEL_AXIS) for k in range(overlap_chunks)]
            return jnp.concatenate(parts, axis=0)
        partial = jnp.matmul(local, T_local,
                             precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(partial, MODEL_AXIS)

    def f(t, x):
        ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
        xx = jnp.concatenate([ones, x], axis=-1)
        return _tendency_core(T_dev, xx)[:, 1:]

    return f


def make_bucketed_sharded_tendency(tensor: COO, mesh: Mesh, dtype=None,
                                   factor_pairs="auto", max_buckets=None):
    """Model-axis sharding of the count-bucketed gather kernel.

    The bucketed kernel's output rows are disjoint, so a row partition
    over the ``'model'`` axis needs no reduction collective at all: each
    device evaluates the buckets of its own rows against the (model-
    replicated) state, and one ``all_gather`` of the compact (B, W) local
    row blocks — W = ceil(rows/n_model) — replicates the (B, n1) result.

    Layout construction guarantees per-device shape uniformity (a
    ``shard_map`` requirement):

    * every device uses the GLOBAL quantized count ladder
      (:func:`~qgs_jax.ops.contraction._count_thresholds`), so bucket R
      values agree;
    * whole rows are assigned to devices (a row's slots never split), in
      count-signature-sorted round-robin order, so each device holds an
      equal share (+-1) of every count class — the per-class row counts
      are then padded to the max over devices with zero rows (value 0,
      index 0: contributes exactly 0);
    * the rank>=4 pair alphabet stays global/replicated (the pair
      precompute is O(B n_pairs) elementwise — small next to the bucket
      gathers — and it keeps the extended gather alphabet identical on
      every device).

    Because rows are never split and the ladder/slot order match
    :func:`~qgs_jax.ops.contraction.make_bucketed_contraction`, each
    output row's reduction sequence is identical — results are
    bit-identical to the unsharded bucketed kernel."""
    from qgs_jax.ops.contraction import (_active_index_groups,
                                         _bucketed_layout,
                                         _count_thresholds,
                                         default_max_buckets, _idx)

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    np_dtype = np.dtype(dtype)
    n1 = tensor.shape[0]
    n_model = mesh.shape[MODEL_AXIS]
    if factor_pairs == "auto":
        factor_pairs = tensor.rank >= 4

    if tensor.nnz == 0:
        def f_zero(t, x):
            return jnp.zeros_like(x)
        return f_zero

    if max_buckets is None:
        max_buckets = default_max_buckets()
    groups, pair_ab, n_ext = _active_index_groups(tensor, factor_pairs)
    n_pairs = 0 if pair_ab is None else pair_ab.shape[1]

    # global count ladder + per-row threshold signature, per group
    group_meta = []
    row_sig = np.zeros((len(groups), n1), np.int64)
    for gi, (d_eff, g_rows, g_data, idx_cols) in enumerate(groups):
        counts = np.bincount(g_rows, minlength=n1)
        thresholds = _count_thresholds(counts, max_buckets)
        thr = np.asarray(thresholds)
        row_thr = np.zeros(n1, np.int64)
        nz = counts > 0
        row_thr[nz] = thr[np.searchsorted(thr, counts[nz])]
        row_sig[gi] = row_thr
        group_meta.append((d_eff, np.asarray(g_rows), np.asarray(g_data),
                           [np.asarray(c) for c in idx_cols], thresholds))

    # whole-row partition: signature-sorted round-robin deal — rows with
    # identical count signatures are contiguous, so every device gets an
    # equal share (+-1) of every (group, count-class) and padding is
    # minimal; the deal also balances per-device slot cost.
    nonempty = np.nonzero(row_sig.sum(axis=0) > 0)[0]
    order = np.lexsort((nonempty,) + tuple(row_sig[gi, nonempty]
                                           for gi in range(len(groups))))
    dealt = nonempty[order]
    owner = np.full(n1, -1, np.int64)
    owner[dealt] = np.arange(dealt.size) % n_model
    W = max((dealt.size + n_model - 1) // n_model, 1)
    local_pos = np.full(n1, -1, np.int64)
    for d in range(n_model):
        rows_d = dealt[owner[dealt] == d]
        local_pos[rows_d] = np.arange(rows_d.size)

    # stacked per-device layouts (leading 'model' axis on every leaf)
    host_groups, descs = [], []
    for d_eff, g_rows, g_data, idx_cols, thresholds in group_meta:
        per_dev = []
        for d in range(n_model):
            sel = owner[g_rows] == d
            buckets, _ = _bucketed_layout(
                g_rows[sel], g_data[sel], [c[sel] for c in idx_cols], n1,
                thresholds=thresholds)
            per_dev.append({R_g: (row_ids, vals, idxs)
                            for (row_ids, vals, idxs, R_g) in buckets})
        ladder = [R for R in thresholds if any(R in pd for pd in per_dev)]
        n_idx = len(idx_cols)
        bucket_stacks, bdesc, offsets = [], [], {}
        off = 0
        for R in ladder:
            N_pad = max(pd[R][0].size if R in pd else 0 for pd in per_dev)
            Vs = np.zeros((n_model, N_pad, R), np_dtype)
            Is = [np.zeros((n_model, N_pad, R), np.int64)
                  for _ in range(n_idx)]
            for d, pd in enumerate(per_dev):
                if R in pd:
                    row_ids, vals, idxs = pd[R]
                    Vs[d, :row_ids.size] = vals
                    for k in range(n_idx):
                        Is[k][d, :row_ids.size] = idxs[k]
            bucket_stacks.append(
                {"V": Vs.reshape(n_model, -1),
                 "idx": tuple(_idx(a.reshape(n_model, -1)) for a in Is)})
            bdesc.append((N_pad, R))
            offsets[R] = off
            off += N_pad
        zero_col = off
        perm = np.full((n_model, W), zero_col, np.int64)
        for d, pd in enumerate(per_dev):
            for R in ladder:
                if R in pd:
                    row_ids = pd[R][0]
                    perm[d, local_pos[row_ids]] = (offsets[R]
                                                   + np.arange(row_ids.size))
        host_groups.append({"perm": _idx(perm), "buckets": bucket_stacks})
        descs.append((d_eff, tuple(bdesc)))
    descs = tuple(descs)

    # final reassembly permutation: global row -> (owner device, local col)
    # in the all_gather'd (B, n_model*W) block; empty rows -> the appended
    # zero column
    final_perm = np.full(n1, n_model * W, np.int64)
    final_perm[dealt] = owner[dealt] * W + local_pos[dealt]
    final_perm = _idx(final_perm)       # baked (tiny) program constant

    # place every stacked leaf directly with its P('model', None) layout
    # (required in multi-process runs; avoids a reshard in-process too)
    model_sharding = NamedSharding(mesh, P(MODEL_AXIS, None))

    def _place(a):
        a = np.ascontiguousarray(a)
        return jax.make_array_from_callback(
            a.shape, model_sharding, lambda idx, a=a: a[idx])

    operands = jax.tree_util.tree_map(_place, host_groups)

    if n_pairs:
        # numpy program constants (multi-process safe: a host-local device
        # array closed over inside a global-mesh jit is non-addressable)
        pair_a = _idx(pair_ab[0])
        pair_b = _idx(pair_ab[1])

    def core(ops, ext):
        # every operand leaf arrives as this device's (1, K) block
        B = ext.shape[0]
        out = jnp.zeros((B, W), dtype=ext.dtype)
        for (d_eff, bdesc), gops in zip(descs, ops):
            parts = []
            for (N_g, R_g), bop in zip(bdesc, gops["buckets"]):
                prod = bop["V"][0][None, :].astype(ext.dtype)
                for idxf in bop["idx"]:
                    prod = prod * jnp.take(ext, idxf[0], axis=1)
                parts.append(prod.reshape(B, N_g, R_g).sum(axis=-1))
            z = jnp.zeros((B, 1), dtype=ext.dtype)
            out = out + jnp.take(jnp.concatenate(parts + [z], axis=1),
                                 gops["perm"][0], axis=1)
        # rows are disjoint across the model axis: replicating the result
        # is ONE all_gather of the compact (B, W) blocks — no psum
        full = jax.lax.all_gather(out, MODEL_AXIS, axis=1, tiled=True)
        fz = jnp.concatenate([full, jnp.zeros((B, 1), ext.dtype)], axis=1)
        return jnp.take(fz, final_perm, axis=1)

    core_sm = shard_map(
        core, mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P(ENSEMBLE_AXIS, None)),
        out_specs=P(ENSEMBLE_AXIS, None),
        # the output IS replicated over 'model' (all_gather hands every
        # member the full row block), but the static replication checker
        # cannot infer that through a tiled all_gather
        check_replication=False)

    def f(t, x):
        ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
        xx = jnp.concatenate([ones, x], axis=-1)
        if n_pairs:
            p = (jnp.take(xx, pair_a, axis=1)
                 * jnp.take(xx, pair_b, axis=1))
            ext = jnp.concatenate([xx, p], axis=1)
        else:
            ext = xx
        return core_sm(operands, ext)[:, 1:]

    return f


def partial_shard_map(mesh):
    """Decorator: shard_map with the (model, ensemble) specs used above."""

    def wrap(fn):
        return shard_map(
            fn, mesh=mesh,
            in_specs=(P(MODEL_AXIS, None), P(ENSEMBLE_AXIS, None)),
            out_specs=P(ENSEMBLE_AXIS, None),
        )

    return wrap
