"""The diag-scaled sparse multiply chain: SpGEMM (MM) and SpMV (MV).

Array-native re-design of the reference's multiply layer
(/root/reference/slib/spsparse/multiply_sparse.hpp:117-365):

MM:  ``ret = C · diag(scalei) · A^(T?) · diag(scalej) · B^(T?) · diag(scalek)``
MV:  ``ret = C · diag(scalei) · A^(T?) · diag(scalej) · V``

Semantic contract preserved exactly (SURVEY §3.3-3.4):

* transposition is free — handled by index-column swap + re-consolidation
  (reference ``multiply_sparse.hpp:167-168,187-188``);
* operands are consolidated with the caller's ``duplicate_policy`` /
  ``zero_nan`` before multiplying (``:187-188``);
* ``scalei``/``scalek`` are *sparse* vectors joined against the present
  rows/cols: a row missing from the scale vector — or whose scale value is
  exactly zero — is skipped entirely (``ScaledMultXiter``, ``:74-93``, and
  the ``isnone(scale_val)`` skips at ``:195,211``);
* ``scalej`` joins on the inner index: an inner index absent from ``scalej``
  contributes nothing to the dot product (3-way join, ``:223-228``);
* dot products that sum to exactly zero are not emitted (``:238-243``);
  NaN sums *are* emitted (the emission test is ``isnone(sum)`` without
  ``zero_nan``);
* inner-dimension mismatches raise through the pluggable error handler
  (``:172-174``).

The *algorithm* is deliberately different: instead of the reference's
inner-product formulation (O(rows_present x cols_present) merge-joins,
``multiply_sparse.hpp:192-246``), MM is a row-wise Gustavson SpGEMM in
expand–sort–compress (ESC) form — a single vectorized expansion of all
A-entry x B-row products, one stable multi-key sort, and a segmented sum —
which is static-shape, jit-compatible, and maps onto vectorized sorts and
scans rather than scalar pointer-chasing. MV needs no expansion at all:
scale/vector presence masks are gathered per A-entry and a segmented row
sum finishes the job.

Capacity model: XLA needs static shapes, so callers may pass ``expand_cap``
(product-expansion bound) and ``cap`` (output bound) to run fully under
``jit``; called eagerly with concrete operands, exact capacities are
computed automatically.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.consolidate import (
    consolidate as _consolidate,
    filter_compact,
    merge_sorted_entries,
    sort_entry_stream,
    fused_sort_merge,
)
from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import DuplicatePolicy, spsparse_error
from ..core.structure import SparseCSR, to_csr
from ..utils.trace import traced

__all__ = ["multiply", "multiply_mv", "multiply_chain", "expansion_size"]

Array = Any


def _is_concrete(*xs) -> bool:
    return not any(isinstance(x, jax.core.Tracer) for x in xs)


def _dense_scale(scale: SparseCOO | None, n: int):
    """Sparse scale vector → dense (present, value) arrays of length n+1
    (the trailing slot swallows sentinel-index gathers)."""
    if scale is None:
        return None, None
    live = scale.valid_mask()
    idx = jnp.where(live, scale.indices[:, 0],
                    jnp.asarray(n, scale.indices.dtype))
    pres = jnp.zeros((n + 1,), bool).at[idx].set(live, mode="drop")
    pres = pres.at[n].set(False)
    vals = jnp.zeros((n + 1,), scale.vals.dtype).at[idx].set(
        jnp.where(live, scale.vals, 0), mode="drop")
    return pres, vals


def expansion_size(a_inner_cols, a_live, b_csr: SparseCSR,
                   sj_pres=None) -> Array:
    """Exact ESC expansion size: sum over live A entries of the B-row length
    at the entry's inner index (zero where ``scalej`` lacks the index)."""
    k = jnp.where(a_live, a_inner_cols, jnp.asarray(b_csr.nrows, jnp.int32))
    row_len = b_csr.row_ptr[1:] - b_csr.row_ptr[:-1]
    cnt = jnp.take(row_len, k, mode="fill", fill_value=0)
    cnt = jnp.where(a_live, cnt, 0)
    if sj_pres is not None:
        kp = jnp.take(sj_pres, jnp.minimum(k, sj_pres.shape[0] - 1))
        cnt = jnp.where(kp, cnt, 0)
    return jnp.sum(cnt)


def expand_products_raw(i_a, k_a, v_a, a_live, row_start, row_len,
                        b_cols, b_vals, ncols_b: int, nrows_b: int,
                        sj_pres, sj_val, expand_cap: int,
                        method: str = "auto"):
    """ESC expansion over raw arrays: enumerate every (A entry) x (B-row
    entry) product. ``row_start``/``row_len`` describe where B's row ``k``
    lives inside ``b_cols``/``b_vals`` (a CSR, or any padded layout — the
    distributed path passes gathered block-padded buffers).

    Returns ``(i, j, v, valid)`` arrays of length ``expand_cap``. Stream
    order is an implementation detail of ``method`` — both orders list
    each output cell's products in ascending ``k``, which the stable
    product sort preserves (so accumulation order, and reference bitwise
    parity via ``merge_method="scatter"``, are unaffected):

    * ``"gather"``: per-slot XLA gathers; stream ordered (i, k, j).
    * ``"join"``: three sort-based joins
      (:func:`spsparse_tpu.core.joinfill.merge_fill_compact`) — A entries
      x B-row table by k, run-length spread to product slots, slots x B
      entries by CSR position; stream ordered (k, i, j). For devices
      whose per-element gathers are slow.
    * ``"auto"``: ``"gather"`` (GPUs and CPUs gather natively).
    """
    if method == "auto":
        method = "gather"
    cap_a = i_a.shape[0]
    k_a = jnp.where(a_live, k_a, jnp.asarray(nrows_b, k_a.dtype))
    v_a = jnp.where(a_live, v_a, 0)

    if method == "join":
        return _expand_join(i_a, k_a, v_a, a_live, row_start, row_len,
                            b_cols, b_vals, ncols_b, nrows_b,
                            sj_pres, sj_val, expand_cap)

    cnt = jnp.take(row_len, k_a, mode="fill", fill_value=0)
    cnt = jnp.where(a_live, cnt, 0)
    if sj_pres is not None:
        kp = jnp.take(sj_pres, jnp.minimum(k_a, sj_pres.shape[0] - 1))
        cnt = jnp.where(kp, cnt, 0)
        sj_at_a = jnp.take(sj_val, jnp.minimum(k_a, sj_val.shape[0] - 1))
        v_a = v_a * jnp.where(kp, sj_at_a, 0).astype(v_a.dtype)

    cum = jnp.cumsum(cnt)                       # inclusive
    total = cum[-1] if cap_a else jnp.zeros((), cnt.dtype)

    # Run-length decode slot -> source A entry: scatter each
    # product-generating entry's id at its run start and fill forward with
    # ``cummax`` (both ids and starts are increasing, and slot 0 is always
    # a run start when total > 0) — one pass, where ``searchsorted`` would
    # take log n serial-gather passes.
    t = jnp.arange(expand_cap, dtype=jnp.int32)
    valid_t = t < total
    base_e = (cum - cnt).astype(jnp.int32)
    has = cnt > 0
    pos = jnp.where(has, base_e, jnp.asarray(expand_cap, jnp.int32))
    e = jax.lax.cummax(
        jnp.zeros((expand_cap,), jnp.int32).at[pos].set(
            jnp.arange(cap_a, dtype=jnp.int32), mode="drop"))
    base = jax.lax.cummax(
        jnp.zeros((expand_cap,), jnp.int32).at[pos].set(
            base_e, mode="drop"))
    r = t - base

    # Pre-gather B-row starts at A-entry granularity (cap_a-sized, cheap)
    # so the slot-level gathers shrink to one per needed stream.
    b_start_a = jnp.take(row_start, k_a, mode="fill", fill_value=0)
    b_pos = jnp.take(b_start_a, e) + r
    j_t = jnp.take(b_cols, b_pos, mode="fill",
                   fill_value=ncols_b).astype(jnp.int32)
    vb = jnp.take(b_vals, b_pos, mode="fill", fill_value=0)
    i_t = jnp.take(i_a, e).astype(jnp.int32)
    v_t = jnp.take(v_a, e) * vb
    i_t = jnp.where(valid_t, i_t, nrows_b)  # placeholder; re-masked later
    return i_t, j_t, jnp.where(valid_t, v_t, 0), valid_t


def _expand_join(i_a, k_a, v_a, a_live, row_start, row_len,
                 b_cols, b_vals, ncols_b: int, nrows_b: int,
                 sj_pres, sj_val, expand_cap: int):
    """Sort-join ESC expansion (no per-element gathers/scatters); see
    :func:`expand_products_raw` for the contract."""
    from ..core.joinfill import merge_fill_compact

    cap_a = i_a.shape[0]
    b_cap = b_cols.shape[0]

    # --- join 1: A entries x B-row table by inner index k --------------
    # Dead A entries carry key nrows_b (sorts after every table row) and
    # are masked via the carried `a_live`.
    krow = jnp.arange(nrows_b, dtype=jnp.int32)
    row_payloads = [row_start.astype(jnp.int32)[:nrows_b],
                    row_len.astype(jnp.int32)[:nrows_b]]
    if sj_pres is not None:
        row_payloads += [sj_pres[:nrows_b].astype(jnp.int32),
                         sj_val[:nrows_b]]
    # Live entries with k outside [0, nrows_b) must not expand (the gather
    # path zero-fills them via mode="fill").
    live_j = a_live & (k_a < nrows_b)
    filled, carried = merge_fill_compact(
        krow, row_payloads,
        jnp.minimum(k_a, nrows_b).astype(jnp.int32),
        (i_a.astype(jnp.int32), v_a, live_j),
        cap_a, key_bound=nrows_b + 1)
    bstart_f, blen_f = filled[0], filled[1]
    i_s, v_s, live_s = carried
    if sj_pres is not None:
        kp = (filled[2] != 0) & live_s
        cnt = jnp.where(kp, blen_f, 0)
        v_s = v_s * jnp.where(kp, filled[3], 0).astype(v_s.dtype)
    else:
        cnt = jnp.where(live_s, blen_f, 0)
    # A entries are now k-ascending (stable: i-ascending within k).

    cum = jnp.cumsum(cnt)
    total = cum[-1] if cap_a else jnp.zeros((), cnt.dtype)
    base_e = (cum - cnt).astype(jnp.int32)

    # --- join 2: run-length spread of entries onto product slots -------
    # Entry -> first slot base_e (strictly increasing among cnt>0);
    # entries with cnt == 0 get a key past every slot.
    pos_key = jnp.where(cnt > 0, base_e,
                        jnp.asarray(expand_cap, jnp.int32))
    t = jnp.arange(expand_cap, dtype=jnp.int32)
    filled2, _ = merge_fill_compact(
        pos_key, (i_s, v_s, base_e, bstart_f),
        t, (), expand_cap, key_bound=expand_cap + 1)
    i_f, v_f, base_f, bstart_sl = filled2
    valid_t = t < total
    b_pos = bstart_sl + (t - base_f)
    b_pos = jnp.where(valid_t, b_pos, jnp.asarray(b_cap, jnp.int32))

    # --- join 3: slots x B entries by CSR position ---------------------
    q = jnp.arange(b_cap, dtype=jnp.int32)
    filled3, carried3 = merge_fill_compact(
        q, (b_cols.astype(jnp.int32), b_vals),
        b_pos, (i_f, v_f, valid_t),
        expand_cap, key_bound=b_cap + 1)
    j_o, vb_o = filled3
    i_o, va_o, valid_o = carried3

    i_t = jnp.where(valid_o, i_o, nrows_b)
    j_t = jnp.where(valid_o, j_o, ncols_b).astype(jnp.int32)
    v_t = jnp.where(valid_o, va_o * vb_o, 0)
    return i_t, j_t, v_t, valid_o


def _expand_products(acon: SparseCOO, b_csr: SparseCSR, sj_pres, sj_val,
                     expand_cap: int):
    a_live = acon.valid_mask()
    return expand_products_raw(
        acon.indices[:, 0], acon.indices[:, 1],
        acon.vals, a_live,
        b_csr.row_ptr[:-1], b_csr.row_ptr[1:] - b_csr.row_ptr[:-1],
        b_csr.cols, b_csr.vals, b_csr.ncols, b_csr.nrows,
        sj_pres, sj_val, expand_cap)


def sort_and_merge_products(i_t, j_t, v_t, valid_t, out_shape,
                            merge_cap: int | None = None,
                            merge_method: str = "compact",
                            with_run_count: bool = False):
    """Compress an ESC product stream: stable (i, j) sort — which preserves
    ascending-k accumulation order within each output cell — then segmented
    sum. Returns the unscaled, unfiltered merged COO (row-major sorted).

    ``with_run_count=True`` additionally returns the TRUE number of
    distinct output cells (before the ``merge_cap`` clamp) so callers with
    a fixed output capacity can report truncation instead of silently
    dropping runs (the distributed SpGEMM overflow contract)."""
    I, J = out_shape
    merge_cap = merge_cap if merge_cap is not None else i_t.shape[0]
    if merge_method == "compact":
        # Fused packed-word pipeline (round 3): one pack, run boundaries
        # and merge compaction on the words, one unpack — see
        # core.consolidate.fused_sort_merge.
        out = fused_sort_merge(
            (i_t.astype(jnp.int32), j_t.astype(jnp.int32)), v_t, valid_t,
            extents=(I, J), shape=out_shape,
            duplicate_policy=DuplicatePolicy.ADD, cap=merge_cap,
            sort_order=(0, 1), index_dtype=jnp.int32,
            with_run_count=with_run_count)
        return out
    (si_, sj_), sv_, slive, _ = sort_entry_stream(
        (i_t.astype(jnp.int32), j_t.astype(jnp.int32)), v_t, valid_t,
        extents=(I, J))
    merged = merge_sorted_entries(
        (si_, sj_), sv_, slive,
        shape=out_shape, duplicate_policy=DuplicatePolicy.ADD,
        cap=merge_cap, sort_order=(0, 1), index_dtype=jnp.int32,
        method=merge_method)
    if not with_run_count:
        return merged
    same = (si_ == jnp.roll(si_, 1)) & (sj_ == jnp.roll(sj_, 1))
    same = same.at[0].set(False)
    n_runs = jnp.sum(slive & ~same).astype(jnp.int32)
    return merged, n_runs


@traced("spsparse.multiply_mm")
def multiply(
    C,
    A: SparseCOO,
    B: SparseCOO,
    *,
    scalei: SparseCOO | None = None,
    scalej: SparseCOO | None = None,
    scalek: SparseCOO | None = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    cap: int | None = None,
    expand_cap: int | None = None,
    merge_method: str = "compact",
) -> SparseCOO:
    """MM chain: ``C · diag(scalei) · A^(T?) · diag(scalej) · B^(T?) · diag(scalek)``.

    Reference: ``multiply`` (MM overload), ``multiply_sparse.hpp:152-248``.
    Returns a row-major-sorted :class:`SparseCOO` of shape ``(A'.rows, B'.cols)``.

    ``merge_method="scatter"`` keeps the reference's bitwise left-to-right
    accumulation of each output cell (``EXPECT_DOUBLE_EQ`` parity,
    test_multiply_sparse.cpp:126) at scatter speed; the default
    ``"compact"`` evaluates cell sums as per-run segmented-scan tree
    reductions — same ascending-k term set, O(run*eps) rounding
    differences — and avoids per-element scatters (see
    core.consolidate.merge_sorted_entries).
    """
    if A.rank != 2 or B.rank != 2:
        spsparse_error(-1, "multiply (MM) requires rank-2 operands")
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    out_shape = (Aw.shape[0], Bw.shape[1])
    if Aw.shape[1] != Bw.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and B (%d) must match!",
            Aw.shape[1], Bw.shape[0])

    # Consolidate operands (reference multiply_sparse.hpp:187-188). A ends up
    # row-major (i,k); B becomes a CSR over its rows (k,j).
    acon = Aw if Aw.sort_order == (0, 1) else _consolidate(
        Aw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    bcon = Bw if Bw.sort_order == (0, 1) else _consolidate(
        Bw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    b_csr = to_csr(bcon)

    K = Aw.shape[1]
    sj_pres, sj_val = _dense_scale(scalej, K)
    si_pres, si_val = _dense_scale(scalei, out_shape[0])
    sk_pres, sk_val = _dense_scale(scalek, out_shape[1])

    out_dtype = jnp.result_type(A.vals, B.vals,
                                *(s.vals for s in
                                  (scalei, scalej, scalek) if s is not None),
                                C)

    if expand_cap is None:
        esize = expansion_size(acon.indices[:, 1], acon.valid_mask(), b_csr,
                               sj_pres)
        if not _is_concrete(esize):
            raise ValueError(
                "multiply under jit requires an explicit expand_cap")
        expand_cap = round_up_pow2(int(esize))

    i_t, j_t, v_t, valid_t = _expand_products(
        acon, b_csr, sj_pres, sj_val, expand_cap)
    merged = sort_and_merge_products(
        i_t, j_t, v_t.astype(out_dtype), valid_t, out_shape,
        merge_method=merge_method)

    # Emission + outer scaling (reference :195,211,238-243).
    live = merged.valid_mask()
    keep = live & (merged.vals != 0)
    keep &= jnp.asarray(C != 0)
    val = merged.vals * jnp.asarray(C, out_dtype)
    mi = jnp.minimum(merged.indices[:, 0], out_shape[0])
    mj = jnp.minimum(merged.indices[:, 1], out_shape[1])
    if scalei is not None:
        keep &= jnp.take(si_pres, mi) & (jnp.take(si_val, mi) != 0)
        val = val * jnp.take(si_val, mi).astype(out_dtype)
    if scalek is not None:
        keep &= jnp.take(sk_pres, mj) & (jnp.take(sk_val, mj) != 0)
        val = val * jnp.take(sk_val, mj).astype(out_dtype)

    result = dataclasses.replace(merged, vals=val)
    if cap is None:
        nkeep = jnp.sum(keep)
        if _is_concrete(nkeep):
            cap = round_up_pow2(int(nkeep))
        else:
            cap = expand_cap
    return filter_compact(result, keep, cap=cap)


@traced("spsparse.multiply_mv")
def multiply_mv(
    C,
    A: SparseCOO,
    V: SparseCOO,
    *,
    scalei: SparseCOO | None = None,
    scalej: SparseCOO | None = None,
    transpose_a: bool = False,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    cap: int | None = None,
    merge_method: str = "compact",
) -> SparseCOO:
    """MV chain: ``C · diag(scalei) · A^(T?) · diag(scalej) · V``.

    Reference: ``multiply`` (MV overload), ``multiply_sparse.hpp:281-365``.
    ``V`` is a sparse rank-1 array; it is consolidated first (``:313``).
    Returns a sorted rank-1 :class:`SparseCOO` over present rows.
    """
    if A.rank != 2 or V.rank != 1:
        spsparse_error(-1, "multiply (MV) requires rank-2 A and rank-1 V")
    Aw = A.transposed((1, 0)) if transpose_a else A
    out_len = Aw.shape[0]
    if Aw.shape[1] != V.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and V (%d) must match!",
            Aw.shape[1], V.shape[0])

    acon = Aw if Aw.sort_order == (0, 1) else _consolidate(
        Aw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    vcon = V if V.sort_order == (0,) else _consolidate(
        V, (0,), duplicate_policy, zero_nan, method=merge_method)

    K = Aw.shape[1]
    v_pres, v_val = _dense_scale(vcon, K)
    sj_pres, sj_val = _dense_scale(scalej, K)
    si_pres, si_val = _dense_scale(scalei, out_len)

    out_dtype = jnp.result_type(A.vals, V.vals,
                                *(s.vals for s in (scalei, scalej)
                                  if s is not None),
                                C)

    # Per-A-entry contribution: a_ik * sj[k] * v[k], structurally zero where
    # either is absent (the 2/3-way join of multiply_sparse.hpp:336-354).
    live = acon.valid_mask()
    k_a = jnp.minimum(
        jnp.where(live, acon.indices[:, 1], K).astype(jnp.int32), K)
    pres = jnp.take(v_pres, k_a) & live
    contrib = acon.vals.astype(out_dtype) * jnp.take(v_val, k_a).astype(out_dtype)
    if scalej is not None:
        pres &= jnp.take(sj_pres, k_a)
        contrib = contrib * jnp.take(sj_val, k_a).astype(out_dtype)
    contrib = jnp.where(pres, contrib, 0)

    # Row sums via segmented merge over the already-row-sorted entries. All
    # live A entries stay "valid" so every present A row produces a segment
    # (possibly summing to zero — dropped below, like the reference).
    rows = jnp.where(live, acon.indices[:, 0], out_len).astype(jnp.int32)
    merged = merge_sorted_entries(
        (rows,), contrib, live,
        shape=(out_len,), duplicate_policy=DuplicatePolicy.ADD,
        cap=acon.cap, sort_order=(0,), index_dtype=jnp.int32,
        method=merge_method)

    mlive = merged.valid_mask()
    keep = mlive & (merged.vals != 0) & jnp.asarray(C != 0)
    val = merged.vals * jnp.asarray(C, out_dtype)
    mi = jnp.minimum(merged.indices[:, 0], out_len)
    if scalei is not None:
        keep &= jnp.take(si_pres, mi) & (jnp.take(si_val, mi) != 0)
        val = val * jnp.take(si_val, mi).astype(out_dtype)

    result = dataclasses.replace(merged, vals=val)
    if cap is None:
        nkeep = jnp.sum(keep)
        cap = (round_up_pow2(int(nkeep)) if _is_concrete(nkeep)
               else merged.cap)
    return filter_compact(result, keep, cap=cap)


def multiply_chain(ret_unused=None, C=1.0, scalei=None, A=None, tA=".",
                   scalej=None, B=None, tB=".", scalek=None,
                   duplicate_policy=DuplicatePolicy.ADD, zero_nan=False):
    """Positional-parity shim mirroring the reference signature
    (``multiply_sparse.hpp:139-150``); prefer :func:`multiply`."""
    return multiply(C, A, B, scalei=scalei, scalej=scalej, scalek=scalek,
                    transpose_a=(tA == "T"), transpose_b=(tB == "T"),
                    duplicate_policy=duplicate_policy, zero_nan=zero_nan)
