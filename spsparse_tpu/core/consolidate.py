"""Consolidation: stable lexicographic sort + duplicate merge + zero drop.

Array-native re-design of the reference's sort/consolidate layer
(/root/reference/slib/spsparse/algorithm.hpp:237-427):

* ``sorted_permutation`` — stable lexsort permutation (reference
  ``algorithm.hpp:411-427``; stability is what makes the LEAVE_ALONE=first /
  REPLACE=last duplicate policies well-defined, ``algorithm.hpp:404-406``).
* ``consolidate`` — sort by ``sort_order``, drop structural zeros (always)
  and NaNs (iff ``zero_nan``), merge duplicate index tuples per
  ``DuplicatePolicy``, mark result sorted (reference ``algorithm.hpp:251-319``).

Where the reference runs ``std::stable_sort`` with a per-element comparator
and a sequential dedup scan, this version is one multi-key
``jax.lax.sort`` (keys = index columns in ``sort_order``, stable, padding
pushed to the end via the out-of-range sentinel) followed by a vectorized
segmented merge (boundary mask → prefix-sum segment ids → segment reduce /
first / last gather). Everything is static-shape and jit-compatible; the
live-entry count travels as the ``nnz`` scalar.

Note on the reference's mid-loop ``zero_nan`` quirk (``algorithm.hpp:291``
drops only zeros mid-stream while ``:274`` also drops NaNs at the head):
this framework implements the *documented* semantics — NaNs are dropped
uniformly iff ``zero_nan`` — and the divergence is pinned in tests.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .coo import SparseCOO
from .errors import DuplicatePolicy, isnone
from ..utils.trace import traced

__all__ = [
    "consolidate",
    "sorted_permutation",
    "merge_sorted_entries",
    "sort_entry_stream",
    "fused_sort_merge",
    "filter_compact",
    "Consolidated",
]


def compact_select(select, carried, *, cap_out: int):
    """Order-preserving compaction of the ``select``-flagged entries of
    parallel arrays to the front, without scatters.

    Uses one stable single-key ``lax.sort`` (selected entries get key 0,
    the rest key 1; stability preserves order within each class) instead
    of a scatter, whose per-element cost varies widely between devices.
    Returns ``(compacted_arrays, n_selected)``;
    each output is resized to ``cap_out`` (slice or pad at the end — the
    tail is unselected-class data that callers must mask via
    ``n_selected``).
    """
    for arr in carried:
        if jnp.ndim(arr) != 1:
            # lax.sort requires every operand to share ONE shape, so a
            # (n, k) payload cannot ride a (n,) key — reshape/split it
            # into per-column 1-D arrays at the call site.
            raise ValueError(
                "compact_select carries 1-D arrays only; got shape "
                f"{jnp.shape(arr)}")
    from . import chunksort
    if select.shape[0] > chunksort.ENGAGE_ELEMS:
        # Compile-bounded route (core.chunksort): the chunked formulation
        # keeps every lax.sort instance <= CHUNK_ELEMS with
        # streaming-only glue. Identical contract (exact,
        # order-preserving).
        return chunksort.chunked_compact_select(select, tuple(carried),
                                                cap_out=cap_out)
    key = jnp.where(select, jnp.int32(0), jnp.int32(1))
    n_sel = jnp.sum(select).astype(jnp.int32)
    out = jax.lax.sort((key,) + tuple(carried), num_keys=1, is_stable=True)
    comp = []
    n = key.shape[0]
    for arr in out[1:]:
        if cap_out <= n:
            comp.append(arr[:cap_out])
        else:
            comp.append(jnp.pad(arr, (0, cap_out - n)))
    return tuple(comp), n_sel


def filter_compact(a: SparseCOO, keep, *, cap: int | None = None) -> SparseCOO:
    """Keep only entries where ``keep`` is true, compacting to the front.

    Order-preserving (so sortedness metadata survives); jit-compatible.
    ``keep`` is a ``(cap,)`` boolean mask; entries outside the live range are
    dropped regardless. Implemented with :func:`compact_select` (stable
    sort), not scatter — see that docstring for why.
    """
    keep = jnp.asarray(keep) & a.valid_mask()
    cap_out = a.cap if cap is None else int(cap)
    dtype = a.index_dtype
    limit = 2 ** 62 if dtype == jnp.int64 else 2 ** 31
    exts = [int(s) + 1 for s in a.shape]
    plan = _plan_packing(exts, limit)
    cols = [a.indices[:, d] for d in range(a.rank)]
    words = _pack_cols(cols, exts, plan, dtype)
    (comp_out), n_out = compact_select(
        keep, tuple(words) + (a.vals,), cap_out=cap_out)
    out_cols = _unpack_cols(comp_out[:len(words)], exts, plan, dtype)
    out_vals = comp_out[len(words)]
    n_out = jnp.minimum(n_out, cap_out).astype(jnp.int32)
    return SparseCOO(indices=jnp.stack(out_cols, axis=1), vals=out_vals,
                     nnz=n_out, shape=a.shape,
                     sort_order=a.sort_order).repad()


def _plan_packing(extents: Sequence[int], limit: int) -> list[list[int]]:
    """Greedily group consecutive column extents into words whose value
    range stays below ``limit``. Returns a list of groups of column
    positions; lexicographic order over the packed words equals the
    original column-wise lexicographic order."""
    words: list[list[int]] = []
    cur: list[int] = []
    prod = 1
    for pos, e in enumerate(extents):
        e = max(int(e), 1)
        if cur and prod * e <= limit:
            cur.append(pos)
            prod *= e
        else:
            if cur:
                words.append(cur)
            cur = [pos]
            prod = e
    if cur:
        words.append(cur)
    return words


def _pack_cols(col_arrays, extents, words, dtype):
    """Pack column arrays into mixed-radix words per ``words`` plan."""
    packed = []
    for grp in words:
        mult = 1
        word = None
        for pos in reversed(grp):
            contrib = col_arrays[pos].astype(dtype) * jnp.asarray(mult, dtype)
            word = contrib if word is None else word + contrib
            mult *= max(int(extents[pos]), 1)
        packed.append(word)
    return packed


def _unpack_cols(packed, extents, words, dtype):
    """Inverse of :func:`_pack_cols` (div/mod per column)."""
    cols = [None] * len(extents)
    for word, grp in zip(packed, words):
        mult = 1
        for pos in reversed(grp):
            e = max(int(extents[pos]), 1)
            cols[pos] = ((word // mult) % e).astype(dtype)
            mult *= e
    return cols


def _stable_word_sort(key_words, payloads, *, exts_key_plan_max: int):
    """Stable sort of an entry stream by its packed key word(s) with
    payloads riding along — routed through the compile-bounded chunked
    PSRS (:mod:`.chunksort`) when the stream is large, the key packs
    into ONE word, and appending position bits keeps the composite under
    63 bits (uniqueness makes PSRS exact and stability automatic).
    Falls back to a plain stable ``lax.sort`` otherwise. Returns the
    operand tuple in ``lax.sort`` order: key words then payloads."""
    from . import chunksort

    n = key_words[0].shape[0]
    # The composite (key, position) word needs int64, which JAX only
    # provides under jax_enable_x64 — without it the astype silently
    # truncates to int32 and corrupts the sort.
    if (n > chunksort.ENGAGE_ELEMS and len(key_words) == 1
            and jax.config.jax_enable_x64):
        pos_bits = max((n - 1).bit_length(), 1)
        if (exts_key_plan_max << pos_bits) <= (1 << 62):
            w = key_words[0].astype(jnp.int64)
            pos = jnp.arange(n, dtype=jnp.int64)
            comp = (w << pos_bits) | pos
            sw, spay = chunksort.chunked_sort_unique(comp, tuple(payloads))
            return ((sw >> pos_bits).astype(key_words[0].dtype),) + spay
    out = jax.lax.sort(tuple(key_words) + tuple(payloads),
                       num_keys=len(key_words), is_stable=True)
    return out


def sort_entry_stream(col_arrays, vals, live, *, extents, extra=(),
                      num_key_cols: int | None = None):
    """Stable sort of a (columns, vals) entry stream by its leading columns.

    The core shared by :func:`consolidate` and the ESC SpGEMM compress
    phase. ``lax.sort`` cost grows with the *number of operand arrays*,
    so index columns are packed into as few mixed-radix
    words as the index dtype allows (each column gets ``extent+1`` headroom
    so the sentinel ``extent`` survives packing), dead entries are encoded
    as all-sentinel keys (no separate validity array — liveness is recovered
    as ``word0 != max``), and columns are reconstructed by div/mod after the
    sort. Returns ``(cols, vals, live, extras)`` sorted.
    """
    ncols = len(col_arrays)
    if num_key_cols is None:
        num_key_cols = ncols
    dtype = col_arrays[0].dtype
    limit = 2 ** 62 if dtype == jnp.int64 else 2 ** 31
    exts = [int(e) + 1 for e in extents]

    sent_cols = [
        jnp.where(live, col_arrays[d], jnp.asarray(extents[d], dtype))
        for d in range(ncols)
    ]
    vals = jnp.where(live, vals, jnp.zeros((), vals.dtype))

    key_words_plan = _plan_packing(exts[:num_key_cols], limit)
    other_plan = _plan_packing(exts[num_key_cols:], limit)
    key_words = _pack_cols(sent_cols[:num_key_cols], exts[:num_key_cols],
                           key_words_plan, dtype)
    other_words = _pack_cols(sent_cols[num_key_cols:], exts[num_key_cols:],
                             other_plan, dtype)

    max0 = 1
    for pos in key_words_plan[0]:
        max0 *= exts[pos]
    out = _stable_word_sort(
        key_words, tuple(other_words) + (vals,) + tuple(extra),
        exts_key_plan_max=max0)
    skey = out[: len(key_words)]
    sother = out[len(key_words): len(key_words) + len(other_words)]
    svals = out[len(key_words) + len(other_words)]
    sextra = out[len(key_words) + len(other_words) + 1:]

    # Dead entries are all-sentinel: their first packed word is the maximum
    # packable value; any live entry is strictly below it (every live column
    # is < extent).
    slive = skey[0] != jnp.asarray(max0 - 1, dtype)

    skey_cols = _unpack_cols(skey, exts[:num_key_cols], key_words_plan,
                             dtype)
    sother_cols = _unpack_cols(sother, exts[num_key_cols:], other_plan,
                               dtype)
    return skey_cols + sother_cols, svals, slive, sextra


def _sort_operands(a: SparseCOO, sort_order: Sequence[int], extra=(),
                   live=None):
    """Stable-sort the entries of ``a`` by its index columns in ``sort_order``.

    Invalid (padding / structurally-zero) entries get sentinel keys so they
    sort to the end. ``live`` overrides the validity mask (defaults to
    ``a.valid_mask()``). Returns ``(sorted_index_cols_natural_order,
    sorted_vals, sorted_valid_mask, sorted_extras)``.
    """
    rank = a.rank
    sort_order = tuple(sort_order)
    if live is None:
        live = a.valid_mask()
    other_dims = [d for d in range(rank) if d not in sort_order]
    dim_order = list(sort_order) + other_dims

    cols_in = [a.indices[:, d] for d in dim_order]
    extents = [a.shape[d] for d in dim_order]
    scols, svals, slive, sextra = sort_entry_stream(
        cols_in, a.vals, live, extents=extents, extra=extra,
        num_key_cols=len(sort_order))

    # Reassemble index columns in natural dimension order.
    cols: list = [None] * rank
    for pos, d in enumerate(dim_order):
        cols[d] = scols[pos]
    return cols, svals, slive, sextra


def sorted_permutation(a: SparseCOO, sort_order: Sequence[int]) -> jnp.ndarray:
    """Stable lexsort permutation over the *live* entries of ``a``.

    Mirrors reference ``sorted_permutation`` (``algorithm.hpp:411-427``):
    returns positions such that iterating ``a`` entries at those positions
    visits them in ``sort_order``-lexicographic order, ties in insertion
    order. Shape ``(cap,)``; entries past ``nnz`` are the padding positions.
    """
    pos = jnp.arange(a.cap, dtype=jnp.int32)
    _, _, _, (sperm,) = _sort_operands(a, sort_order, extra=(pos,))
    return sperm


def merge_sorted_entries(
    index_cols: Sequence[jnp.ndarray],
    vals: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    shape: Sequence[int],
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    cap: int,
    sort_order: tuple | None = None,
    index_dtype=None,
    method: str = "compact",
) -> SparseCOO:
    """Merge runs of equal index tuples in already-sorted entry streams.

    The vectorized equivalent of the reference's sequential dedup scan
    (``algorithm.hpp:269-314``). Inputs are parallel arrays sorted so that
    equal index tuples are adjacent, valid entries precede invalid ones, and
    insertion order is preserved within runs (what a stable sort yields).

    * ``ADD``: segment sum.
    * ``LEAVE_ALONE``: first value of each run (``algorithm.hpp:307`` — no-op
      on later duplicates).
    * ``REPLACE``: last value of each run (``algorithm.hpp:309-310``).

    ``method``:

    * ``"compact"`` (default): run representatives are compacted to the
      front with one stable single-key sort (:func:`compact_select`); ADD
      sums come from a *segmented* prefix scan read at run ends. Float
      sums are per-run
      tree reductions — error O(run_len * eps) relative to the *run*
      magnitude (not bitwise-identical to a left-to-right scan; integer
      sums, via plain cumsum differences, are exact). Round-2 note: an
      earlier version differenced one global cumsum, whose
      O(total_sum * eps) cancellation error reached ~1e-4 absolute on
      f32 inputs with ~1e4 total — the segmented scan fixed it.
    * ``"scatter"``: the round-1 formulation (XLA scatter-add/set). Run
      sums accumulate left-to-right per run — bitwise parity with the
      reference's sequential scan — at scatter speed.

    Returns a compact :class:`SparseCOO` of capacity ``cap``; runs beyond
    ``cap`` are dropped (callers choose ``cap`` >= worst case when exactness
    is required — consolidation's worst case is the input capacity).
    """
    n = vals.shape[0]
    index_dtype = index_dtype or index_cols[0].dtype
    vals = jnp.where(valid, vals, jnp.zeros((), vals.dtype))

    same_as_prev = jnp.ones((n,), bool)
    for col in index_cols:
        same_as_prev &= col == jnp.roll(col, 1)
    same_as_prev = same_as_prev.at[0].set(False)
    is_new = valid & ~same_as_prev
    n_out = jnp.sum(is_new).astype(jnp.int32)
    shape = tuple(int(s) for s in shape)

    if method == "compact":
        limit = 2 ** 62 if index_dtype == jnp.int64 else 2 ** 31
        exts = [int(s) + 1 for s in shape]
        plan = _plan_packing(exts, limit)
        sent_cols = [
            jnp.where(valid, c.astype(index_dtype),
                      jnp.asarray(shape[d], index_dtype))
            for d, c in enumerate(index_cols)
        ]
        words = _pack_cols(sent_cols, exts, plan, index_dtype)
        return _merge_compact_words(
            words, vals, valid, is_new, exts=exts, plan=plan,
            dim_order=tuple(range(len(shape))), shape=shape,
            duplicate_policy=duplicate_policy, cap=cap,
            sort_order=sort_order, index_dtype=index_dtype, n_out=n_out)

    # ---- scatter formulation (reference-bitwise ADD accumulation) ----
    seg_id = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # -1 before first run
    drop = jnp.asarray(cap, jnp.int32)
    start_tgt = jnp.where(is_new, seg_id, drop)

    if duplicate_policy == DuplicatePolicy.ADD:
        seg_for_sum = jnp.where(valid & (seg_id >= 0), seg_id, drop)
        out_vals = jnp.zeros((cap,), vals.dtype).at[seg_for_sum].add(
            vals, mode="drop")
    elif duplicate_policy == DuplicatePolicy.LEAVE_ALONE:
        out_vals = jnp.zeros((cap,), vals.dtype).at[start_tgt].set(
            vals, mode="drop")
    elif duplicate_policy == DuplicatePolicy.REPLACE:
        is_last = _run_last(is_new, valid)
        end_tgt = jnp.where(is_last, seg_id, drop)
        out_vals = jnp.zeros((cap,), vals.dtype).at[end_tgt].set(
            vals, mode="drop")
    else:  # pragma: no cover
        raise ValueError(f"unknown duplicate policy {duplicate_policy}")

    sent = SparseCOO.sentinel_index(shape, index_dtype)
    out_cols = []
    for k, col in enumerate(index_cols):
        out_col = jnp.full((cap,), sent[k], dtype=index_dtype).at[
            start_tgt].set(col.astype(index_dtype), mode="drop")
        out_cols.append(out_col)
    out_idx = jnp.stack(out_cols, axis=1)

    out = SparseCOO(indices=out_idx, vals=out_vals,
                    nnz=jnp.minimum(n_out, cap).astype(jnp.int32),
                    shape=shape, sort_order=sort_order)
    return out.repad()


def _run_last(is_new, valid):
    """A valid entry ends its run iff the next entry starts a new run or
    there is no next valid entry (valid entries are contiguous)."""
    n = is_new.shape[0]
    nxt = jnp.arange(n, dtype=jnp.int32) + 1
    next_new = jnp.where(nxt < n, jnp.roll(is_new, -1), True)
    next_valid = jnp.where(nxt < n, jnp.roll(valid, -1), False)
    return valid & (next_new | ~next_valid)


def _segmented_cumsum(x, is_start):
    """Inclusive prefix sum restarting at every ``is_start`` position.

    Classic segmented-scan operator under ``associative_scan`` (log-depth,
    fully vectorized). Reading the result at a run's last position yields
    the run's sum as a per-run tree reduction — no cancellation against
    the global prefix (a global ``cumsum[end] - cumsum[prev_end]`` loses
    O(total_sum * eps), which measured ~1e-4 absolute on f32 streams with
    ~1e4 totals). Large streams route through the chunked form
    (core.chunksort)."""
    from . import chunksort

    # scans chunk already above CHUNK_ELEMS (not ENGAGE_ELEMS): their
    # lowering is the compile hog and the chunked form's exec overhead
    # is negligible
    if x.shape[0] > chunksort.SCAN_CHUNK_ELEMS:
        return chunksort.chunked_segmented_cumsum(x, is_start)
    return chunksort._seg_scan(x, is_start)


def _cumsum(x):
    """``jnp.cumsum`` with the same compile-bounded routing."""
    from . import chunksort

    if x.shape[0] > chunksort.CHUNK_ELEMS:
        return chunksort.chunked_cumsum(x)
    return jnp.cumsum(x)


def _merge_compact_words(words, vals, valid, is_new, *, exts, plan,
                         dim_order, shape, duplicate_policy, cap,
                         sort_order, index_dtype, n_out):
    """Scatter-free merge on *packed-word* entry streams: pick one
    representative per run, compact representatives to the front with a
    stable sort, unpack columns exactly once at the end.

    ``words`` are the mixed-radix packed (sentinel-encoded) index words in
    ``dim_order``; keeping them packed through the merge is the round-3
    fusion — round 2 unpacked after the primary sort and re-packed before
    the compaction, paying ``rank`` div/mod passes plus ``rank`` FMA
    passes per consolidate for nothing (packing is injective, so run
    boundaries and compaction work on words directly)."""
    floating = jnp.issubdtype(vals.dtype, jnp.floating)
    add_needs_diff = False
    nonfinite_cond = False
    if duplicate_policy == DuplicatePolicy.ADD:
        select = _run_last(is_new, valid)
        if floating:
            # A plain scan would poison every run after the first
            # non-finite value. Scan the finite part; non-finite runs are
            # patched from integer presence counts (any NaN -> NaN; +inf
            # and -inf -> NaN; else the surviving inf). The counts are
            # computed AND carried through the compaction sort only on
            # the (rare) inputs that actually contain non-finite values —
            # a runtime ``lax.cond`` both skips their cumsum passes and
            # picks the 3-fewer-operand sort otherwise.
            finite = jnp.isfinite(vals)
            carry_val = _segmented_cumsum(jnp.where(finite, vals, 0),
                                          is_new)
            nonfinite_cond = True
        else:
            # Integer cumsum differences are exact — skip the segmented
            # scan's second carried operand.
            carry_val = _cumsum(vals)
            add_needs_diff = True
    elif duplicate_policy == DuplicatePolicy.LEAVE_ALONE:
        select = is_new
        carry_val = vals
    elif duplicate_policy == DuplicatePolicy.REPLACE:
        select = _run_last(is_new, valid)
        carry_val = vals
    else:  # pragma: no cover
        raise ValueError(f"unknown duplicate policy {duplicate_policy}")

    if nonfinite_cond:
        def with_counts(ops):
            sel, base, v = ops
            counts = (_cumsum(jnp.isnan(v).astype(jnp.int32)),
                      _cumsum((v == jnp.inf).astype(jnp.int32)),
                      _cumsum((v == -jnp.inf).astype(jnp.int32)))
            comp, _ = compact_select(sel, base + counts, cap_out=cap)
            return comp

        def without_counts(ops):
            sel, base, v = ops
            comp, _ = compact_select(sel, base, cap_out=cap)
            # Derive the zeros from ``v`` so they carry the same
            # mesh-axis varying-ness under shard_map (a plain
            # ``jnp.zeros`` is replicated, and cond requires both
            # branches' outputs to vary over the same manual axes).
            z = jnp.zeros((cap,), jnp.int32) + (v[0] * 0).astype(jnp.int32)
            return comp + (z,) * 3

        any_nonfinite = ~jnp.all(finite)
        comp = jax.lax.cond(any_nonfinite, with_counts, without_counts,
                            (select, tuple(words) + (carry_val,), vals))
    else:
        comp, _ = compact_select(select, tuple(words) + (carry_val,),
                                 cap_out=cap)
    ordered_cols = _unpack_cols(comp[:len(words)], exts, plan, index_dtype)
    # Reassemble columns in natural dimension order (dim_order may be a
    # sort-key permutation when called from the fused consolidate path).
    out_cols: list = [None] * len(dim_order)
    for pos, d in enumerate(dim_order):
        out_cols[d] = ordered_cols[pos]
    cval = comp[len(words)]

    def run_diff(c):
        prev = jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])
        return c - prev

    if duplicate_policy == DuplicatePolicy.ADD:
        # Float: the segmented scan read at the run's end IS the run sum.
        # Int: inclusive-prefix at this run's end minus at the previous
        # run's end (runs tile the valid prefix contiguously; exact).
        out_vals = run_diff(cval) if add_needs_diff else cval
        if nonfinite_cond:
            n_nan, n_pos, n_neg = (run_diff(comp[len(words) + 1 + i])
                                   for i in range(3))
            out_vals = jnp.where(n_pos > 0, jnp.asarray(
                jnp.inf, out_vals.dtype), out_vals)
            out_vals = jnp.where(n_neg > 0, jnp.asarray(
                -jnp.inf, out_vals.dtype), out_vals)
            out_vals = jnp.where(
                (n_nan > 0) | ((n_pos > 0) & (n_neg > 0)),
                jnp.asarray(jnp.nan, out_vals.dtype), out_vals)
    else:
        out_vals = cval
    out = SparseCOO(indices=jnp.stack(out_cols, axis=1), vals=out_vals,
                    nnz=jnp.minimum(n_out, cap).astype(jnp.int32),
                    shape=shape, sort_order=sort_order)
    return out.repad()


def fused_sort_merge(col_arrays, vals, live, *, extents, shape,
                     dim_order=None,
                     duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                     cap: int, sort_order: tuple | None = None,
                     index_dtype=jnp.int32, with_run_count: bool = False):
    """Fused sort + duplicate-merge on an entry stream, entirely in
    packed-word space (the round-3 pipeline): sentinel-encode + pack the
    index columns into mixed-radix words, ONE stable ``lax.sort`` over
    the words, run boundaries from word equality, scatter-free compact
    merge carrying the words, and a single unpack at the end. Compared
    to ``sort_entry_stream`` + :func:`merge_sorted_entries` this removes
    ``rank`` div/mod passes + ``rank`` FMA passes + ``rank`` roll/compare
    passes per call.

    ``col_arrays`` are index columns in sort-key order; ``extents`` their
    extents in the same order; ``dim_order[pos]`` says which natural
    dimension position ``pos`` holds (identity when None). Returns the
    merged :class:`SparseCOO` (entries in the given sort order), plus the
    TRUE pre-clamp run count when ``with_run_count`` (the distributed
    overflow contract)."""
    ncols = len(col_arrays)
    if dim_order is None:
        dim_order = tuple(range(ncols))
    limit = 2 ** 62 if index_dtype == jnp.int64 else 2 ** 31
    exts = [int(e) + 1 for e in extents]
    plan = _plan_packing(exts, limit)
    sent_cols = [
        jnp.where(live, c.astype(index_dtype),
                  jnp.asarray(int(extents[p]), index_dtype))
        for p, c in enumerate(col_arrays)
    ]
    vals = jnp.where(live, vals, jnp.zeros((), vals.dtype))
    words = _pack_cols(sent_cols, exts, plan, index_dtype)

    max0 = 1
    for pos in plan[0]:
        max0 *= exts[pos]
    out = _stable_word_sort(words, (vals,), exts_key_plan_max=max0)
    swords, svals = out[:-1], out[-1]
    slive = swords[0] != jnp.asarray(max0 - 1, index_dtype)

    same_as_prev = jnp.ones_like(slive)
    for w in swords:
        same_as_prev &= w == jnp.roll(w, 1)
    same_as_prev = same_as_prev.at[0].set(False)
    is_new = slive & ~same_as_prev
    n_out = jnp.sum(is_new).astype(jnp.int32)

    merged = _merge_compact_words(
        swords, svals, slive, is_new, exts=exts, plan=plan,
        dim_order=dim_order, shape=shape,
        duplicate_policy=duplicate_policy, cap=cap,
        sort_order=sort_order, index_dtype=index_dtype, n_out=n_out)
    return (merged, n_out) if with_run_count else merged


@traced("spsparse.consolidate")
def consolidate(
    a: SparseCOO,
    sort_order: Sequence[int] | None = None,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    *,
    cap: int | None = None,
    method: str = "compact",
) -> SparseCOO:
    """Sort ``a`` by ``sort_order``, drop zeros/NaNs, merge duplicates.

    Functional equivalent of reference ``consolidate``
    (``algorithm.hpp:251-319``). Structural zeros in the *input* are dropped
    before merging (so a zero never overwrites under REPLACE); merged sums
    that happen to equal zero are kept, exactly like the reference (the
    dedup scan emits the accumulator unconditionally, ``algorithm.hpp:287``).
    The result is marked sorted with ``sort_order``.
    """
    if sort_order is None:
        sort_order = tuple(range(a.rank))
    sort_order = tuple(int(d) for d in sort_order)
    # A PARTIAL sort order is completed with the remaining dims (ascending)
    # as minor keys: merging is by FULL index-tuple equality, so duplicate
    # tuples must end up adjacent — sorting by the listed dims alone can
    # interleave them with other-dim entries and leave duplicates unmerged
    # (while still stamping the result "sorted").
    full_order = sort_order + tuple(
        d for d in range(a.rank) if d not in sort_order)
    cap_out = a.cap if cap is None else int(cap)

    # Structurally-zero entries (0, NaN iff zero_nan) are dropped up front —
    # they get sentinel keys and sort behind every real entry.
    live = a.valid_mask() & ~isnone(a.vals, zero_nan)

    if method != "compact":
        cols, svals, slive, _ = _sort_operands(a, full_order, live=live)
        return merge_sorted_entries(
            cols, svals, slive,
            shape=a.shape,
            duplicate_policy=duplicate_policy,
            cap=cap_out,
            sort_order=full_order,
            index_dtype=a.index_dtype,
            method=method,
        )

    # ---- fused packed-word path (round 3) ----
    # Index columns stay packed from the primary sort through the merge
    # compaction; one unpack at the very end. Run boundaries come from
    # word equality (packing is injective with the sentinel headroom), so
    # the rank-per-pass roll/compare/div/mod/FMA round trip between the
    # two sorts disappears.
    return fused_sort_merge(
        [a.indices[:, d] for d in full_order], a.vals, live,
        extents=[a.shape[d] for d in full_order], shape=a.shape,
        dim_order=full_order, duplicate_policy=duplicate_policy,
        cap=cap_out, sort_order=full_order, index_dtype=a.index_dtype)


class Consolidated:
    """Lazily consolidate only when needed (reference ``Consolidate`` RAII
    wrapper, ``algorithm.hpp:324-369``): if ``a.sort_order`` already matches,
    the original array is used as-is."""

    def __init__(self, a: SparseCOO, sort_order: Sequence[int],
                 duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                 zero_nan: bool = False, cap: int | None = None):
        sort_order = tuple(int(d) for d in sort_order)
        if a.sort_order == sort_order:
            self._a = a if cap is None else a.with_capacity(cap)
        else:
            self._a = consolidate(a, sort_order, duplicate_policy, zero_nan,
                                  cap=cap)

    def __call__(self) -> SparseCOO:
        return self._a
