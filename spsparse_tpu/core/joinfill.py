"""Sort-based joins: replacements for per-element gather/scatter.

On devices whose gathers and scatters run one element at a time, any
"gather payloads by key" operation is faster phrased as one stable merge
sort + a vectorized forward fill + one compaction sort. GPUs and CPUs
gather natively, so the library defaults to the gather phrasing there
(:func:`use_join_default`); this module provides the sort phrasing:

``merge_fill_compact(keys_e, payloads_e, keys_q, payloads_q, n_out)``
    joins each *query* to the last *entry* whose key is <= the query's
    key, returning the queries in key order with the matched entry
    payloads attached. This one primitive expresses run-length decode
    ("spread"), table lookup by sorted/unsorted key, and positional
    gather from a sorted source — the three shapes the ESC SpGEMM
    expansion needs (see ops.multiply.expand_products_raw).

The reference's iterator-based Gustavson walk
(multiply_sparse.hpp:152-248) does these lookups with pointer chasing;
this is the sort-based array equivalent.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

Array = Any

__all__ = ["forward_fill_marked", "merge_fill_compact",
           "row_ptr_from_sorted_rows", "row_ids_from_row_ptr",
           "use_join_default"]


def use_join_default() -> bool:
    """Whether ``method=None`` lookups use the sort-based join instead of
    per-element gathers. False: GPUs and CPUs gather natively, so the
    ``searchsorted`` form is the default everywhere; the join stays
    available by name."""
    return False


def forward_fill_marked(marker, payloads: Sequence[Array]):
    """For each position, the payload values at the last position ``<=`` it
    where ``marker`` is True; positions before the first marked one
    receive position 0's payload (callers exploit this: in
    :func:`merge_fill_compact` the padded query rows carry zeros, so
    unmatched queries zero-fill). Vectorized: one
    ``lax.associative_scan`` with a carry-last-marked operator — no
    gathers. Large streams route through the chunked form (scan lowering
    is the n^2.5 compile hog on this rig — core.chunksort)."""
    from . import chunksort

    if jnp.shape(marker)[0] > chunksort.SCAN_CHUNK_ELEMS:
        return chunksort.chunked_forward_fill(marker, tuple(payloads))
    return chunksort._fill_scan(marker, tuple(payloads))[1:]


def merge_fill_compact(keys_e, payloads_e: Sequence[Array],
                       keys_q, payloads_q: Sequence[Array],
                       n_out: int, *, key_bound: int | None = None):
    """Join queries to entries by key: each query receives the payloads of
    the LAST entry with ``key_e <= key_q`` (ties: the entry wins — i.e.
    an entry with the same key as the query is matched).

    Returns ``(filled_entry_payloads, query_payloads)`` — tuples of arrays
    of length ``n_out`` — ordered by ascending query key, stable among
    equal-key queries (original query order). Queries with keys below
    every entry key get the entry payloads' zero-fill; callers mask via
    their own validity payloads.

    Exclude an entry or query from the join by setting its key >= the
    maximum real key of the other side (sentinel keys sort to the end and
    are dropped by the ``n_out`` compaction or masked by the caller).

    Implementation: one stable single-key sort of the concatenated
    streams (entries keyed ``2k``, queries ``2k+1`` so entries precede
    equal-key queries), a vectorized forward fill
    (:func:`forward_fill_marked`), and one compaction sort
    (:func:`spsparse_tpu.core.consolidate.compact_select`).
    """
    from .consolidate import compact_select

    keys_e = jnp.asarray(keys_e)
    keys_q = jnp.asarray(keys_q)
    n_e = keys_e.shape[0]
    n_q = keys_q.shape[0]
    if key_bound is None:
        # No bound given: doubling must not wrap. Widen to int64 whenever
        # the platform allows it (x64 on); otherwise int32 is all we
        # have, so check concrete keys eagerly and demand a key_bound for
        # traced ones (a silent 2k+1 wrap at keys >= 2^30 garbles the
        # sort — every internal caller passes key_bound).
        if jax.config.jax_enable_x64:
            kdtype = jnp.int64
        else:
            kdtype = jnp.int32
            lim = (jnp.iinfo(jnp.int32).max - 1) // 2
            for ks in (keys_e, keys_q):
                try:
                    mx = int(ks.max()) if ks.size else 0
                except Exception:
                    continue      # traced: caller's responsibility
                if mx > lim:
                    raise ValueError(
                        f"merge_fill_compact: key {mx} would overflow the "
                        "doubled int32 key; pass key_bound (int64 keys "
                        "need jax_enable_x64)")
    elif 2 * (key_bound + 1) >= jnp.iinfo(jnp.int32).max:
        kdtype = jnp.int64
    else:
        kdtype = jnp.int32
    k2 = jnp.concatenate([
        keys_e.astype(kdtype) * 2,
        keys_q.astype(kdtype) * 2 + 1,
    ])
    is_entry = jnp.concatenate([
        jnp.ones((n_e,), bool), jnp.zeros((n_q,), bool)])

    def pad_e(p):
        z = jnp.zeros((n_q,) + p.shape[1:], p.dtype)
        return jnp.concatenate([p, z])

    def pad_q(p):
        z = jnp.zeros((n_e,) + p.shape[1:], p.dtype)
        return jnp.concatenate([z, p])

    ep = tuple(pad_e(jnp.asarray(p)) for p in payloads_e)
    qp = tuple(pad_q(jnp.asarray(p)) for p in payloads_q)

    srt = jax.lax.sort((k2, is_entry) + ep + qp, num_keys=1, is_stable=True)
    s_entry = srt[1]
    s_ep = srt[2:2 + len(ep)]
    s_qp = srt[2 + len(ep):]

    filled = forward_fill_marked(s_entry, s_ep)
    comp, _ = compact_select(~s_entry, tuple(filled) + tuple(s_qp),
                             cap_out=n_out)
    return comp[:len(filled)], comp[len(filled):]


def row_ptr_from_sorted_rows(rows, nrows: int, *, method: str = "auto"):
    """CSR ``row_ptr (nrows+1,)`` from a sorted per-entry row vector
    (padding rows = ``nrows`` sentinel). ``row_ptr[r]`` = first entry
    index with ``rows[p] >= r``.

    ``searchsorted`` phrases this as nrows+1 binary searches — log2(cap)
    rounds of per-element gathers; the join phrasing is one merge + fill
    + compact."""
    if method == "auto":
        method = "join" if use_join_default() else "searchsorted"
    rows = jnp.asarray(rows)
    if method == "searchsorted":
        return jnp.searchsorted(
            rows, jnp.arange(nrows + 1, dtype=rows.dtype), side="left"
        ).astype(jnp.int32)
    cap = rows.shape[0]
    # last entry p with rows[p] <= r-1  <=>  key rows+1 <= query key r;
    # payload p+1 so the no-match zero fill yields row_ptr 0.
    (p1,), _ = merge_fill_compact(
        rows.astype(jnp.int64) + 1 if nrows + 2 >= 2 ** 31 else
        rows.astype(jnp.int32) + 1,
        (jnp.arange(1, cap + 1, dtype=jnp.int32),),
        jnp.arange(nrows + 1, dtype=jnp.int32), (),
        nrows + 1, key_bound=nrows + 2)
    return p1.astype(jnp.int32)


def row_ids_from_row_ptr(row_ptr, cap: int, *, method: str = "auto"):
    """Per-entry row ids from CSR ``row_ptr``: entry ``p`` belongs to the
    last row ``r`` with ``row_ptr[r] <= p`` (padding entries past
    ``row_ptr[-1]`` get ``nrows``). Join phrasing of
    ``searchsorted(row_ptr, arange(cap), 'right') - 1``."""
    if method == "auto":
        method = "join" if use_join_default() else "searchsorted"
    row_ptr = jnp.asarray(row_ptr)
    if method == "searchsorted":
        return (jnp.searchsorted(
            row_ptr, jnp.arange(cap, dtype=row_ptr.dtype), side="right"
        ).astype(jnp.int32) - 1)
    nrows1 = row_ptr.shape[0]
    (r_of,), _ = merge_fill_compact(
        row_ptr.astype(jnp.int32), (jnp.arange(nrows1, dtype=jnp.int32),),
        jnp.arange(cap, dtype=jnp.int32), (),
        cap, key_bound=cap + 1)
    return r_of
