"""Compile-bounded sorting and scans for large entry streams.

On the accelerator this library was first built for, compile time of
the consolidate pipeline grew superlinearly (~n^2.5) in the stream
length, dominated by the cumsum/``associative_scan`` glue rather than the
sorts. The fix is a *compile-bounded formulation*: keep every ``lax.sort`` **and every prefix-scan** instance
at <= ~1M elements and compose larger ones with streaming-only glue
(reshapes, batched ops, dynamic slices) whose compile cost is flat in
``n`` — measured: full 4M consolidate compiles in 76 s (was 1867 s).

Two primitives:

* :func:`chunked_compact_select` — order-preserving 2-class compaction of
  arbitrarily large streams: reshape to ``(k, c)``, one *batched* stable
  2-class sort (``lax.sort`` sorts each row independently; its compile cost
  scales with the row length ``c``, not ``k*c``), then stitch the selected
  prefixes with a forward ``dynamic_update_slice`` sweep — each chunk's
  write deliberately overruns into the next chunk's region and is
  overwritten by it, so no scatter and no size-``n`` sort ever exists.

* :func:`chunked_sort_unique` — PSRS (Parallel Sorting by Regular Sampling)
  for streams keyed by a single *totally ordered, duplicate-free* word
  (callers append position bits; uniqueness makes splitter routing exact
  and stability automatic): sort ``k`` chunks (one batched sort of length
  ``c``), pick ``k-1`` splitters by regular sampling (classic bound: no
  bucket exceeds ``2 n/k``), route each chunk's contiguous key ranges into
  buckets with the same forward-``dynamic_update_slice`` sweep, sort each
  bucket (one batched sort of length ``bcap``), and stitch the bucket
  prefixes. Total data movement ~4 passes + 2 chunk-length sorts' worth;
  compile time flat in ``n``.

Both are exact (not approximate) and jit-compatible with fully static
shapes. The reference has no counterpart (its ``std::stable_sort`` is
host-sequential, ``algorithm.hpp:424``); this is compile-time
plumbing. Whether the thresholds below still matter on a GPU is not yet
measured (ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import jax
import jax.numpy as jnp

Array = Any

__all__ = ["CHUNK_ELEMS", "SCAN_CHUNK_ELEMS", "chunk_count",
           "chunked_compact_select",
           "chunked_sort_unique", "chunked_cumsum",
           "chunked_segmented_cumsum"]

# Per-lax.sort instance size kept at or under this many elements.
CHUNK_ELEMS = 1 << 20

# Custom (tuple-carry) associative scans compile superlinearly in their
# length even as a lax.map body (~60 s at 2^20); a shorter scan chunk
# costs only extra sequential map steps, so scans chunk much finer.
SCAN_CHUNK_ELEMS = 1 << 18

# Sort auto-routing threshold. Monolithic stable sorts compiled ~flat in
# n and ran faster than the chunked (PSRS) pipeline; the compile blowup
# was the scan glue. Direct sorts therefore stay in place far beyond the
# scan threshold; the chunked sort/compaction machinery remains as a
# safety net for larger streams (and for callers that want bounded
# compile at any cost — set this lower to re-engage it).
ENGAGE_ELEMS = 1 << 25


def chunk_count(n: int, chunk: int = CHUNK_ELEMS) -> int:
    """Number of chunks for an ``n``-element stream (1 = don't chunk)."""
    return max(1, -(-n // chunk))


def _pad_to(arrs, total, fill):
    out = []
    for a, f in zip(arrs, fill):
        pad = total - a.shape[0]
        if pad:
            a = jnp.concatenate(
                [a, jnp.full((pad,), f, a.dtype)])
        out.append(a)
    return out


def _stitch_prefixes(rows, counts, cap_out: int, fill):
    """Concatenate the live prefixes of ``rows[i] (k, c)`` into one
    ``(cap_out,)`` array per operand, without scatters.

    Forward ``dynamic_update_slice`` sweep: chunk ``i``'s full row is
    written at offset ``sum(counts[:i])``; its padding tail lands in the
    next chunk's region and is overwritten by it. The final tail beyond
    ``sum(counts)`` is overwritten with ``fill``  by masking afterwards.
    Writes are streaming copies (compile cost flat in ``k`` and ``c``).
    """
    k, c = rows[0].shape
    offs = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts.astype(jnp.int32))])
    # 2c headroom: counts may exceed cap_out by up to c-1 (internal
    # padding counted as live by callers that pad with duplicate
    # sentinels), and each write is c long — lax.dynamic_update_slice
    # CLAMPS an overrunning start, which would silently overwrite real
    # data; the extra chunk of headroom makes every write in-bounds
    buf_len = cap_out + 2 * c
    bufs = [jnp.full((buf_len,), f, r.dtype) for r, f in zip(rows, fill)]

    # unrolled when k is small (device While loops carry a large
    # per-iteration overhead on this rig); fori fallback bounds the
    # program size for very large streams
    bufs = tuple(bufs)
    if k <= 32:
        for i in range(k):
            off = offs[i]
            bufs = tuple(
                jax.lax.dynamic_update_slice(buf, r[i], (off,))
                for buf, r in zip(bufs, rows))
    else:
        def body(i, bufs):
            off = offs[i]
            return tuple(
                jax.lax.dynamic_update_slice(buf, r[i], (off,))
                for buf, r in zip(bufs, rows))

        bufs = jax.lax.fori_loop(0, k, body, bufs)
    total = offs[k]
    live = jnp.arange(cap_out, dtype=jnp.int32) < total
    outs = tuple(jnp.where(live, b[:cap_out], jnp.asarray(f, b.dtype))
                 for b, f in zip(bufs, fill))
    return outs, total


def chunked_compact_select(select, carried: Sequence[Array], *,
                           cap_out: int, chunk: int = CHUNK_ELEMS):
    """Drop-in for :func:`.consolidate.compact_select` at large ``n``:
    same contract (selected entries compacted to the front in order,
    returns ``(compacted, n_selected)``; the tail past ``n_selected`` is
    unspecified-but-deterministic data the caller must mask), but every
    internal ``lax.sort`` instance is at most ``chunk`` elements long.
    """
    n = select.shape[0]
    k = chunk_count(n, chunk)
    c = -(-n // k)
    total = k * c
    sel = _pad_to([select], total, [False])[0]
    ops = _pad_to(list(carried), total, [0] * len(carried))
    key = jnp.where(sel, jnp.int32(0), jnp.int32(1)).reshape(k, c)
    rows = jax.lax.sort(
        (key,) + tuple(o.reshape(k, c) for o in ops),
        dimension=1, num_keys=1, is_stable=True)[1:]
    counts = jnp.sum(sel.reshape(k, c), axis=1).astype(jnp.int32)
    outs, n_sel = _stitch_prefixes(list(rows), counts, cap_out,
                                   [0] * len(rows))
    return outs, n_sel


def _seg_scan(x, is_start):
    """Inclusive segmented prefix sum (restart at ``is_start``) along the
    LAST axis via ``associative_scan`` — shared by the direct and chunked
    routes."""
    def op(a, b):
        va, fa = a
        vb, fb = b
        return (vb + jnp.where(fb, jnp.zeros((), va.dtype), va), fa | fb)

    v, _ = jax.lax.associative_scan(op, (x, is_start), axis=-1)
    return v


def chunked_cumsum(x: Array, *, chunk: int = CHUNK_ELEMS) -> Array:
    """Inclusive prefix sum with compile cost bounded by ``chunk``.

    Plain ``jnp.cumsum`` / ``associative_scan`` lowering is the component
    whose compile time grew superlinearly in ``n`` (module docstring).
    Chunked form: reshape
    to ``(k, c)``, one batched scan of length ``c``, then a tiny
    ``k``-length exclusive scan of chunk totals broadcast back.
    """
    n = x.shape[0]
    k = chunk_count(n, chunk)
    if k == 1:
        return jnp.cumsum(x)
    c = -(-n // k)
    xp = _pad_to([x], k * c, [0])[0].reshape(k, c)
    rows = jnp.cumsum(xp, axis=1)
    offs = jnp.concatenate([jnp.zeros((1,), rows.dtype),
                            jnp.cumsum(rows[:-1, -1])])
    return (rows + offs[:, None]).reshape(-1)[:n]


def chunked_segmented_cumsum(x: Array, is_start, *,
                             chunk: int = SCAN_CHUNK_ELEMS) -> Array:
    """Inclusive segmented prefix sum (restart at ``is_start``), chunked
    like :func:`chunked_cumsum`. Cross-chunk carry: a chunk's leading run
    (positions before its first start flag) continues the previous
    chunk's final running sum; positions at/after a start flag are
    already correct from the per-chunk scan."""
    n = x.shape[0]
    k = chunk_count(n, chunk)
    if k == 1:
        return _seg_scan(x, is_start)
    c = -(-n // k)
    xp = _pad_to([x], k * c, [0])[0].reshape(k, c)
    # padding must START a segment so padded tails never leak into the
    # next chunk's carry
    sp = _pad_to([is_start], k * c, [True])[0].reshape(k, c)
    # lax.map, NOT a batched scan: a batched associative_scan's compile
    # time blows up with the batch dim on this rig (a (8, 1M) segmented
    # scan did not finish compiling in 10 min while plain 8M cumsum
    # takes 1.4 s); map compiles the length-c body ONCE
    rows = jax.lax.map(lambda ab: _seg_scan(ab[0], ab[1]), (xp, sp))
    seen = jnp.cumsum(sp.astype(jnp.int32), axis=1)
    lead = seen == 0                    # before the chunk's first start
    # carry[i] = running sum at the end of chunk i-1's final run,
    # accumulated across chunks that have no start at all
    tail = rows[:, -1]
    has_start = seen[:, -1] > 0

    def step(carry, inp):
        t, h = inp
        new = jnp.where(h, t, carry + t)
        return new, carry

    _, carries = jax.lax.scan(step, jnp.zeros((), x.dtype),
                              (tail, has_start))
    return (rows + jnp.where(lead, carries[:, None],
                             jnp.zeros((), x.dtype))).reshape(-1)[:n]


def _fill_scan(marker, payloads):
    """Carry-last-marked associative scan along the LAST axis."""
    def op(a, b):
        m_a, pa = a[0], a[1:]
        m_b, pb = b[0], b[1:]
        out = tuple(jnp.where(m_b, y, x) for x, y in zip(pa, pb))
        return (m_a | m_b,) + out

    return jax.lax.associative_scan(op, (marker,) + tuple(payloads),
                                    axis=-1)


def chunked_forward_fill(marker, payloads: Sequence[Array], *,
                         chunk: int = SCAN_CHUNK_ELEMS):
    """Compile-bounded forward fill (:func:`..joinfill.forward_fill_marked`
    semantics): per-chunk carry-last-marked scans plus a tiny cross-chunk
    carry scan. Positions before the first marked one receive position
    0's payload, exactly like the direct scan."""
    n = marker.shape[0]
    k = chunk_count(n, chunk)
    if k == 1:
        return _fill_scan(marker, tuple(payloads))[1:]
    c = -(-n // k)
    mp = _pad_to([marker], k * c, [False])[0].reshape(k, c)
    pp = [_pad_to([p], k * c, [0])[0].reshape(k, c) for p in payloads]
    # lax.map for the same batched-scan compile blowup reason as
    # chunked_segmented_cumsum
    res = jax.lax.map(
        lambda args: _fill_scan(args[0], tuple(args[1:])),
        (mp,) + tuple(pp))
    filled = res[1:]
    has = mp.any(axis=1)
    tails = tuple(f[:, -1] for f in filled)

    def step(carry, inp):
        h = inp[0]
        t = inp[1:]
        new = tuple(jnp.where(h, ti, ci) for ci, ti in zip(carry, t))
        return new, carry

    # seed = position 0's payload: an unmarked chunk-0 lead region keeps
    # its own scan value, which equals this seed — no special case
    init = tuple(p[0, 0] for p in pp)
    _, carries = jax.lax.scan(step, init, (has,) + tails)
    lead = jnp.cumsum(mp.astype(jnp.int32), axis=1) == 0
    outs = tuple(
        jnp.where(lead, cr[:, None], f).reshape(-1)[:n]
        for cr, f in zip(carries, filled))
    return outs


def _regular_splitters(ws, k: int, s: int):
    """``k - 1`` splitters by regular sampling of the sorted chunk rows
    ``ws (k, c)``: take ``s`` evenly-spaced samples per chunk, sort the
    ``k*s`` samples (tiny), take every ``s``-th. Classic PSRS guarantee
    (keys unique): no bucket receives more than ``n/k + n/s`` elements."""
    c = ws.shape[1]
    pos = (jnp.arange(s, dtype=jnp.int32) * c) // s
    samples = ws[:, pos].reshape(-1)
    samples = jax.lax.sort(samples)
    cut = (jnp.arange(1, k, dtype=jnp.int32) * s)
    return samples[cut]


def chunked_sort_unique(word: Array, payloads: Sequence[Array] = (), *,
                        chunk: int = CHUNK_ELEMS, sentinel=None):
    """Sort a stream by a single totally-ordered, DUPLICATE-FREE word
    (callers pack position bits into the key — uniqueness is what makes
    splitter routing exact and stability free), with every ``lax.sort``
    instance bounded by ~``chunk`` elements.

    ``sentinel`` (default: the word dtype's max) must compare >= every
    live word; padding introduced here uses it. Returns
    ``(sorted_word, sorted_payloads)`` of the original length.

    PSRS: batched chunk sort -> regular-sampling splitters -> per-chunk
    contiguous ranges routed to buckets by two ``searchsorted`` probes ->
    bucket assembly and final concatenation via forward
    ``dynamic_update_slice`` sweeps -> batched bucket sort. Bucket
    capacity ``n/k + n/s + k`` is the deterministic PSRS bound for unique
    keys, not a heuristic — no overflow path is needed.
    """
    n = word.shape[0]
    k = chunk_count(n, chunk)
    if k == 1:
        out = jax.lax.sort((word,) + tuple(payloads), num_keys=1,
                           is_stable=False)
        return out[0], tuple(out[1:])
    if sentinel is None:
        sentinel = jnp.iinfo(word.dtype).max
    c = -(-n // k)
    total = k * c
    ops = _pad_to([word] + list(payloads), total,
                  [sentinel] + [0] * len(payloads))
    rows = jax.lax.sort(tuple(o.reshape(k, c) for o in ops),
                        dimension=1, num_keys=1, is_stable=False)
    ws, prows = rows[0], rows[1:]

    s = 4 * k                       # oversampling factor
    splitters = _regular_splitters(ws, k, s)
    # per chunk i, bucket b occupies [lo[i,b], lo[i,b+1]) of the sorted
    # row; side='left' routes any key equal to a splitter into the
    # higher bucket for EVERY chunk (keys are unique anyway).
    lo = jax.vmap(lambda row: jnp.searchsorted(
        row, splitters, side="left").astype(jnp.int32))(ws)  # (k, k-1)
    zeros = jnp.zeros((k, 1), jnp.int32)
    limit = jnp.full((k, 1), c, jnp.int32)
    lo = jnp.concatenate([zeros, lo, limit], axis=1)         # (k, k+1)
    piece_len = lo[:, 1:] - lo[:, :-1]                       # (k, k)
    bucket_len = jnp.sum(piece_len, axis=0).astype(jnp.int32)  # (k,)

    # PSRS bound for unique keys: bucket <= n/k + n/s (+k slack); the
    # internal rounding pad (< c duplicate max-sentinels) can inflate the
    # LAST bucket past that bound, and each piece write is c long — both
    # covered by the extra chunk of headroom (DUS clamping would
    # otherwise corrupt real data; see _stitch_prefixes).
    bcap = c + total // s + k
    buf_len = bcap + 2 * c
    pcs = piece_len.T                                        # (k_b, k_i)
    poffs = jnp.concatenate(
        [jnp.zeros((k, 1), jnp.int32),
         jnp.cumsum(pcs, axis=1).astype(jnp.int32)], axis=1)  # (k_b, k_i+1)

    def assemble(ops_rows, fillv):
        # Pad rows to 2c so the static size-c piece slice never clamps
        # (lax.dynamic_slice shifts the start to fit — a full-length
        # slice from lo>0 would silently re-read the row head).
        ops_rows = jnp.concatenate(
            [ops_rows, jnp.full((k, c), fillv, ops_rows.dtype)], axis=1)

        # bucket buffers (k, buf_len); piece (i -> b) written at its
        # bucket offset; forward sweep overwrites overrun tails.
        # Unrolled k x k (static, small): While-loop iterations carry a
        # large fixed cost on this rig.
        bufs = jnp.full((k, buf_len), fillv, ops_rows.dtype)
        if k <= 16:
            for i in range(k):
                for b in range(k):
                    piece = jax.lax.dynamic_slice(
                        ops_rows[i], (lo[i, b],), (c,))
                    bufs = jax.lax.dynamic_update_slice(
                        bufs, piece[None, :],
                        (jnp.asarray(b, jnp.int32), poffs[b, i]))
        else:
            def body(i, bufs):
                def inner(b, bufs):
                    piece = jax.lax.dynamic_slice(
                        ops_rows[i], (lo[i, b],), (c,))
                    return jax.lax.dynamic_update_slice(
                        bufs, piece[None, :],
                        (jnp.asarray(b, jnp.int32), poffs[b, i]))
                return jax.lax.fori_loop(0, k, inner, bufs)

            bufs = jax.lax.fori_loop(0, k, body, bufs)
        # mask the final tail of each bucket (garbage from the last
        # overrunning piece write)
        live = (jax.lax.broadcasted_iota(jnp.int32, (k, buf_len), 1)
                < bucket_len[:, None])
        return jnp.where(live, bufs, jnp.asarray(fillv, ops_rows.dtype))

    wbuf = assemble(ws, sentinel)
    pbufs = [assemble(p, 0) for p in prows]
    srt = jax.lax.sort((wbuf,) + tuple(pbufs), dimension=1, num_keys=1,
                       is_stable=False)
    outs, _ = _stitch_prefixes(list(srt), bucket_len, n,
                               [sentinel] + [0] * len(pbufs))
    return outs[0], tuple(outs[1:])
