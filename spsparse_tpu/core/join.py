"""Vectorized sorted-merge joins — the xiter protocol, array style.

The reference's ``Join2Xiter``/``Join3Xiter``
(/root/reference/slib/spsparse/xiter.hpp:146-282 with the shared advance
loop in ``next_noincr_body.hpp:1-54``) advance 2/3 *sorted, non-repeating*
key streams element-by-element to successive common keys — the workhorse of
its sparse dot products. Sequential pointer-chasing is the wrong shape for a
vector machine, so here the same relation is computed with
``searchsorted``-based set intersection: one vectorized probe of stream A's
keys into stream B, a match mask, and a prefix-sum compaction. Results are
identical for sorted unique keys (pinned against the reference's
``tests/test_xiter.cpp`` goldens).

All functions take padded key arrays plus live counts, and return
``JoinResult`` with compacted matched positions — fully static shapes,
jit-compatible.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

__all__ = ["JoinResult", "join2", "join3", "intersect_mask"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Matched positions of a k-way sorted join, compacted to the front.

    ``pos[s][m]`` is the position in input stream ``s`` of the ``m``-th
    common key (for ``m < n_match``); padding positions equal the
    RESPECTIVE stream's buffer length (one past its end), so gathering
    any stream's data with an out-of-bounds fill mode drops them cleanly.
    ``n_match`` is clamped to ``cap``.
    """

    pos: tuple = dataclasses.field(metadata=dict(static=False))
    n_match: Array = dataclasses.field(metadata=dict(static=False))

    @property
    def cap(self) -> int:
        return self.pos[0].shape[0]

    def valid_mask(self) -> Array:
        return jnp.arange(self.cap, dtype=jnp.int32) < self.n_match


def _as_padded(keys, n, sentinel):
    keys = jnp.asarray(keys)
    live = jnp.arange(keys.shape[0], dtype=jnp.int32) < n
    return jnp.where(live, keys, jnp.asarray(sentinel, keys.dtype)), live


def intersect_mask(keys1, n1, keys2, n2, sentinel):
    """For each live position in sorted ``keys1``, whether its key is present
    in sorted ``keys2``, and at which position. Returns ``(match, pos2)``."""
    k1, live1 = _as_padded(keys1, n1, sentinel)
    k2, _ = _as_padded(keys2, n2, sentinel)
    p2 = jnp.searchsorted(k2, k1, side="left").astype(jnp.int32)
    found = jnp.take(k2, p2, mode="fill", fill_value=sentinel) == k1
    match = live1 & (p2 < n2) & found
    return match, p2


def _compact(match, positions, pads, cap):
    """Compact matched positions to the front (stable single-key sort —
    not an XLA scatter; see consolidate.compact_select). ``pads[s]`` is stream ``s``'s buffer
    length, written into padding slots so OOB-gather modes drop them."""
    from .consolidate import compact_select

    carried, n = compact_select(
        match, tuple(p.astype(jnp.int32) for p in positions), cap_out=cap)
    n = jnp.minimum(n, jnp.asarray(cap, n.dtype))
    live = jnp.arange(cap, dtype=jnp.int32) < n
    outs = tuple(jnp.where(live, c, jnp.asarray(pad, jnp.int32))
                 for c, pad in zip(carried, pads))
    return outs, n


def join2(keys1, n1, keys2, n2, *, sentinel, cap: int | None = None) -> JoinResult:
    """2-way sorted-unique-key join (reference ``Join2Xiter``,
    ``xiter.hpp:236-282``). ``sentinel`` must compare greater than any live
    key (use the dimension extent)."""
    l1, l2 = jnp.shape(keys1)[0], jnp.shape(keys2)[0]
    cap = cap if cap is not None else min(l1, l2)
    match, p2 = intersect_mask(keys1, n1, keys2, n2, sentinel)
    p1 = jnp.arange(l1, dtype=jnp.int32)
    pos, n_match = _compact(match, (p1, p2), (l1, l2), cap)
    return JoinResult(pos=pos, n_match=n_match)


def join3(keys1, n1, keys2, n2, keys3, n3, *, sentinel,
          cap: int | None = None) -> JoinResult:
    """3-way sorted-unique-key join (reference ``Join3Xiter``,
    ``xiter.hpp:149-198``): keys present in all three streams."""
    l1, l2, l3 = (jnp.shape(keys1)[0], jnp.shape(keys2)[0],
                  jnp.shape(keys3)[0])
    cap = cap if cap is not None else min(l1, l2, l3)
    m12, p2 = intersect_mask(keys1, n1, keys2, n2, sentinel)
    m13, p3 = intersect_mask(keys1, n1, keys3, n3, sentinel)
    match = m12 & m13
    p1 = jnp.arange(l1, dtype=jnp.int32)
    pos, n_match = _compact(match, (p1, p2, p3), (l1, l2, l3), cap)
    return JoinResult(pos=pos, n_match=n_match)
