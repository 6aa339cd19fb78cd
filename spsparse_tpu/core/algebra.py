"""Elementwise sparse algebra: concatenation, linear combination, scaling.

The reference composes these from its accumulator protocol — streaming two
arrays into one output via ``copy()`` then consolidating merges them
(``algorithm.hpp:30-37`` + ``algorithm.hpp:251-319``). Here the same
composition is a first-class, jit-compatible op: concatenate the padded
buffers, compact live entries to the front with one stable single-key sort
(no scatters — see :func:`.consolidate.compact_select`), and consolidate
under the caller's duplicate policy. ``ADD`` yields sparse matrix addition
``alpha*A + beta*B``; ``LEAVE_ALONE``/``REPLACE`` give first/last-operand-
wins overlay semantics (insertion order = all of ``a``, then all of ``b``,
exactly like two successive reference ``copy()`` calls).

All capacities are static (derived from operand caps, not live counts), so
these work identically under ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from .consolidate import (_pack_cols, _plan_packing, _unpack_cols,
                          compact_select, consolidate)
from .coo import SparseCOO, round_up_pow2
from .errors import DuplicatePolicy, SpSparseError

Array = Any

__all__ = ["coo_concat", "coo_add", "coo_scale",
           "coo_hstack", "coo_vstack", "coo_block_diag",
           "coo_binop", "coo_multiply", "coo_maximum", "coo_minimum",
           "coo_power"]


def coo_concat(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """Concatenate the live entries of sparse arrays of identical shape
    into one (unsorted) COO; duplicates are preserved, entry order is
    operand order (so a later consolidate's first/last policies see the
    reference's insertion-order semantics). ``cap`` defaults to the sum of
    operand caps rounded up to a power of two (static). An explicit
    ``cap`` smaller than the total live count raises when the counts are
    concrete; under ``jit`` (traced counts) it cannot be checked and
    would corrupt the output — pass the default there."""
    if not arrays:
        raise SpSparseError("coo_concat requires at least one operand")
    shape = arrays[0].shape
    for x in arrays[1:]:
        if x.shape != shape:
            raise SpSparseError(
                f"coo_concat shape mismatch: {x.shape} vs {shape}")
    if cap is None:
        cap = round_up_pow2(sum(x.cap for x in arrays))
    else:
        cap = int(cap)
        total = 0
        for x in arrays:
            try:
                total += int(x.nnz)
            except Exception:            # traced under jit: not checkable
                total = None
                break
        if total is not None and cap < total:
            raise SpSparseError(
                f"coo_concat cap={cap} < total live entries {total}")
    idt = arrays[0].index_dtype
    vdt = arrays[0].dtype
    for x in arrays[1:]:
        idt = jnp.promote_types(idt, x.index_dtype)
        vdt = jnp.promote_types(vdt, x.dtype)
    rank = arrays[0].rank  # ranks are equal: shape equality covers length
    cols = [jnp.concatenate([x.indices[:, d].astype(idt) for x in arrays])
            for d in range(rank)]
    vals = jnp.concatenate([x.vals.astype(vdt) for x in arrays], axis=0)
    valid = jnp.concatenate([x.valid_mask() for x in arrays], axis=0)
    carried, n = compact_select(valid, tuple(cols) + (vals,), cap_out=cap)
    # Under jit an undersized explicit cap is unverifiable; clamping keeps
    # the nnz <= cap container invariant (entries past cap are dropped in
    # operand order — documented above).
    n = jnp.minimum(n, jnp.asarray(cap, n.dtype))
    live = jnp.arange(cap, dtype=jnp.int32) < n
    idx_c = jnp.stack([jnp.where(live, c, jnp.asarray(s, idt))
                       for c, s in zip(carried[:rank], shape)], axis=1)
    vals_c = jnp.where(live, carried[rank], 0)
    return SparseCOO(indices=idx_c, vals=vals_c, nnz=n, shape=shape,
                     sort_order=None)


def coo_add(a: SparseCOO, b: SparseCOO, *, alpha=1.0, beta=1.0,
            duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
            zero_nan: bool = False, cap: int | None = None) -> SparseCOO:
    """``alpha*A + beta*B`` (under ``ADD``), sorted row-major.

    With ``LEAVE_ALONE`` the result is "B's entries only where A has
    none" (A wins); with ``REPLACE``, B overlays A. Consolidate semantics
    apply: structural zeros in the inputs are dropped up front, but merged
    sums that cancel to exactly zero are *kept* (reference
    ``algorithm.hpp:287`` — re-consolidate to drop them). ``cap`` bounds
    the output (default: ``a.cap + b.cap``, static)."""
    av = coo_scale(a, alpha)
    bv = coo_scale(b, beta)
    both = coo_concat(av, bv, cap=cap)
    return consolidate(both, None, duplicate_policy, zero_nan)


def coo_binop(a: SparseCOO, b: SparseCOO, f: Callable[[Array, Array], Array],
              *, require_both: bool = False, drop_zeros: bool = True,
              cap: int | None = None) -> SparseCOO:
    """Elementwise ``f(A, B)`` over the union of the two structures,
    treating missing entries as 0 — the general sparse-sparse combiner
    underneath :func:`coo_multiply` / :func:`coo_maximum` /
    :func:`coo_minimum`.

    Sort-based formulation (no scatters, no per-key searchsorted probes): each
    operand is consolidated (duplicates summed — scipy's canonicalization
    before ``_binopt``), the two entry streams are concatenated with an
    operand tag and stable-sorted by (packed index word(s), tag); each
    run then holds at most one entry per operand with ``a``'s first, so
    per-key operand values are a neighbour read away. ``f`` is evaluated
    once per distinct key and results are compacted to the front with
    one stable sort (:func:`.consolidate.compact_select`).

    ``require_both`` restricts the output to the structural intersection
    (both operands store the key) — this is what makes ``coo_multiply``
    match scipy, where ``A.multiply(B)`` never evaluates ``NaN * 0``
    against an implicit zero. ``drop_zeros`` applies the reference's
    ``isnone`` convention (``spsparse.hpp:95-103``) to computed results:
    exact-zero outputs are not stored (NaNs are — they compare ``!= 0``).

    Fully jit-compatible: ``cap`` (default: operand-cap sum, or the
    smaller operand's cap when ``require_both``) is static. The result is
    row-major sorted with unique keys.
    """
    if a.shape != b.shape:
        raise SpSparseError(
            f"coo_binop shape mismatch: {a.shape} vs {b.shape}")
    ca = consolidate(a, None, DuplicatePolicy.ADD, False)
    cb = consolidate(b, None, DuplicatePolicy.ADD, False)
    rank = ca.rank
    shape = ca.shape
    idt = jnp.promote_types(ca.index_dtype, cb.index_dtype)
    vdt = jnp.promote_types(ca.dtype, cb.dtype)
    if cap is None:
        cap = round_up_pow2(min(ca.cap, cb.cap) if require_both
                            else ca.cap + cb.cap)
    else:
        cap = int(cap)
    exts = [int(s) + 1 for s in shape]
    limit = 2 ** 62 if idt == jnp.int64 else 2 ** 31
    plan = _plan_packing(exts, limit)

    def pack(x):
        cols = [x.indices[:, d].astype(idt) for d in range(rank)]
        return _pack_cols(cols, exts, plan, idt)

    wa, wb = pack(ca), pack(cb)
    words = [jnp.concatenate([x, y]) for x, y in zip(wa, wb)]
    tag = jnp.concatenate([jnp.zeros(ca.cap, jnp.int32),
                           jnp.ones(cb.cap, jnp.int32)])
    vals = jnp.concatenate([ca.vals.astype(vdt), cb.vals.astype(vdt)])
    live = jnp.concatenate([ca.valid_mask(), cb.valid_mask()]
                           ).astype(jnp.int32)
    nw = len(words)
    srt = jax.lax.sort(tuple(words) + (tag, vals, live),
                       num_keys=nw + 1, is_stable=True)
    sw, stag, svals, slive = srt[:nw], srt[nw], srt[nw + 1], srt[nw + 2]
    same_prev = jnp.ones(sw[0].shape[0], bool)
    for w in sw:
        same_prev &= jnp.concatenate(
            [jnp.zeros(1, bool), w[1:] == w[:-1]])
    first = ~same_prev
    next_same = jnp.concatenate([same_prev[1:], jnp.zeros(1, bool)])
    zero = jnp.zeros((), vdt)
    av = jnp.where(stag == 0, svals, zero)
    bv_here = jnp.where(stag == 1, svals, zero)
    bv_next = jnp.concatenate([bv_here[1:], jnp.zeros(1, vdt)])
    live_next = jnp.concatenate([slive[1:], jnp.zeros(1, jnp.int32)])
    partner = next_same & (live_next > 0)
    bv = bv_here + jnp.where(partner, bv_next, zero)
    out = f(av, bv).astype(vdt)
    keep = first & (slive > 0)
    if require_both:
        # run of length 2 = key present in both operands (each operand
        # stream has unique keys post-consolidate)
        keep &= partner
    if drop_zeros:
        keep &= out != 0
    comp, n = compact_select(keep, tuple(sw) + (out,), cap_out=cap)
    n = jnp.minimum(n, jnp.asarray(cap, n.dtype)).astype(jnp.int32)
    cols = _unpack_cols(comp[:nw], exts, plan, idt)
    live_out = jnp.arange(cap, dtype=jnp.int32) < n
    sent = SparseCOO.sentinel_index(shape, idt)
    idx = jnp.stack([jnp.where(live_out, c, sent[d])
                     for d, c in enumerate(cols)], axis=1)
    vals_out = jnp.where(live_out, comp[nw], 0)
    return SparseCOO(indices=idx, vals=vals_out, nnz=n, shape=shape,
                     sort_order=tuple(range(rank)))


def coo_multiply(a: SparseCOO, b: SparseCOO, *,
                 cap: int | None = None) -> SparseCOO:
    """Hadamard (elementwise) product ``A ∘ B`` — scipy's
    ``A.multiply(B)`` for same-shape sparse operands. Structural
    intersection; duplicates in either operand are summed first; exact
    zero products are dropped (reference ``isnone`` convention — scipy
    may keep stored zeros; values agree everywhere)."""
    return coo_binop(a, b, jnp.multiply, require_both=True, cap=cap)


def coo_maximum(a: SparseCOO, b: SparseCOO, *,
                cap: int | None = None) -> SparseCOO:
    """Elementwise ``max(A, B)`` over the dense interpretation
    (scipy ``A.maximum(B)``): missing entries count as 0, so a negative
    entry opposite an implicit zero yields 0 (dropped)."""
    return coo_binop(a, b, jnp.maximum, cap=cap)


def coo_minimum(a: SparseCOO, b: SparseCOO, *,
                cap: int | None = None) -> SparseCOO:
    """Elementwise ``min(A, B)`` (scipy ``A.minimum(B)``); missing
    entries count as 0."""
    return coo_binop(a, b, jnp.minimum, cap=cap)


def coo_power(a: SparseCOO, p) -> SparseCOO:
    """Elementwise power of the *stored* entries (scipy ``A.power(p)``).
    ``p == 0`` is rejected (it would densify — every implicit zero
    becomes 1; scipy raises NotImplementedError too). Negative powers
    follow IEEE on stored values (0 ** -1 = inf) and leave implicit
    zeros implicit, exactly like scipy."""
    if p == 0:
        raise SpSparseError("coo_power: zero power would densify "
                            "(scipy parity: not supported)")
    # padding values are 0: 0**p is 0 for p>0 but inf/nan for p<=0 —
    # re-zero padding explicitly to keep the container invariant
    vals = jnp.where(a.valid_mask(), a.vals ** p, 0)
    return dataclasses.replace(a, vals=vals)


def coo_scale(a: SparseCOO, c) -> SparseCOO:
    """``c * A`` — elementwise value scaling; structure (and sortedness
    metadata) unchanged. Padding stays zero because padding values are
    zero by convention."""
    return dataclasses.replace(a, vals=a.vals * jnp.asarray(c, a.dtype))


def _coo_stack2d(arrays, row_offs, col_offs, out_shape,
                 cap: int | None) -> SparseCOO:
    """Shared core of hstack/vstack/block_diag: shift each operand's live
    indices by its (row, col) offset, concatenate, compact live entries to
    the front (one stable single-key sort; no scatters). Unsorted result,
    operand entry order preserved — exactly the insertion-order contract
    successive reference ``copy()`` calls into one accumulator would give
    (``algorithm.hpp:30-37``)."""
    from .coo import default_index_dtype

    if cap is None:
        cap = round_up_pow2(sum(x.cap for x in arrays))
    else:
        # Same eager guard as coo_concat: an undersized explicit cap with
        # concrete counts must raise, not silently drop trailing entries
        # (under jit, traced counts cannot be checked — pass the default).
        cap = int(cap)
        total = 0
        for x in arrays:
            try:
                total += int(x.nnz)
            except Exception:            # traced under jit: not checkable
                total = None
                break
        if total is not None and cap < total:
            raise SpSparseError(
                f"stacking cap={cap} < total live entries {total}")
    idt = default_index_dtype(out_shape)
    for x in arrays:
        idt = jnp.promote_types(idt, x.index_dtype)
    vdt = arrays[0].dtype
    for x in arrays[1:]:
        vdt = jnp.promote_types(vdt, x.dtype)
    sent = SparseCOO.sentinel_index(out_shape, idt)
    rows, cols, vals, valid = [], [], [], []
    for x, ro, co in zip(arrays, row_offs, col_offs):
        lv = x.valid_mask()
        rows.append(jnp.where(lv, x.indices[:, 0].astype(idt) + ro,
                              sent[0]))
        cols.append(jnp.where(lv, x.indices[:, 1].astype(idt) + co,
                              sent[1]))
        vals.append(x.vals.astype(vdt))
        valid.append(lv)
    carried, n = compact_select(
        jnp.concatenate(valid),
        (jnp.concatenate(rows), jnp.concatenate(cols),
         jnp.concatenate(vals)), cap_out=int(cap))
    out = SparseCOO(indices=jnp.stack(carried[:2], axis=1),
                    vals=carried[2],
                    nnz=jnp.minimum(n, cap).astype(jnp.int32),
                    shape=tuple(int(s) for s in out_shape),
                    sort_order=None)
    return out.repad()


def _check_rank2(arrays, name):
    if not arrays:
        raise SpSparseError(f"{name} requires at least one operand")
    for x in arrays:
        if x.rank != 2:
            raise SpSparseError(f"{name} requires rank-2 arrays, got "
                                f"shape {x.shape}")


def coo_hstack(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``[A B ...]`` — horizontal stacking of rank-2 arrays with equal row
    counts (scipy.sparse.hstack). jit-compatible (static shapes/caps)."""
    _check_rank2(arrays, "coo_hstack")
    nr = arrays[0].shape[0]
    for x in arrays[1:]:
        if x.shape[0] != nr:
            raise SpSparseError(
                f"coo_hstack row mismatch: {x.shape[0]} vs {nr}")
    offs = [0]
    for x in arrays:
        offs.append(offs[-1] + int(x.shape[1]))
    return _coo_stack2d(arrays, [0] * len(arrays), offs[:-1],
                        (nr, offs[-1]), cap)


def coo_vstack(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``[A; B; ...]`` — vertical stacking of rank-2 arrays with equal
    column counts (scipy.sparse.vstack). jit-compatible."""
    _check_rank2(arrays, "coo_vstack")
    nc = arrays[0].shape[1]
    for x in arrays[1:]:
        if x.shape[1] != nc:
            raise SpSparseError(
                f"coo_vstack column mismatch: {x.shape[1]} vs {nc}")
    offs = [0]
    for x in arrays:
        offs.append(offs[-1] + int(x.shape[0]))
    return _coo_stack2d(arrays, offs[:-1], [0] * len(arrays),
                        (offs[-1], nc), cap)


def coo_block_diag(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``diag(A, B, ...)`` — block-diagonal composition of rank-2 arrays
    (scipy.sparse.block_diag); the natural assembly for independent
    subdomain operators ahead of one batched solve. jit-compatible."""
    _check_rank2(arrays, "coo_block_diag")
    ro, co = [0], [0]
    for x in arrays:
        ro.append(ro[-1] + int(x.shape[0]))
        co.append(co[-1] + int(x.shape[1]))
    return _coo_stack2d(arrays, ro[:-1], co[:-1], (ro[-1], co[-1]), cap)
