"""Output accumulators as functional combinators.

The reference's algorithms emit results through an *accumulator protocol* —
any object with ``.add(indices, val)`` (/root/reference/slib/spsparse/
accum.hpp:12-24) — so one algorithm can write to a COO array, a dense array,
a permuted view, or a running scalar. In a functional JAX framework the same
role is played by pure post-processing transforms over an entry stream
``(indices, vals, valid)``; composing them costs nothing after XLA fusion.

Correspondence:

* ``OverwriteAccum`` (``accum.hpp:43-57``) → plain functional update; the
  in-place trick is unnecessary with immutable arrays.
* ``PermuteAccum`` (``accum.hpp:73-93``) → :func:`permute_output` /
  ``SparseCOO.transposed`` (may also *drop* dimensions, like the reference).
* ``DenseAccum`` (``accum.hpp:110-140``) → :func:`scatter_to_dense` with the
  three duplicate policies. Note the reference's LEAVE_ALONE branch is buggy
  (it overwrites unless the current dense value is NaN, ``accum.hpp:129-130``);
  this implements the documented first-write-wins semantics.
* ``ScalarAccumulator`` (``accum.hpp:158-167``) → :func:`scalar_sum`.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from .coo import SparseCOO
from .consolidate import merge_sorted_entries, _sort_operands
from .errors import DuplicatePolicy

__all__ = ["scatter_to_dense", "scalar_sum", "permute_output", "project_output"]


def scatter_to_dense(a: SparseCOO, out=None,
                     duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD):
    """Scatter live entries into a dense array honoring the duplicate policy.

    ``out`` defaults to zeros of ``a.shape``. ADD sums duplicates;
    LEAVE_ALONE keeps the first entry (stream order); REPLACE keeps the last.
    First/last are made deterministic by a stable sort on the index tuple —
    XLA scatter alone does not define an application order for duplicate
    indices.
    """
    if out is None:
        out = jnp.zeros(a.shape, a.vals.dtype)
    a = a.repad()
    coords = tuple(a.indices[:, k] for k in range(a.rank))
    if duplicate_policy == DuplicatePolicy.ADD:
        return out.at[coords].add(a.vals, mode="drop")
    # Deterministic first/last: merge duplicates first, then scatter-set.
    cols, svals, slive, _ = _sort_operands(a, tuple(range(a.rank)))
    merged = merge_sorted_entries(
        cols, svals, slive, shape=a.shape,
        duplicate_policy=duplicate_policy, cap=a.cap,
        sort_order=tuple(range(a.rank)), index_dtype=a.index_dtype)
    coords = tuple(merged.indices[:, k] for k in range(merged.rank))
    live = merged.valid_mask()
    # For unique indices, set is well-defined; mask padding via drop mode.
    return out.at[coords].set(
        jnp.where(live, merged.vals,
                  out.at[coords].get(mode="fill", fill_value=0)),
        mode="drop")


def scalar_sum(a: SparseCOO):
    """Sum of all live values, ignoring indices (reference
    ``ScalarAccumulator``, ``accum.hpp:158-167``)."""
    return jnp.sum(jnp.where(a.valid_mask(), a.vals, 0))


def permute_output(a: SparseCOO, perm: Sequence[int]) -> SparseCOO:
    """Permute dimensions of an output stream (reference ``PermuteAccum``
    with ``out_rank == in_rank``, ``accum.hpp:73-93``)."""
    return a.transposed(perm)


def project_output(a: SparseCOO, keep_dims: Sequence[int],
                   shape: Sequence[int] | None = None) -> SparseCOO:
    """Drop dimensions (reference ``PermuteAccum`` with smaller out-rank):
    keeps the listed dims, in the listed order. Duplicates that arise from
    the projection are *not* merged — consolidate afterwards if needed,
    matching the reference where merging is the accumulator's job."""
    keep_dims = tuple(int(d) for d in keep_dims)
    new_shape = tuple(
        a.shape[d] for d in keep_dims) if shape is None else tuple(shape)
    indices = a.indices[:, list(keep_dims)]
    return SparseCOO(indices=indices, vals=a.vals, nnz=a.nnz,
                     shape=new_shape, sort_order=None).repad()
