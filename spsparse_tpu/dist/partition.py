"""Row partitioning of sparse matrices across a device mesh.

The reference is single-process (SURVEY §2: zero parallelism of any kind);
distribution is a new capability mandated by the north star
(BASELINE.md): matrices row/block-partitioned across devices, with JAX
collectives (NCCL over NVLink on GPUs) moving vector segments /
intermediate rows.

Layout: a :class:`RowPartitionedCSR` stacks ``P`` equal-row-count local CSR
blocks along a leading partition axis — ``row_ptr (P, rows_local+1)``,
``cols (P, cap_local)`` (global column ids), ``vals (P, cap_local)`` — so it
shards over a 1-D mesh axis with ``PartitionSpec('x', ...)`` and each device
sees exactly its local block inside ``shard_map``. Capacity is the max local
nnz, padded with the usual sentinel convention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR, to_csr

__all__ = ["RowPartitionedCSR", "RowPartitionedBucketed", "partition_rows",
           "partition_bucketed", "partition_vector"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowPartitionedCSR:
    """``P`` stacked local CSR blocks of a global ``(nrows, ncols)`` matrix.

    Row ``r`` of the global matrix lives on partition ``r // rows_local``
    as local row ``r % rows_local`` (block row distribution). ``cols`` hold
    *global* column indices; ``nnz (P,)`` counts live entries per block.
    """

    row_ptr: Array = dataclasses.field(metadata=dict(static=False))
    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    nnz: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_parts(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def rows_local(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def cap_local(self) -> int:
        return self.cols.shape[1]

    def local_block(self, p: int) -> SparseCSR:
        """The p-th local block as a plain :class:`SparseCSR` (rows are
        local; columns remain global)."""
        return SparseCSR(row_ptr=self.row_ptr[p], cols=self.cols[p],
                         vals=self.vals[p], nnz=self.nnz[p],
                         shape=(self.rows_local, self.shape[1]))

    def to_dense(self) -> Array:
        blocks = [np.asarray(self.local_block(p).to_dense())
                  for p in range(self.n_parts)]
        return np.concatenate(blocks, axis=0)[: self.shape[0]]


def partition_rows(a: SparseCOO | SparseCSR, n_parts: int,
                   *, cap_local: int | None = None) -> RowPartitionedCSR:
    """Split a matrix into ``n_parts`` equal row blocks (host-side, eager).

    Rows are padded up so ``nrows_padded = rows_local * n_parts``; trailing
    rows are empty. ``cap_local`` defaults to the max block nnz rounded to a
    power of two (shared static capacity across blocks).
    """
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    nrows, ncols = csr.shape
    rows_local = -(-nrows // n_parts)

    row_ptr = np.asarray(csr.row_ptr)
    cols = np.asarray(csr.cols)
    vals = np.asarray(csr.vals)
    nnz_total = int(csr.nnz)

    counts = []
    bounds = []
    for p in range(n_parts):
        r0 = min(p * rows_local, nrows)
        r1 = min((p + 1) * rows_local, nrows)
        s0, s1 = int(row_ptr[r0]), int(row_ptr[r1])
        s1 = min(s1, nnz_total)
        s0 = min(s0, nnz_total)
        bounds.append((r0, r1, s0, s1))
        counts.append(s1 - s0)
    if cap_local is None:
        cap_local = round_up_pow2(max(max(counts), 1))
    elif max(counts) > cap_local:
        raise SpSparseError(
            f"cap_local={cap_local} < max block nnz {max(counts)}")

    P = n_parts
    out_ptr = np.zeros((P, rows_local + 1), np.int32)
    out_cols = np.full((P, cap_local), ncols, np.int32)
    out_vals = np.zeros((P, cap_local), vals.dtype)
    out_nnz = np.zeros((P,), np.int32)
    for p, (r0, r1, s0, s1) in enumerate(bounds):
        n = s1 - s0
        local_ptr = row_ptr[r0:r1 + 1] - row_ptr[r0]
        out_ptr[p, : r1 - r0 + 1] = local_ptr
        out_ptr[p, r1 - r0 + 1:] = local_ptr[-1]
        out_cols[p, :n] = cols[s0:s1]
        out_vals[p, :n] = vals[s0:s1]
        out_nnz[p] = n
    return RowPartitionedCSR(
        row_ptr=jnp.asarray(out_ptr), cols=jnp.asarray(out_cols),
        vals=jnp.asarray(out_vals), nnz=jnp.asarray(out_nnz),
        shape=(nrows, ncols))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowPartitionedBucketed:
    """Row-partitioned matrix with entries additionally bucketed by the
    column block that owns them — the layout the ring-SpMV pipeline wants.

    At ring step ``s`` a device multiplies only bucket ``(me+s) % P``
    against the x-block it currently holds, so total compute per full ring
    is one pass over the local entries instead of P passes over everything
    (the naive layout's cost).

    ``rows/cols/vals (P, Pb, cap_bucket)`` with local row ids, *global*
    column ids, sentinel/zero padding; ``nnz (P, Pb)`` live counts.
    """

    rows: Array = dataclasses.field(metadata=dict(static=False))
    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    nnz: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    rows_local: int = dataclasses.field(metadata=dict(static=True))
    blk_len: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_parts(self) -> int:
        return self.rows.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.rows.shape[1]

    @property
    def cap_bucket(self) -> int:
        return self.rows.shape[2]


def partition_bucketed(a: SparseCOO | SparseCSR, n_parts: int, *,
                       blk_len: int | None = None,
                       cap_bucket: int | None = None) -> RowPartitionedBucketed:
    """Host-side build of the column-bucketed row partition.

    ``blk_len`` is the x-block length each device owns (defaults to the
    block-row vector distribution of :func:`partition_vector`).
    """
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    nrows, ncols = csr.shape
    rows_local = -(-nrows // n_parts)
    if blk_len is None:
        blk_len = -(-ncols // n_parts)
    n_buckets = -(-ncols // blk_len)

    row_ptr = np.asarray(csr.row_ptr)
    cols = np.asarray(csr.cols)
    vals = np.asarray(csr.vals)
    nnz_total = int(csr.nnz)
    rows_of = np.searchsorted(row_ptr, np.arange(nnz_total), side="right") - 1

    part_of = rows_of // rows_local
    bucket_of = cols[:nnz_total] // blk_len
    counts = np.zeros((n_parts, n_buckets), np.int64)
    np.add.at(counts, (part_of, bucket_of), 1)
    if cap_bucket is None:
        cap_bucket = round_up_pow2(max(int(counts.max(initial=1)), 1))
    elif counts.max(initial=0) > cap_bucket:
        raise SpSparseError(
            f"cap_bucket={cap_bucket} < max bucket {counts.max()}")

    out_rows = np.full((n_parts, n_buckets, cap_bucket), rows_local, np.int32)
    out_cols = np.full((n_parts, n_buckets, cap_bucket), ncols, np.int32)
    out_vals = np.zeros((n_parts, n_buckets, cap_bucket), vals.dtype)
    out_nnz = np.zeros((n_parts, n_buckets), np.int32)
    order = np.lexsort((cols[:nnz_total], rows_of, bucket_of, part_of))
    p_s, b_s = part_of[order], bucket_of[order]
    key = p_s * n_buckets + b_s
    first = np.concatenate([[True], key[1:] != key[:-1]])
    group_start_pos = np.nonzero(first)[0]
    group_id = np.cumsum(first) - 1
    slot = np.arange(nnz_total) - group_start_pos[group_id]
    out_rows[p_s, b_s, slot] = (rows_of[order] % rows_local).astype(np.int32)
    out_cols[p_s, b_s, slot] = cols[order]
    out_vals[p_s, b_s, slot] = vals[order]
    np.add.at(out_nnz, (p_s, b_s), 1)
    return RowPartitionedBucketed(
        rows=jnp.asarray(out_rows), cols=jnp.asarray(out_cols),
        vals=jnp.asarray(out_vals), nnz=jnp.asarray(out_nnz),
        shape=(nrows, ncols), rows_local=rows_local, blk_len=blk_len)


def partition_vector(x, n_parts: int) -> Array:
    """Pad and reshape a dense vector to ``(P, len_local)`` for sharding
    along the same block-row distribution as :func:`partition_rows`."""
    x = np.asarray(x)
    n = x.shape[0]
    local = -(-n // n_parts)
    out = np.zeros((n_parts, local), x.dtype)
    out.reshape(-1)[:n] = x
    return jnp.asarray(out)
