"""Row/column structure over sorted COO arrays: dim_beginnings + CSR views.

Array-native re-design of the reference's row-offset machinery
(/root/reference/slib/spsparse/algorithm.hpp:59-233):

* :func:`dim_beginnings` — on a sorted array, the offset of each new value of
  the leading sorted dimension, plus an end sentinel — i.e. compressed row
  pointers over *present rows only* (reference ``algorithm.hpp:74-118``, with
  the unsorted-input error at ``:82-84``). Where the reference walks entries
  sequentially, this computes boundary masks + prefix sums in one pass.
* :class:`DimBeginnings` — the pytree holding (present row ids, start
  offsets, count); its pairing of (row-id, row-slice) replaces the
  reference's ``DimBeginningsXiter`` (``algorithm.hpp:173-233``).
* :class:`SparseCSR` — the full fixed-row-count CSR view (``row_ptr`` of
  length ``nrows+1`` via ``searchsorted``). COO + row pointers *is* the CSR
  format in this framework (SURVEY §2). The reference has no explicit CSR
  type; this is the vectorized access path for SpMV/SpMM kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .coo import SparseCOO
from .errors import SpSparseError, spsparse_error

__all__ = ["dim_beginnings", "DimBeginnings", "SparseCSR", "to_csr",
           "to_csc",
           "to_ell", "SparseELL"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DimBeginnings:
    """Present-rows row-pointer structure of a sorted :class:`SparseCOO`.

    ``begins[r]`` is the entry offset where present row ``r`` starts, for
    ``r < n_rows``; ``begins[n_rows]`` is the end sentinel (== nnz),
    mirroring the reference's sentinel push (``algorithm.hpp:96-98``).
    ``row_index[r]`` is the actual index value of present row ``r`` along
    the leading sorted dimension.
    """

    begins: Array = dataclasses.field(metadata=dict(static=False))     # (cap+1,)
    row_index: Array = dataclasses.field(metadata=dict(static=False))  # (cap,)
    n_rows: Array = dataclasses.field(metadata=dict(static=False))     # scalar
    dim: int = dataclasses.field(metadata=dict(static=True))

    def to_list(self) -> list[int]:
        """Concrete ``[begin_0, ..., begin_{n-1}, end]`` — the exact vector
        the reference's ``dim_beginnings()`` returns (eager only)."""
        n = int(self.n_rows)
        return np.asarray(self.begins)[: n + 1].tolist()

    def rows_to_list(self) -> list[int]:
        n = int(self.n_rows)
        return np.asarray(self.row_index)[:n].tolist()


def dim_beginnings(a: SparseCOO) -> DimBeginnings:
    """Compute present-rows row pointers of a sorted array.

    Reference semantics (``algorithm.hpp:74-118``): requires the array to be
    sorted (raises through the error handler otherwise); returns one offset
    per distinct value of the leading sorted dimension plus an end sentinel.
    """
    if a.sort_order is None:
        spsparse_error(
            -1, "dim_beginnings() requires the SparseCOO to be sorted first.")
    dim = a.sort_order[0]
    cap = a.cap
    lead = a.indices[:, dim]
    valid = a.valid_mask()
    pos = jnp.arange(cap, dtype=jnp.int32)

    is_new = valid & ((pos == 0) | (lead != jnp.roll(lead, 1)))
    row_id = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    n_rows = jnp.sum(is_new).astype(jnp.int32)

    drop = jnp.asarray(cap + 1, jnp.int32)
    tgt = jnp.where(is_new, row_id, drop)
    begins = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(
        pos, mode="drop")
    begins = begins.at[n_rows].set(a.nnz.astype(jnp.int32))
    row_index = jnp.zeros((cap,), lead.dtype).at[
        jnp.where(is_new, row_id, jnp.asarray(cap, jnp.int32))
    ].set(lead, mode="drop")
    return DimBeginnings(begins=begins, row_index=row_index, n_rows=n_rows,
                         dim=dim)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseCSR:
    """Fixed-row-count CSR view: ``row_ptr (nrows+1,)``, ``cols (cap,)``,
    ``vals (cap,)``. Padding entries have ``cols == ncols`` (sentinel) and
    zero values. This is the kernel-facing layout for SpMV/SpMM."""

    row_ptr: Array = dataclasses.field(metadata=dict(static=False))
    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    nnz: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def cap(self) -> int:
        return self.cols.shape[0]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_ids(self) -> Array:
        """Expand ``row_ptr`` back to a per-entry row-id vector (cap,)."""
        # row of entry p = number of row starts <= p, minus 1 (see
        # core.joinfill for the two phrasings).
        from .joinfill import row_ids_from_row_ptr
        return row_ids_from_row_ptr(self.row_ptr, self.cap)

    def to_coo(self, sort_order=(0, 1)) -> SparseCOO:
        # Index dtype follows the extents (unconditional int32 would wrap
        # column indices of >= 2^31 extents).
        from .coo import default_index_dtype
        idt = jnp.dtype(default_index_dtype(self.shape))
        rows = jnp.where(self.valid_mask(),
                         self.row_ids().astype(idt),
                         jnp.asarray(self.nrows, idt))
        idx = jnp.stack([rows, self.cols.astype(idt)], axis=1)
        return SparseCOO(indices=idx, vals=self.vals, nnz=self.nnz,
                         shape=self.shape, sort_order=tuple(sort_order))

    def valid_mask(self) -> Array:
        return jnp.arange(self.cap, dtype=jnp.int32) < self.nnz

    def to_dense(self) -> Array:
        return self.to_coo().to_dense()


def to_csr(a: SparseCOO, *, transpose: bool = False) -> SparseCSR:
    """Convert a COO matrix to the CSR view (consolidating row-major first
    if needed). With ``transpose=True`` builds CSR of ``a.T`` (i.e. CSC of
    ``a``) — the reference's free-transposition-via-sort-order trick
    (``multiply_sparse.hpp:167-168``)."""
    if a.rank != 2:
        raise SpSparseError("to_csr requires a rank-2 array")
    aw = a.transposed((1, 0)) if transpose else a
    if aw.sort_order != (0, 1):
        aw = aw.consolidate((0, 1))
    rows = jnp.where(aw.valid_mask(), aw.indices[:, 0],
                     jnp.asarray(aw.shape[0], aw.indices.dtype))
    nrows = aw.shape[0]
    from .joinfill import row_ptr_from_sorted_rows
    row_ptr = row_ptr_from_sorted_rows(rows, nrows)
    cols = jnp.where(aw.valid_mask(), aw.indices[:, 1],
                     jnp.asarray(aw.shape[1], aw.indices.dtype))
    return SparseCSR(row_ptr=row_ptr, cols=cols, vals=aw.repad().vals,
                     nnz=aw.nnz, shape=aw.shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseELL:
    """ELLPACK view: every row padded to ``max_row_nnz`` entries.

    ``cols (nrows, max_row_nnz)`` int32 with sentinel ``ncols`` padding and
    ``vals (nrows, max_row_nnz)`` with zero padding. This regular layout is
    the most vectorizable SpMV format: the gather + row-reduction run with
    no data-dependent control flow.
    """

    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def max_row_nnz(self) -> int:
        return self.cols.shape[1]

    def to_dense(self) -> Array:
        dense = jnp.zeros(self.shape, self.vals.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.nrows, dtype=jnp.int32)[:, None], self.cols.shape)
        return dense.at[rows, self.cols].add(self.vals, mode="drop")

    def to_coo(self) -> "SparseCOO":
        """ELL -> COO (drops padding slots; keeps explicit zeros that
        occupy real slots out — only sentinel-padded slots are removed)."""
        rows = jnp.broadcast_to(
            jnp.arange(self.nrows, dtype=jnp.int32)[:, None],
            self.cols.shape).reshape(-1)
        cols = self.cols.reshape(-1).astype(jnp.int32)
        vals = self.vals.reshape(-1)
        live = cols < self.ncols
        import numpy as _np
        keep = _np.asarray(live)
        idx = _np.stack([_np.asarray(rows)[keep], _np.asarray(cols)[keep]], 1)
        return SparseCOO.from_arrays(idx, _np.asarray(vals)[keep],
                                     self.shape, check=False)


def to_csc(a: SparseCOO) -> SparseCSR:
    """CSC view of ``a`` as the CSR of ``a.T`` (scipy users' spelling of
    ``to_csr(a, transpose=True)`` — the reference's free transposition
    via sort order, ``multiply_sparse.hpp:167-168``). ``spmv(to_csc(a),
    u)`` computes ``a.T @ u``."""
    return to_csr(a, transpose=True)


def to_ell(a: SparseCOO | SparseCSR, max_row_nnz: int | None = None) -> SparseELL:
    """COO/CSR → ELL. ``max_row_nnz`` must be static under jit; eagerly it
    defaults to the true max row length. Rows longer than ``max_row_nnz``
    are truncated (callers must size correctly; see ``csr_row_lengths``)."""
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    lengths = csr.row_ptr[1:] - csr.row_ptr[:-1]
    if max_row_nnz is None:
        max_row_nnz = int(jnp.max(lengths)) if csr.nrows else 0
        max_row_nnz = max(max_row_nnz, 1)
    k = jnp.arange(max_row_nnz, dtype=jnp.int32)[None, :]
    src = csr.row_ptr[:-1, None] + k                      # (nrows, K)
    in_row = k < lengths[:, None]
    src = jnp.where(in_row, src, csr.cap)                  # cap = sentinel slot
    cols = jnp.where(in_row,
                     jnp.take(csr.cols, src.reshape(-1), mode="fill",
                              fill_value=csr.ncols).reshape(src.shape),
                     jnp.asarray(csr.ncols, csr.cols.dtype))
    vals = jnp.where(in_row,
                     jnp.take(csr.vals, src.reshape(-1), mode="fill",
                              fill_value=0).reshape(src.shape),
                     jnp.zeros((), csr.vals.dtype))
    return SparseELL(cols=cols, vals=vals, shape=csr.shape)
