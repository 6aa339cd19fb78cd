"""``SparseCOO`` — the rank-N sparse array at the heart of spsparse-tpu.

Array-native re-design of the reference's ``VectorCooArray``
(/root/reference/slib/spsparse/VectorCooArray.hpp:8-360). The reference stores
struct-of-arrays ``std::vector``s that grow dynamically; XLA requires static
shapes, so a ``SparseCOO`` is a *padded* buffer:

* ``indices``: ``(cap, rank)`` int32 — index tuples, row ``p`` is live iff
  ``p < nnz``. Padding rows hold the out-of-range sentinel ``shape[d]``
  so that lexicographic sorts naturally push padding to the end.
* ``vals``: ``(cap,)`` — values; padding entries are 0.
* ``nnz``: scalar int32 — live entry count (traced; may be data-dependent).
* ``shape``: static tuple — dense extents (reference ``VectorCooArray.hpp:17``).
* ``sort_order``: static tuple or ``None`` — sortedness metadata (reference
  ``sort_order`` with ``[0]==-1`` meaning unsorted, ``VectorCooArray.hpp:33-34``).

``SparseCOO`` is a registered pytree, so it passes through ``jit`` / ``vmap`` /
``shard_map`` transparently; ``shape``/``sort_order``/``cap`` are static
metadata. All operations are pure functions returning new arrays — the
reference's in-place member algorithms (``consolidate``, ``transpose``) become
functional methods here.

Host-side construction mirrors the reference's edit-mode ``add()`` protocol
(bounds-checked, ``VectorCooArray.hpp:239-266``) via :class:`CooBuilder`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .errors import DuplicatePolicy, SpSparseError, spsparse_error

__all__ = ["SparseCOO", "CooBuilder", "coo_matrix", "coo_vector",
           "default_index_dtype"]

Array = Any


def _canonical_index_dtype() -> jnp.dtype:
    return jnp.dtype(jnp.int32)


def default_index_dtype(shape: Sequence[int]) -> jnp.dtype:
    """int32 unless any extent (or the sentinel ``extent`` itself) overflows
    it — then int64, matching the reference's int64 ``IndexT``/NetCDF schema
    (/root/reference/slib/spsparse/netcdf.hpp:102). int64 indices on device
    require ``jax_enable_x64`` (otherwise JAX silently truncates to int32).
    """
    if shape and max(int(s) for s in shape) >= 2**31:
        return jnp.dtype(jnp.int64)
    return _canonical_index_dtype()


def round_up_pow2(n: int) -> int:
    """Round a capacity up to the next power of two.

    Auto-computed capacities are quantized this way so that repeated eager
    calls with similar-but-different nnz reuse the same compiled XLA
    program instead of recompiling per distinct shape.
    """
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseCOO:
    """Padded struct-of-arrays COO sparse array (see module docstring)."""

    indices: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    nnz: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    sort_order: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def cap(self) -> int:
        """Static padded capacity (number of slots in the buffers)."""
        return self.indices.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def index_dtype(self):
        return self.indices.dtype

    def __len__(self) -> int:
        """Live entry count; requires a concrete (non-traced) ``nnz``."""
        return int(self.nnz)

    @property
    def size(self) -> Array:
        """Live entry count as a (possibly traced) scalar.

        Reference ``VectorCooArray::size()`` (``VectorCooArray.hpp:85-86``).
        """
        return self.nnz

    def valid_mask(self) -> Array:
        """Boolean ``(cap,)`` mask of live entries."""
        return jnp.arange(self.cap, dtype=jnp.int32) < self.nnz

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @staticmethod
    def sentinel_index(shape: Sequence[int], dtype=None) -> np.ndarray:
        """The padding index tuple: one-past-the-end in every dimension."""
        dtype = dtype or default_index_dtype(shape)
        return np.asarray(shape, dtype=dtype)

    @classmethod
    def empty(cls, shape: Sequence[int], cap: int, dtype=jnp.float32,
              index_dtype=None) -> "SparseCOO":
        """An all-padding array with ``nnz == 0`` and the given capacity."""
        shape = tuple(int(s) for s in shape)
        cap = max(int(cap), 1)
        index_dtype = index_dtype or default_index_dtype(shape)
        sent = cls.sentinel_index(shape, index_dtype)
        indices = jnp.broadcast_to(jnp.asarray(sent), (cap, len(shape)))
        vals = jnp.zeros((cap,), dtype=dtype)
        return cls(indices=indices, vals=vals,
                   nnz=jnp.zeros((), jnp.int32), shape=shape)

    @classmethod
    def from_arrays(
        cls,
        indices,
        vals,
        shape: Sequence[int],
        *,
        nnz=None,
        cap: int | None = None,
        sort_order: tuple | None = None,
        check: bool = True,
    ) -> "SparseCOO":
        """Build from host/device arrays of index tuples and values.

        ``indices`` is ``(n, rank)`` (or ``(n,)`` for rank-1); entries beyond
        ``nnz`` (default: all of ``n``) are ignored and re-padded. When
        ``check`` is true and the inputs are concrete, out-of-bounds indices
        raise through the pluggable error handler, mirroring the reference's
        ``add()`` bounds check (``VectorCooArray.hpp:246-262``).
        """
        shape = tuple(int(s) for s in shape)
        rank = len(shape)
        indices = jnp.asarray(indices)
        if indices.ndim == 1:
            indices = indices[:, None]
        if indices.ndim != 2 or indices.shape[1] != rank:
            raise SpSparseError(
                f"indices must have shape (n, {rank}); got {indices.shape}")
        need = default_index_dtype(shape)
        if indices.dtype not in (jnp.int32, jnp.int64):
            indices = indices.astype(need)
        elif indices.dtype == jnp.int32 and need == jnp.int64:
            indices = indices.astype(jnp.int64)
        vals = jnp.asarray(vals)
        n = indices.shape[0]
        if vals.shape != (n,):
            raise SpSparseError(
                f"vals must have shape ({n},); got {vals.shape}")
        if nnz is None:
            nnz = jnp.asarray(n, jnp.int32)
        else:
            nnz = jnp.asarray(nnz, jnp.int32)

        concrete = not (
            isinstance(indices, jax.core.Tracer)
            or isinstance(vals, jax.core.Tracer)
            or isinstance(nnz, jax.core.Tracer)
        )
        if check and concrete and n:
            nnz_c = int(nnz)
            live = np.asarray(indices)[:nnz_c]
            if live.size and (
                (live < 0).any()
                or (live >= np.asarray(shape, live.dtype)).any()
            ):
                bad = np.argwhere(
                    (live < 0) | (live >= np.asarray(shape, live.dtype))
                )[0, 0]
                spsparse_error(
                    -1,
                    "Sparse index out of bounds: index=%s vs. shape=%s",
                    tuple(np.asarray(indices)[bad].tolist()), shape,
                )

        if cap is None:
            cap = round_up_pow2(n)
        # Invariant: capacity >= 1 so size-0 buffers never reach XLA ops
        # (gather/searchsorted on zero-length axes is an error).
        cap = max(int(cap), 1)
        if n == 0:
            out = cls.empty(shape, cap, dtype=vals.dtype,
                            index_dtype=indices.dtype)
            # An empty array is trivially sorted — keep the caller's
            # metadata so downstream no-op checks (Consolidated, to_csr)
            # don't pay a sort pipeline on nothing.
            if sort_order is not None:
                out = dataclasses.replace(
                    out, sort_order=tuple(int(d) for d in sort_order))
            return out
        out = cls(indices=indices, vals=vals, nnz=nnz, shape=shape,
                  sort_order=tuple(sort_order) if sort_order is not None else None)
        out = out.with_capacity(cap)
        return out.repad()

    @classmethod
    def from_dense(cls, arr, *, cap: int | None = None) -> "SparseCOO":
        """Dense → COO, dropping zeros (reference ``to_sparse``,
        ``algorithm.hpp:433-440``).

        Eager-only when ``cap`` is None (uses the concrete nonzero count);
        pass ``cap`` to use under ``jit`` (via ``jnp.nonzero`` ``size=``).
        """
        arr = jnp.asarray(arr)
        if cap is None:
            np_arr = np.asarray(arr)
            nz = np.nonzero(np_arr)
            idx = np.stack(nz, axis=1).astype(np.int32) if np_arr.ndim else None
            vals = np_arr[nz]
            return cls.from_arrays(idx, vals, np_arr.shape, check=False)
        nz = jnp.nonzero(arr, size=cap, fill_value=tuple(arr.shape))
        idx = jnp.stack(nz, axis=1).astype(default_index_dtype(arr.shape))
        # Clamp: jnp.nonzero(size=cap) truncates the entry list, so an
        # undersized cap must not report nnz > cap (it would mark padding
        # slots live and break the container invariant).
        nnz = jnp.minimum(jnp.sum(arr != 0),
                          jnp.asarray(cap)).astype(jnp.int32)
        vals = jnp.where(jnp.arange(cap) < nnz, arr[nz], 0)
        return cls(indices=idx, vals=vals, nnz=nnz, shape=arr.shape)

    # ------------------------------------------------------------------
    # Padding / capacity management
    # ------------------------------------------------------------------
    def repad(self) -> "SparseCOO":
        """Force padding entries to the canonical sentinel/zero form."""
        mask = self.valid_mask()
        sent = jnp.asarray(self.sentinel_index(self.shape, self.index_dtype))
        indices = jnp.where(mask[:, None], self.indices, sent)
        vals = jnp.where(mask, self.vals, jnp.zeros((), self.vals.dtype))
        return dataclasses.replace(self, indices=indices, vals=vals)

    def with_capacity(self, cap: int) -> "SparseCOO":
        """Grow or shrink the static capacity (padding added/removed at end).

        Shrinking below a concrete ``nnz`` raises; under tracing the caller
        is responsible for ``cap >= nnz``.
        """
        cap = max(int(cap), 1)
        cur = self.cap
        if cap == cur:
            return self
        if cap > cur:
            sent = jnp.asarray(self.sentinel_index(self.shape, self.index_dtype))
            pad_idx = jnp.broadcast_to(sent, (cap - cur, self.rank))
            indices = jnp.concatenate([self.indices, pad_idx], axis=0)
            vals = jnp.concatenate(
                [self.vals, jnp.zeros((cap - cur,), self.vals.dtype)])
            return dataclasses.replace(self, indices=indices, vals=vals)
        if not isinstance(self.nnz, jax.core.Tracer) and cap < int(self.nnz):
            raise SpSparseError(
                f"with_capacity({cap}) would drop live entries (nnz={int(self.nnz)})")
        return dataclasses.replace(
            self, indices=self.indices[:cap], vals=self.vals[:cap])

    def compact(self) -> "SparseCOO":
        """Trim capacity to the concrete ``nnz`` (host-sync; eager only)."""
        return self.with_capacity(int(self.nnz))

    # ------------------------------------------------------------------
    # Element access (host-side convenience, mirrors reference accessors)
    # ------------------------------------------------------------------
    def index(self, dim: int, i: int | None = None):
        """``index(dim, i)`` scalar or ``index(dim)`` full column
        (reference ``VectorCooArray.hpp:45-48``)."""
        col = self.indices[:, dim]
        return col if i is None else col[i]

    def val(self, i: int):
        return self.vals[i]

    def index_tuple(self, i: int) -> tuple:
        return tuple(np.asarray(self.indices[i]).tolist())

    def to_lists(self) -> tuple[list, list]:
        """Host-side ``([(i0,..),...], [v,...])`` of live entries (eager)."""
        n = int(self.nnz)
        idx = np.asarray(self.indices)[:n]
        vals = np.asarray(self.vals)[:n]
        return [tuple(row.tolist()) for row in idx], vals.tolist()

    # ------------------------------------------------------------------
    # Dense conversion
    # ------------------------------------------------------------------
    def to_dense(self) -> Array:
        """COO → dense by scatter-add of live entries.

        Reference ``to_dense`` via ``DenseAccum`` with ADD policy
        (``VectorCooArray.hpp:313-321``). Duplicates sum; padding is inert
        because padded values are 0 and the sentinel index is dropped by
        scatter's out-of-bounds-drop mode.
        """
        dense = jnp.zeros(self.shape, dtype=self.vals.dtype)
        coo = self.repad()
        return dense.at[tuple(coo.indices[:, k] for k in range(self.rank))].add(
            coo.vals, mode="drop")

    # ------------------------------------------------------------------
    # Algorithms (functional forms of the reference's member algos) —
    # implemented in sibling modules to keep layering clean; bound here
    # lazily to avoid import cycles.
    # ------------------------------------------------------------------
    def consolidate(self, sort_order: Sequence[int] | None = None,
                    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                    zero_nan: bool = False, *, cap: int | None = None,
                    force: bool = False) -> "SparseCOO":
        """Sort + merge duplicates + drop structural zeros. Returns a new
        array with ``sort_order`` set. See
        :func:`spsparse_tpu.core.consolidate.consolidate`.

        Like the reference member form (``VectorCooArray.hpp:300-311``), this
        is a no-op if ``sort_order`` already matches (unless ``force``).
        """
        from .consolidate import consolidate as _consolidate
        if sort_order is None:
            sort_order = tuple(range(self.rank))
        sort_order = tuple(sort_order)
        if not force and self.sort_order == sort_order:
            return self if cap is None else self.with_capacity(cap)
        return _consolidate(self, sort_order, duplicate_policy, zero_nan,
                            cap=cap)

    def transposed(self, perm: Sequence[int]) -> "SparseCOO":
        """Permute dimensions: ``ret.dim[i] == self.dim[perm[i]]``.

        Functional version of reference ``transpose`` (``algorithm.hpp:46-57``).
        Unlike the reference's in-place member quirk (which leaves ``shape``
        unpermuted, ``VectorCooArray.hpp:144-148``), the documented semantics
        are implemented: shape is permuted, and sortedness metadata is
        RELABELED (not dropped — the entry order never changes).
        """
        perm = tuple(int(p) for p in perm)
        indices = self.indices[:, list(perm)]
        shape = tuple(self.shape[p] for p in perm)
        # Sortedness survives relabeling: the data order is untouched, so
        # an array sorted by old dims (o0, o1, ...) is sorted by the same
        # columns under their new names, new_k = perm.index(o_k). This is
        # what makes to_csr(transpose=True) on a (1,0)-sorted array free
        # (the reference's sort-order trick, multiply_sparse.hpp:167-168).
        new_order = (tuple(perm.index(d) for d in self.sort_order)
                     if self.sort_order is not None else None)
        return SparseCOO(indices=indices, vals=self.vals, nnz=self.nnz,
                         shape=shape, sort_order=new_order)

    @property
    def T(self) -> "SparseCOO":
        """Rank-2 transpose sugar: ``A.T == A.transposed((1, 0))``."""
        if self.rank != 2:
            raise SpSparseError(".T requires a rank-2 array; use "
                                "transposed(perm)")
        return self.transposed((1, 0))

    def __matmul__(self, other):
        """``A @ B``: sparse-sparse product for another :class:`SparseCOO`
        (eager, auto-planned caps via :func:`spsparse_tpu.ops.spgemm`),
        sparse-dense SpMV/SpMM for an array operand (via the CSR view).
        Operator sugar for interactive use — jitted code should call the
        explicit ops with static capacities."""
        if isinstance(other, SparseCOO):
            from ..ops.spgemm import spgemm

            return spgemm(self, other)
        import jax.numpy as _jnp

        from ..ops.spmm import spmm, spmv
        from .structure import to_csr

        other = _jnp.asarray(other)
        csr = to_csr(self)
        return spmv(csr, other) if other.ndim == 1 else spmm(csr, other)

    def transpose_indices_only(self, perm: Sequence[int]) -> "SparseCOO":
        """Reference-quirk-compatible in-place-style transpose: permutes each
        index tuple but *not* ``shape`` (``VectorCooArray.hpp:144-148``,
        pinned by ``tests/test_array.cpp:108-132``). Sortedness is cleared
        (the reference never calls ``set_sorted`` here either)."""
        perm = tuple(int(p) for p in perm)
        indices = self.indices[:, list(perm)]
        return dataclasses.replace(self, indices=indices, sort_order=None)

    def dim_beginnings(self):
        """Present-rows CSR pointers with end sentinel; requires sorted.

        See :func:`spsparse_tpu.core.structure.dim_beginnings`."""
        from .structure import dim_beginnings as _dim_beginnings
        return _dim_beginnings(self)

    def copy(self) -> "SparseCOO":
        """Value copy (reference ``copy()``, ``algorithm.hpp:30-37``;
        immutable pytrees make this a metadata-level operation)."""
        return dataclasses.replace(self)

    # ------------------------------------------------------------------
    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        try:
            n = int(self.nnz)
            live = f"nnz={n}"
        except Exception:
            live = "nnz=<traced>"
        return (f"SparseCOO(shape={self.shape}, {live}, cap={self.cap}, "
                f"dtype={self.vals.dtype}, sort_order={self.sort_order})")

    def __str__(self) -> str:
        """Pretty printer akin to the reference ostream output
        (``array.hpp:122-135``)."""
        try:
            idx, vals = self.to_lists()
        except Exception:  # traced
            return repr(self)
        entries = ", ".join(f"({','.join(map(str, i))}: {v:g})"
                            for i, v in zip(idx, vals))
        return f"SparseCOO{list(self.shape)}[{entries}]"


# ----------------------------------------------------------------------
# Host-side incremental builder (reference edit-mode add() protocol)
# ----------------------------------------------------------------------
class CooBuilder:
    """Incremental host-side builder mirroring the reference's edit mode.

    Reference: ``VectorCooArray::add`` (``VectorCooArray.hpp:239-266``) with
    per-entry bounds checks raising through the error handler, plus
    ``clear``/``reserve`` (``VectorCooArray.hpp:222-235``).

    Entries accumulate in amortized-O(1) numpy buffers with vectorized
    bulk bounds checks; ``build()`` produces an immutable device
    :class:`SparseCOO`. (Host-side *consolidation* has a C++ fast path —
    ``spsparse_tpu.native.consolidate_host`` — but ingest itself is
    numpy-vectorized and needs none.)
    """

    def __init__(self, shape: Sequence[int], dtype=jnp.float32,
                 index_dtype=None):
        index_dtype = index_dtype or np.dtype(default_index_dtype(shape))
        self.shape = tuple(int(s) for s in shape)
        self.rank = len(self.shape)
        self._cap = 16
        self._n = 0
        self._idx = np.empty((self._cap, self.rank), dtype=index_dtype)
        self._vals = np.empty((self._cap,), dtype=np.dtype(dtype))
        self.dtype = dtype

    def __len__(self) -> int:
        return self._n

    def reserve(self, n: int) -> None:
        if n > self._cap:
            self._idx = np.resize(self._idx, (n, self.rank))
            self._vals = np.resize(self._vals, (n,))
            self._cap = n

    def clear(self) -> None:
        self._n = 0

    def add(self, index: Sequence[int], val) -> None:
        """Append one entry, bounds-checked like the reference."""
        index = np.asarray(index, dtype=self._idx.dtype).reshape(self.rank)
        if (index < 0).any() or (index >= np.asarray(self.shape)).any():
            spsparse_error(
                -1, "Sparse index out of bounds: index=%s vs. shape=%s",
                tuple(index.tolist()), self.shape)
        if self._n == self._cap:
            self.reserve(max(16, self._cap * 2))
        self._idx[self._n] = index
        self._vals[self._n] = val
        self._n += 1

    def add_many(self, indices, vals) -> None:
        """Vectorized bulk append with a single bounds check."""
        indices = np.asarray(indices, dtype=self._idx.dtype)
        if indices.ndim == 1:
            indices = indices[:, None]
        vals = np.asarray(vals, dtype=self._vals.dtype)
        m = indices.shape[0]
        if m != vals.shape[0]:
            raise SpSparseError("add_many: indices/vals length mismatch")
        if m and ((indices < 0).any()
                  or (indices >= np.asarray(self.shape, indices.dtype)).any()):
            bad = np.argwhere((indices < 0)
                              | (indices >= np.asarray(self.shape,
                                                       indices.dtype)))[0, 0]
            spsparse_error(
                -1, "Sparse index out of bounds: index=%s vs. shape=%s",
                tuple(indices[bad].tolist()), self.shape)
        if self._n + m > self._cap:
            self.reserve(max(self._n + m, self._cap * 2))
        self._idx[self._n:self._n + m] = indices
        self._vals[self._n:self._n + m] = vals
        self._n += m

    def build(self, cap: int | None = None) -> SparseCOO:
        return SparseCOO.from_arrays(
            self._idx[: self._n].copy(), self._vals[: self._n].copy(),
            self.shape, cap=cap, check=False)


def coo_matrix(shape: Sequence[int], dtype=jnp.float32) -> CooBuilder:
    """Builder for a rank-2 array (reference ``VectorCooMatrix`` alias,
    ``VectorCooArray.hpp:352-353``)."""
    assert len(shape) == 2
    return CooBuilder(shape, dtype)


def coo_vector(shape_or_len, dtype=jnp.float32) -> CooBuilder:
    """Builder for a rank-1 array (reference ``VectorCooVector`` alias,
    ``VectorCooArray.hpp:355-356``)."""
    if isinstance(shape_or_len, int):
        shape_or_len = (shape_or_len,)
    assert len(shape_or_len) == 1
    return CooBuilder(shape_or_len, dtype)
