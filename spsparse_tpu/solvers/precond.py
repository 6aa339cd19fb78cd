"""Preconditioners over the format zoo — the data-parallel menu.

The reference library stops at the multiply chain (there is no solver or
preconditioner code in ``/root/reference``); production regridding
pipelines run Krylov iterations around those products, so this layer is
part of the framework's end-to-end surface (ROADMAP item 9).

On wide data-parallel hardware the classic strong preconditioners (ILU(0), SSOR) were long
considered hostile: naive triangular solves are length-``n`` serial
dependency chains. This module's menu avoids them entirely; since the
direct tier landed, :func:`spsparse_tpu.solvers.spilu` *is* available
as a triangular-solve preconditioner — its ILUT factors are shallow
enough that the level-sweep substitution (solvers/direct.py) runs as a
few fully-vectorized SpMV sweeps. Menu implemented here:

* **Jacobi** (:func:`spsparse_tpu.solvers.jacobi_preconditioner`) —
  elementwise inverse diagonal; free.
* **Block-Jacobi** (:func:`block_jacobi_preconditioner`) — batched dense
  inverses of the ``bs x bs`` diagonal blocks, applied as one batched
  matmul per iteration: dense batched work, and the standard
  strength upgrade over Jacobi for banded/regridding operators.
* **Neumann-series / polynomial** (:func:`neumann_preconditioner`) —
  ``M^-1 = sum_{i<k} (I - D^-1 A)^i D^-1``: ``k-1`` extra SpMVs through
  the operator's own hot kernel. This is the "ILU-like strength knob"
  without triangular solves, and it composes with *any* matvec —
  including the distributed ones.

:func:`extract_diagonal` makes every storage format feed these uniformly.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..core.bsr import SparseBSR
from ..core.coo import SparseCOO
from ..core.dia import SparseDIA
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR
from ..core.tiled import SparseTiledCOO, TILE

Array = Any

__all__ = ["extract_diagonal", "block_jacobi_preconditioner",
           "neumann_preconditioner", "extract_diag_blocks"]


def _diag_len(shape) -> int:
    return min(shape[0], shape[1])


def extract_diagonal(a) -> Array:
    """``diag(A)`` as a dense ``(min(shape),)`` vector, for any rank-2
    format (COO / CSR / DIA / BSR / tiled). Duplicate entries sum (COO
    ADD semantics). Jit-compatible for every format."""
    if isinstance(a, SparseCOO):
        if a.rank != 2:
            raise SpSparseError("extract_diagonal requires a rank-2 array")
        n = _diag_len(a.shape)
        i, j = a.indices[:, 0], a.indices[:, 1]
        hit = a.valid_mask() & (i == j)
        idx = jnp.where(hit, i, n).astype(jnp.int32)
        return jnp.zeros(n, a.vals.dtype).at[idx].add(
            jnp.where(hit, a.vals, 0), mode="drop")
    if isinstance(a, SparseCSR):
        n = _diag_len(a.shape)
        rows = a.row_ids()
        hit = (a.cols == rows) & (a.cols < a.ncols)
        idx = jnp.where(hit, rows, n).astype(jnp.int32)
        return jnp.zeros(n, a.vals.dtype).at[idx].add(
            jnp.where(hit, a.vals, 0), mode="drop")
    if isinstance(a, SparseDIA):
        n = _diag_len(a.shape)
        if 0 in a.offsets:
            return a.data[a.offsets.index(0), :n]
        return jnp.zeros(n, a.data.dtype)
    if isinstance(a, SparseBSR):
        bh, bw = a.block_shape
        if bh != bw:
            raise SpSparseError(
                "extract_diagonal on BSR requires square blocks")
        n = _diag_len(a.shape)
        nb = -(-n // bh)
        # Block k sits in block row brow(k); it carries main-diagonal
        # entries iff bcols[k] == brow(k). Batched scatter of each such
        # block's own diagonal.
        brow = jnp.searchsorted(a.row_ptr,
                                jnp.arange(a.cap_blocks, dtype=a.row_ptr.dtype),
                                side="right").astype(jnp.int32) - 1
        hit = a.valid_mask() & (a.bcols == brow)
        bdiag = jnp.diagonal(a.blocks, axis1=1, axis2=2)      # (cap, bh)
        dest = jnp.where(hit, brow, nb)[:, None] * bh + jnp.arange(bh)
        return jnp.zeros(nb * bh, a.blocks.dtype).at[
            dest.reshape(-1)].add(
            jnp.where(hit[:, None], bdiag, 0).reshape(-1), mode="drop")[:n]
    if isinstance(a, SparseTiledCOO):
        n = _diag_len(a.shape)
        live = a.valid_mask()[:, None] & (a.vals != 0)
        on_diag = ((a.tile_row == a.tile_col)[:, None]
                   & (a.rows == a.cols) & live)
        gi = (a.tile_row[:, None] * TILE + a.rows.astype(jnp.int32))
        idx = jnp.where(on_diag, gi, n)
        return jnp.zeros(n, a.vals.dtype).at[idx.reshape(-1)].add(
            jnp.where(on_diag, a.vals, 0).reshape(-1), mode="drop")
    raise SpSparseError(f"extract_diagonal: unsupported type {type(a)!r}")


def extract_diag_blocks(a, bs: int) -> Array:
    """The ``bs x bs`` main-diagonal blocks of a rank-2 ``SparseCOO`` as a
    dense ``(nb, bs, bs)`` stack (zero-filled; identity is NOT added).
    Entries outside the blocks are ignored; the last block of a
    non-multiple extent is zero-padded. Jit-compatible."""
    if not isinstance(a, SparseCOO) or a.rank != 2:
        raise SpSparseError("extract_diag_blocks requires a rank-2 "
                            "SparseCOO (convert other formats via COO)")
    n = _diag_len(a.shape)
    nb = -(-n // bs)
    i, j = a.indices[:, 0], a.indices[:, 1]
    bi, bj = i // bs, j // bs
    hit = a.valid_mask() & (bi == bj) & (i < n) & (j < n)
    flat = jnp.where(hit, (bi * bs + (i % bs)) * bs + (j % bs),
                     nb * bs * bs)
    out = jnp.zeros(nb * bs * bs, a.vals.dtype).at[
        flat.astype(jnp.int32)].add(jnp.where(hit, a.vals, 0), mode="drop")
    return out.reshape(nb, bs, bs)


def block_jacobi_preconditioner(a, bs: int = 128,
                                eps: float = 1e-12) -> Callable:
    """Block-Jacobi ``z = M^{-1} r`` with ``bs x bs`` diagonal blocks.

    Setup inverts the diagonal blocks once (batched ``jnp.linalg.inv``);
    application is one batched ``(nb, bs, bs) @
    (nb, bs)`` matmul per iteration. Singular/empty blocks (zero rows,
    e.g. the zero padding of the last block) fall back to the Jacobi
    scaling of their diagonal so the operator stays SPD-definite.
    Returns a callable for :func:`spsparse_tpu.solvers.pcg_solve`."""
    blocks = extract_diag_blocks(a, bs)
    nb = blocks.shape[0]
    n = _diag_len(a.shape)
    # Regularize: rows with an empty diagonal get a unit diagonal so the
    # block stays invertible (equivalent to identity preconditioning of
    # those rows — the same guard jacobi_preconditioner applies).
    d = jnp.diagonal(blocks, axis1=1, axis2=2)
    fix = (jnp.abs(d) <= eps).astype(blocks.dtype)
    inv = jnp.linalg.inv(blocks + jax.vmap(jnp.diag)(fix))
    # NB: close over `inv` ONLY — capturing `blocks` too would keep a
    # second (nb, bs, bs) stack (512 MB at 1M rows / bs=128) alive for
    # the preconditioner's lifetime.
    dt = inv.dtype

    def apply(r: Array) -> Array:
        pad = nb * bs - r.shape[0]
        rp = jnp.pad(r, (0, pad)).reshape(nb, bs)
        z = jnp.einsum("bij,bj->bi", inv, rp.astype(dt))
        return z.reshape(-1)[:n].astype(r.dtype)

    return apply


def neumann_preconditioner(matvec: Callable[[Array], Array], diag: Array,
                           k: int = 2, eps: float = 1e-12) -> Callable:
    """Truncated Neumann-series preconditioner.

    With ``D = diag(A)`` and ``N = I - D^{-1} A``,
    ``M^{-1} r = (I + N + ... + N^{k-1}) D^{-1} r`` — each extra term is
    one application of the operator's own (hot, already-optimized) SpMV.
    ``k=1`` degenerates to Jacobi. Converges as a preconditioner whenever
    the Jacobi iteration matrix has spectral radius < 1 (diagonally
    dominant operators — the regridding/stencil family)."""
    if k < 1:
        raise SpSparseError("neumann_preconditioner requires k >= 1")
    dinv = jnp.where(jnp.abs(diag) > eps, 1.0 / diag, 1.0)

    def apply(r: Array) -> Array:
        y = dinv * r
        z = y
        for _ in range(k - 1):
            y = y - dinv * matvec(y)
            z = z + y
        return z

    return apply
