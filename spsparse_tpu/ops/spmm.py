"""Sparse x dense products: SpMV (dense vector) and SpMM (dense block).

The reference sketched-but-disabled this entire capability
(reference ``slib/spsparse/multiply_dense.hpp:8-36`` is ``#if 0``'d:
``y = M·x`` for a dense ``x`` with optional transpose and NaN/Inf
filtering). Here it is *the* first-class case — SURVEY §2 — because a
dense right-hand block feeds the matrix units and a dense vector turns
SpMV into a gather + segmented reduction with no sorting at all.

These are the generic XLA paths (segment scatter-add for CSR/COO, fully
vectorized gather+reduce for ELL); :mod:`spsparse_tpu.ops.spmv_kernels`
routes structured formats (DIA, prepared layouts) to their own paths.
Float32 contractions run at full precision (no TF32).

Semantics of the ``filter_nan`` flag follow the reference sketch
(``multiply_dense.hpp:20-23``): non-finite entries of the dense operand are
treated as zero so they do not poison the whole output row.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.backend import dot_precision
from ..core.coo import SparseCOO
from ..core.errors import spsparse_error
from ..core.structure import SparseCSR, SparseELL, to_csr
from ..utils.trace import traced

__all__ = ["spmv", "spmm"]

Array = Any


def _clean(x, filter_nan: bool):
    if filter_nan:
        return jnp.where(jnp.isfinite(x), x, 0)
    return x


# Bound on the materialized (rows_block, K, N) gather intermediate. The
# full-matrix form would materialize nrows*K*N elements — for config-3-scale
# problems (5M x 50 x 128) that is tens of GB, far beyond HBM. Blocking rows
# keeps the intermediate ~this many bytes while staying fully vectorized.
_SPMM_BLOCK_BYTES = 128 * 1024 * 1024


def _spmm_ell_blocked(A: "SparseELL", Xc, acc):
    """Row-blocked ELL SpMM: lax.map over row chunks, bounded intermediates."""
    nrows, K = A.cols.shape
    N = Xc.shape[1]
    item = jnp.dtype(acc).itemsize
    block = max(8, _SPMM_BLOCK_BYTES // max(K * N * item, 1))
    if block >= nrows:
        xg = jnp.take(Xc, A.cols.reshape(-1), axis=0, mode="fill",
                      fill_value=0).reshape(nrows, K, N)
        return jnp.einsum("rk,rkn->rn", A.vals.astype(acc), xg.astype(acc),
                          precision=dot_precision(acc))
    nblk = -(-nrows // block)
    pad = nblk * block - nrows
    cols = jnp.pad(A.cols, ((0, pad), (0, 0)),
                   constant_values=A.ncols).reshape(nblk, block, K)
    vals = jnp.pad(A.vals, ((0, pad), (0, 0))).reshape(nblk, block, K)

    def body(blk):
        c, v = blk
        g = jnp.take(Xc, c.reshape(-1), axis=0, mode="fill",
                     fill_value=0).reshape(block, K, N)
        return jnp.einsum("rk,rkn->rn", v.astype(acc), g.astype(acc),
                          precision=dot_precision(acc))

    y = jax.lax.map(body, (cols, vals))
    return y.reshape(nblk * block, N)[:nrows]


def _as_csr(A, transpose: bool) -> SparseCSR:
    if isinstance(A, SparseCSR):
        if not transpose:
            return A
        A = A.to_coo()
    if isinstance(A, SparseCOO):
        return to_csr(A, transpose=transpose)
    raise TypeError(f"unsupported sparse operand type {type(A)}")


@traced("spsparse.spmv")
def spmv(A, x, *, transpose: bool = False, filter_nan: bool = False) -> Array:
    """``y = A^(T?) @ x`` for dense ``x``; returns a dense vector.

    Accepts :class:`SparseCOO`, :class:`SparseCSR`, or :class:`SparseELL`
    (ELL ignores ``transpose``; convert first). The accumulation runs in the
    dtype promoted from ``A`` and ``x``.
    """
    x = jnp.asarray(x)
    if isinstance(A, SparseELL):
        if transpose:
            raise NotImplementedError("transpose SpMV on ELL: convert first")
        if x.shape[0] != A.ncols:
            spsparse_error(-1, "Inner dimensions for A (%d) and x (%d) must match!",
                           A.ncols, x.shape[0])
        xg = jnp.take(_clean(x, filter_nan), A.cols, mode="fill", fill_value=0)
        return jnp.sum(A.vals * xg, axis=1)

    csr = _as_csr(A, transpose)
    if x.shape[0] != csr.ncols:
        spsparse_error(-1, "Inner dimensions for A (%d) and x (%d) must match!",
                       csr.ncols, x.shape[0])
    xv = _clean(x, filter_nan)
    prod = csr.vals * jnp.take(xv, csr.cols, mode="fill", fill_value=0)
    rows = jnp.where(csr.valid_mask(), csr.row_ids(),
                     jnp.asarray(csr.nrows, jnp.int32))
    out_dtype = jnp.result_type(csr.vals, xv)
    return jnp.zeros((csr.nrows,), out_dtype).at[rows].add(prod, mode="drop")


@traced("spsparse.spmm")
def spmm(A, X, *, transpose: bool = False, filter_nan: bool = False,
         accum_dtype=None) -> Array:
    """``Y = A^(T?) @ X`` for a dense block ``X (K, N)``; returns ``(I, N)``.

    ``accum_dtype`` optionally forces the accumulation precision (e.g.
    ``jnp.float32`` for bf16 inputs — the mixed-precision recipe).
    """
    X = jnp.asarray(X)
    if X.ndim == 1:
        return spmv(A, X, transpose=transpose, filter_nan=filter_nan)
    if isinstance(A, SparseELL):
        if transpose:
            raise NotImplementedError("transpose SpMM on ELL: convert first")
        if X.shape[0] != A.ncols:
            spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must match!",
                           A.ncols, X.shape[0])
        Xc = _clean(X, filter_nan)
        acc = accum_dtype or jnp.result_type(A.vals, Xc)
        return _spmm_ell_blocked(A, Xc, acc)

    from ..core.bsr import SparseBSR
    if isinstance(A, SparseBSR):
        if transpose:
            raise NotImplementedError("transpose SpMM on BSR: convert first")
        return spmm_bsr(A, _clean(X, filter_nan), accum_dtype=accum_dtype)

    csr = _as_csr(A, transpose)
    if X.shape[0] != csr.ncols:
        spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must match!",
                       csr.ncols, X.shape[0])
    Xc = _clean(X, filter_nan)
    acc = accum_dtype or jnp.result_type(csr.vals, Xc)
    gathered = jnp.take(Xc, csr.cols, axis=0, mode="fill",
                        fill_value=0).astype(acc)
    prod = csr.vals[:, None].astype(acc) * gathered
    rows = jnp.where(csr.valid_mask(), csr.row_ids(),
                     jnp.asarray(csr.nrows, jnp.int32))
    out = jnp.zeros((csr.nrows, X.shape[1]), acc)
    return out.at[rows].add(prod, mode="drop")


def spmm_bsr(bsr, X, *, accum_dtype=None) -> Array:
    """BSR x dense block: one dense matmul per stored tile.

    Gathers ``bw``-row slices of ``X`` per block (full-lane contiguous
    chunks), runs a batched ``(bh, bw) @ (bw, N)`` matmul, and segment-adds
    the results into block rows of ``Y``.
    """
    X = jnp.asarray(X)
    bh, bw = bsr.block_shape
    if X.shape[0] != bsr.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must match!",
                       bsr.shape[1], X.shape[0])
    acc = accum_dtype or jnp.result_type(bsr.blocks, X)
    N = X.shape[1]
    kpad = bsr.nbcols * bw - X.shape[0]
    Xp = jnp.pad(X, ((0, kpad), (0, 0))).reshape(bsr.nbcols, bw, N)
    live = bsr.valid_mask()
    bc = jnp.where(live, bsr.bcols, bsr.nbcols)
    gathered = jnp.take(Xp, bc, axis=0, mode="fill",
                        fill_value=0)                     # (cap, bw, N)
    tiles = jnp.einsum("chw,cwn->chn", bsr.blocks, gathered,
                       preferred_element_type=acc,
                       precision=dot_precision(bsr.blocks.dtype,
                                               gathered.dtype))
    br = jnp.where(live, bsr.block_rows(), bsr.nbrows)
    Y = jnp.zeros((bsr.nbrows, bh, N), acc).at[br].add(
        jnp.where(live[:, None, None], tiles, 0), mode="drop")
    return Y.reshape(bsr.nbrows * bh, N)[: bsr.shape[0]]
