"""SpMV/SpMM dispatch over the storage formats.

* :func:`spmv_dia` — banded/diagonal matrices: one elementwise expression
  that multiplies each diagonal by a static shifted window of ``x`` and
  sums over diagonals. For a vector XLA compiles it to one loop fusion
  that streams ``data`` once; a multi-column ``X (m, R)`` reads each
  diagonal once for all ``R`` right-hand sides.
* :func:`spmv_ell` — general bounded-row-length matrices: gather + row
  reduce.
* :func:`best_spmv` / :func:`best_spmm` — pick the implementation for the
  operand's format.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import jax
import jax.numpy as jnp

from ..core.dia import SparseDIA
from ..core.structure import SparseELL
from .spmm import spmv as _spmv_generic

Array = Any

__all__ = ["spmv_dia", "spmv_ell", "prepare_dia", "best_spmv", "best_spmm",
           "spmm_route"]


def _dia_row_ranges(dia: SparseDIA):
    """Per diagonal ``(k, off, lo, hi)``: rows ``[lo, hi)`` read an
    in-range ``x[i + off]``; fully out-of-range diagonals are skipped."""
    n, m = dia.shape
    for k, off in enumerate(dia.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            yield k, off, lo, hi


def spmv_dia(dia: SparseDIA, x: Array) -> Array:
    """``y = A @ x`` for diagonal storage: ``y[i] = sum_k data[k, i] *
    x[i + off_k]``. ``x`` is ``(m,)`` or ``(m, R)`` (``R`` right-hand
    sides); the result is ``(n,)`` or ``(n, R)``.

    ``x`` is zero-padded once and flattened with its right-hand sides, so
    every diagonal's window is a static 1-D slice and the whole product is
    one elementwise sum over diagonals; entries of ``data`` outside the
    matrix (row ``i`` with ``i + off`` out of range) are masked out.
    Accumulation runs in at least float32 (bf16 diagonal data streams half
    the bytes)."""
    n, m = dia.shape
    x = jnp.asarray(x)
    acc = jnp.promote_types(jnp.result_type(dia.data, x), jnp.float32)
    ranges = list(_dia_row_ranges(dia))
    if not ranges:
        return jnp.zeros((n,) + x.shape[1:], acc)
    r = math.prod(x.shape[1:])
    pad_lo = max(0, -min(off for _, off, _, _ in ranges))
    pad_hi = max(0, max(off for _, off, _, _ in ranges) + n - m)
    xf = jnp.pad(x.astype(acc),
                 [(pad_lo, pad_hi)] + [(0, 0)] * (x.ndim - 1)).reshape(-1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, r), 0)
    terms = [
        jnp.where((rows >= lo) & (rows < hi), dia.data[k].astype(acc)[:, None],
                  0).reshape(-1)
        * jax.lax.slice_in_dim(xf, (pad_lo + off) * r, (pad_lo + off + n) * r)
        for k, off, lo, hi in ranges]
    return functools.reduce(jnp.add, terms).reshape((n,) + x.shape[1:])


def prepare_dia(dia: SparseDIA, *, dtype=jnp.float32) -> SparseDIA:
    """The diagonal data in its storage dtype, zeroed outside the matrix:
    ``dtype=jnp.bfloat16`` halves the dominant stream (products still
    accumulate in float32). Build once, reuse across many products."""
    rows = jnp.arange(dia.shape[0])
    data = jnp.stack([
        jnp.where((rows >= max(0, -off))
                  & (rows < min(dia.shape[0], dia.shape[1] - off)),
                  dia.data[k], 0)
        for k, off in enumerate(dia.offsets)]) if dia.offsets else dia.data
    return SparseDIA(data=data.astype(dtype), offsets=dia.offsets,
                     shape=dia.shape)


def spmv_ell(ell: SparseELL, x: Array) -> Array:
    """Gather + row-reduce over the regular ELL layout."""
    xg = jnp.take(x, ell.cols, mode="fill", fill_value=0)
    return jnp.sum(ell.vals * xg, axis=1)


def spmm_route(a, platform: str | None = None) -> str:
    """Name of the implementation :func:`best_spmv`/:func:`best_spmm` run
    for operand ``a`` on ``platform`` (default: the default device's).
    The only platform-dependent choice is the block SpMM's Hopper kernel
    (:func:`spsparse_tpu.core.backend.runs_gpu_kernel`)."""
    from ..core.bsr import SparseBSR
    from ..core.tiled import SparseTiledCOO
    from ..core.backend import runs_gpu_kernel
    from .block_spmm import PreparedTiledDense
    from .general import PreparedGather, PreparedGatherEll, PreparedGeneral

    if isinstance(a, PreparedGeneral):
        a = a.prep
    if isinstance(a, SparseDIA):
        return "dia_fused"
    if isinstance(a, PreparedGatherEll):
        return "gather_ell"
    if isinstance(a, PreparedGather):
        return "gather_segment_sum"
    if isinstance(a, PreparedTiledDense):
        return ("block_pallas" if runs_gpu_kernel(a.blocks.dtype, platform)
                else "block_xla")
    if isinstance(a, SparseTiledCOO):
        return "tiled_onehot"
    if isinstance(a, SparseBSR):
        return "bsr"
    if isinstance(a, SparseELL):
        return "ell"
    return "csr_segment_sum"


def best_spmv(a, x: Array) -> Array:
    """Format-dispatched SpMV (jittable; dispatch is static on type)."""
    from .general import PreparedGeneral, spmv_general

    if isinstance(a, SparseDIA):
        return spmv_dia(a, x)
    if isinstance(a, PreparedGeneral):
        return spmv_general(a, x)
    if isinstance(a, SparseELL):
        return spmv_ell(a, x)
    return _spmv_generic(a, x)


def best_spmm(a, X: Array) -> Array:
    """Format-dispatched SpMM ``Y = A @ X`` (dense ``X (K, N)``).

    Routes: ``PreparedGeneral`` -> its prepared layout;
    ``PreparedTiledDense`` -> the block-sparse SpMM (the Hopper kernel on
    a GPU, its plain XLA form elsewhere); ``SparseTiledCOO`` -> the
    one-hot tiled form; ``SparseBSR`` -> block matmuls; ``SparseDIA`` ->
    the fused diagonal expression over all columns at once; CSR/ELL/COO
    -> the generic gather path."""
    from ..core.bsr import SparseBSR
    from ..core.tiled import SparseTiledCOO
    from .block_spmm import PreparedTiledDense, spmm_tiled_dense
    from .general import PreparedGeneral, spmm_general
    from .spmm import spmm as _spmm_generic, spmm_bsr

    if isinstance(a, PreparedGeneral):
        return spmm_general(a, X)
    if isinstance(a, PreparedTiledDense):
        return spmm_tiled_dense(a, X)
    if isinstance(a, SparseTiledCOO):
        from .tiled_ops import spmm_tiled

        return spmm_tiled(a, X)
    if isinstance(a, SparseBSR):
        return spmm_bsr(a, X)
    if isinstance(a, SparseDIA):
        return spmv_dia(a, X)
    return _spmm_generic(a, X)
