"""General (unstructured) sparse SpMV/SpMM: one prepared operand.

This is the user-facing entry for matrices with no exploitable structure
(not banded -> DIA, not block -> BSR). Preparation is host-side and done
once per matrix; it composes:

1. :func:`spsparse_tpu.core.tiled.pack_columns` — SELL-style column
   permutation clustering each row block's columns (fewer occupied
   128x128 tiles; the dense X operand is permuted with one whole-row
   gather at multiply time);
2. tiling (:func:`spsparse_tpu.core.tiled.to_tiled`);
3. a static layout choice by the post-packing fill (entries per occupied
   128x128 tile): at or above ``dense_fill_threshold(dtype)`` the
   dense-block layout (:mod:`spsparse_tpu.ops.block_spmm`, whose cost
   is fixed per tile), below it a row-gather layout — ELL when row lengths are
   bounded, else an entry list with a segment sum.

The reference's counterpart is the generic ``multiply`` path
(multiply_sparse.hpp:281-365) plus the ``#if 0``'d dense-vector sketch
(multiply_dense.hpp:8-36); here the dense-operand case is first-class.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.coo import SparseCOO
from ..core.errors import spsparse_error
from ..core.tiled import SparseTiledCOO, pack_columns, to_tiled
from .block_spmm import (PreparedTiledDense, dense_fill_threshold,
                         prepare_tiled_dense, spmm_tiled_dense)

Array = Any

__all__ = ["PreparedGeneral", "PreparedGather", "PreparedGatherEll",
           "prepare_general", "spmm_general", "spmv_general"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedGather:
    """Row-gather layout for ultra-scattered matrices: consolidated
    (row-major sorted) entry lists. ``rows`` keeps the sentinel (= nrows)
    on padding entries — the segment sum routes them to a dropped extra
    bucket; ``cols`` are clamped in-range (padding vals are zero)."""

    rows: Array = dataclasses.field(metadata=dict(static=False))
    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedGatherEll:
    """ELL row-gather layout: ``cols/vals (m, Kmax)`` with column-0
    zero-value padding. The multiply is a reshape-reduce —
    ``(vals[:, :, None] * X[cols]).sum(1)`` — with no segment machinery.
    Chosen by ``prepare_general`` when row-length padding stays bounded
    (``Kmax * m <= _ELL_PAD_LIMIT * nnz``); long-tailed row lengths keep
    the entry-list + segment-sum layout."""

    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))


# ELL is chosen while Kmax * nrows <= this multiple of nnz (padding
# inflates the gather volume linearly; beyond ~3x the segment path wins
# back despite its fixed cost).
_ELL_PAD_LIMIT = 3.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedGeneral:
    """Prepared general sparse operand: column order (new -> old;
    ``None`` = identity, skipping the X gather entirely) + the layout
    chosen at prepare time from the post-packing fill."""

    order: Any = dataclasses.field(metadata=dict(static=False))
    prep: Any = dataclasses.field(metadata=dict(static=False))

    @property
    def shape(self) -> tuple:
        return self.prep.shape

    @property
    def kernel(self) -> str:
        if isinstance(self.prep, PreparedGatherEll):
            return "gather_ell"
        if isinstance(self.prep, PreparedGather):
            return "gather"
        return "dense_block"


def _prepare_gather(a: SparseCOO,
                    dtype=None) -> PreparedGather | PreparedGatherEll:
    ac = a.consolidate((0, 1))
    idx = ac.indices
    nrows, ncols = ac.shape
    nnz = int(ac.nnz)
    rows_h = np.asarray(idx[:nnz, 0])
    counts = np.bincount(rows_h, minlength=nrows)
    kmax = int(counts.max(initial=0))
    if kmax and kmax * nrows <= _ELL_PAD_LIMIT * max(nnz, 1):
        cols_h = np.asarray(idx[:nnz, 1])
        vals_h = np.asarray(ac.vals[:nnz])
        # padding slots carry column 0 + value 0 (an in-range index keeps
        # the multiply's gather off the fill-mode path); 0 * X[0] = 0
        # except for non-finite X rows, the same padded-zero contract the
        # dense-block layout uses
        ell_cols = np.zeros((nrows, kmax), np.asarray(idx).dtype)
        ell_vals = np.zeros((nrows, kmax), vals_h.dtype)
        slot = np.arange(nnz) - np.repeat(
            np.cumsum(counts) - counts, counts)
        ell_cols[rows_h, slot] = cols_h
        ell_vals[rows_h, slot] = vals_h
        vals_j = jnp.asarray(ell_vals)
        if dtype is not None and dtype != jnp.float32:
            vals_j = vals_j.astype(dtype)   # halves the A payload; the
            # multiply still accumulates in f32
        return PreparedGatherEll(cols=jnp.asarray(ell_cols),
                                 vals=vals_j, shape=ac.shape)
    cols = jnp.minimum(idx[:, 1], ncols - 1)  # keep the index dtype
    return PreparedGather(rows=idx[:, 0], cols=cols,
                          vals=ac.vals, shape=ac.shape)


def prepare_general(a: SparseCOO | SparseTiledCOO, *, pack: bool = True,
                    dtype=jnp.float32) -> PreparedGeneral:
    """Prepare a rank-2 COO for repeated products (host-side, eager).

    Layout choice by the post-packing fill (entries per occupied 128x128
    tile): >= ``dense_fill_threshold(dtype)`` -> dense blocks; below that a
    row-gather layout (``PreparedGatherEll`` for bounded row lengths,
    else ``PreparedGather``). Packing is applied only when it reduces the
    occupied-tile count (a concentrated packing can inflate the
    per-block-row tile maximum without helping traffic).

    ``pack=False`` skips the column permutation (``order`` = identity) —
    use when X cannot be permuted (e.g. it is itself an operand of other
    unpermuted products). ``dtype=jnp.bfloat16`` stores the blocks (or
    the ELL values) in bf16 — half the A traffic, f32 accumulation. A
    ``SparseTiledCOO`` input always takes the dense-block layout."""
    if isinstance(a, SparseTiledCOO):
        return PreparedGeneral(order=None,
                               prep=prepare_tiled_dense(a, dtype=dtype))
    if a.rank != 2:
        spsparse_error(-1, "prepare_general requires a rank-2 array")
    tl, order = to_tiled(a), None
    if pack:
        ap, p_order = pack_columns(a)
        tl_packed = to_tiled(ap)
        if int(tl_packed.n_tiles) < int(tl.n_tiles):
            tl, order = tl_packed, p_order
    fill = float(jnp.sum(tl.vals != 0)) / max(int(tl.n_tiles), 1)
    if fill >= dense_fill_threshold(dtype or jnp.float32):
        return PreparedGeneral(order=order,
                               prep=prepare_tiled_dense(tl, dtype=dtype))
    prep_g = _prepare_gather(a, dtype=dtype)
    if (dtype not in (jnp.float32, None)
            and isinstance(prep_g, PreparedGather)):
        import warnings

        warnings.warn(
            "prepare_general: low fill + long-tailed rows select "
            "the entry-list row-gather layout, which is f32; "
            f"dtype={dtype} does not apply (the ELL layout would "
            "honor it)", stacklevel=2)
    return PreparedGeneral(order=None, prep=prep_g)


def spmm_general(pg: PreparedGeneral, X: Array, *,
                 interpret: bool = False) -> Array:
    """``Y = A @ X`` through the prepared layout (rows of ``X`` are
    permuted by the packing order — one whole-row XLA gather).
    ``interpret=True`` runs the dense-block kernel in the Pallas
    interpreter (tests)."""
    X = jnp.asarray(X)
    if X.shape[0] != pg.shape[1]:
        spsparse_error(-1,
                       "Inner dimensions for A (%d) and X (%d) must match!",
                       pg.shape[1], X.shape[0])
    Xp = X if pg.order is None else X[pg.order]
    if isinstance(pg.prep, PreparedGatherEll):
        p = pg.prep
        m, kmax = p.cols.shape
        # gather in the RHS's own dtype (a bf16 X halves the dominant
        # stream), then accumulate in f32.
        g = jnp.take(Xp, p.cols.reshape(-1), axis=0).astype(jnp.float32)
        prod = p.vals.astype(jnp.float32).reshape(m, kmax, 1) \
            * g.reshape(m, kmax, Xp.shape[1])
        return prod.sum(axis=1)
    if isinstance(pg.prep, PreparedGather):
        p = pg.prep
        g = jnp.take(Xp.astype(jnp.float32), p.cols, axis=0)
        prod = p.vals.astype(jnp.float32)[:, None] * g
        return jax.ops.segment_sum(prod, p.rows,
                                   num_segments=p.shape[0] + 1)[:p.shape[0]]
    return spmm_tiled_dense(pg.prep, Xp, interpret=interpret)


def spmv_general(pg: PreparedGeneral, x: Array, *,
                 interpret: bool = False) -> Array:
    """``y = A @ x`` — the SpMM path at N=1."""
    x = jnp.asarray(x)
    return spmm_general(pg, x[:, None], interpret=interpret)[:, 0]
