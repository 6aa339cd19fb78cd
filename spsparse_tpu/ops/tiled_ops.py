"""SpMV/SpMM over the tiled one-hot COO format: the plain reference of
the tiled COO layout.

See :mod:`spsparse_tpu.core.tiled` for the format. The compute pattern per
live tile ``t`` at (R, C) tile coordinates::

    xg   = OneHot(cols_t) @ x_block[C]          # (cap,128)@(128,) gather
    prod = vals_t * xg
    y_block[R] += OneHot(rows_t)^T @ prod       # (128,cap)@(cap,) scatter

Everything is batched over tiles with one ``einsum`` pair; both "gathers"
are matmuls, at full float32 precision. FLOP cost is
``512 * tile_cap * n_tiles`` whatever the fill; for repeated products
prepare the matrix with :func:`spsparse_tpu.ops.prepare_general`.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.tiled import SparseTiledCOO, TILE
from ..core.errors import spsparse_error

Array = Any

__all__ = ["spmv_tiled", "spmm_tiled"]


def _onehot_products(tl: SparseTiledCOO, xb: Array) -> Array:
    """Per-tile partial results: (nt_cap, TILE[, N]) contributions."""
    live = tl.valid_mask()
    # entry validity: padded slots have val 0 -> contribute nothing.
    iot = jnp.arange(TILE, dtype=jnp.int32)
    oh_cols = (tl.cols.astype(jnp.int32)[:, :, None] == iot[None, None, :]
               ).astype(xb.dtype)                       # (nt, cap, 128)
    gathered = jnp.einsum("tck,tk...->tc...", oh_cols, xb,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    vshape = tl.vals.shape + (1,) * (gathered.ndim - 2)
    prod = tl.vals.astype(jnp.float32).reshape(vshape) * gathered
    oh_rows = (tl.rows.astype(jnp.int32)[:, :, None] == iot[None, None, :]
               ).astype(jnp.float32)
    out = jnp.einsum("tcr,tc...->tr...", oh_rows, prod,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.where(live[(...,) + (None,) * (out.ndim - 1)], out, 0)


def spmv_tiled(tl: SparseTiledCOO, x: Array) -> Array:
    """``y = A @ x`` over the tiled format; dense 1-D ``x``."""
    x = jnp.asarray(x)
    if x.shape[0] != tl.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and x (%d) must match!",
                       tl.shape[1], x.shape[0])
    nbc, nbr = tl.nbcols, tl.nbrows
    xp = jnp.pad(x.astype(jnp.float32), (0, nbc * TILE - x.shape[0]))
    xblocks = xp.reshape(nbc, TILE)
    tc = jnp.where(tl.valid_mask(), tl.tile_col, nbc)
    xb = jnp.take(xblocks, tc, axis=0, mode="fill", fill_value=0)
    ytiles = _onehot_products(tl, xb)                   # (nt, 128)
    tr = jnp.where(tl.valid_mask(), tl.tile_row, nbr)
    y = jnp.zeros((nbr + 1, TILE), jnp.float32).at[tr].add(
        ytiles, mode="drop")
    return y[:nbr].reshape(-1)[: tl.shape[0]]


def spmm_tiled(tl: SparseTiledCOO, X: Array) -> Array:
    """``Y = A @ X`` over the tiled format; dense ``X (K, N)``."""
    X = jnp.asarray(X)
    if X.shape[0] != tl.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must match!",
                       tl.shape[1], X.shape[0])
    N = X.shape[1]
    nbc, nbr = tl.nbcols, tl.nbrows
    Xp = jnp.pad(X.astype(jnp.float32),
                 ((0, nbc * TILE - X.shape[0]), (0, 0)))
    Xblocks = Xp.reshape(nbc, TILE, N)
    tc = jnp.where(tl.valid_mask(), tl.tile_col, nbc)
    xb = jnp.take(Xblocks, tc, axis=0, mode="fill", fill_value=0)
    ytiles = _onehot_products(tl, xb)                   # (nt, 128, N)
    tr = jnp.where(tl.valid_mask(), tl.tile_row, nbr)
    Y = jnp.zeros((nbr + 1, TILE, N), jnp.float32).at[tr].add(
        ytiles, mode="drop")
    return Y[:nbr].reshape(nbr * TILE, N)[: tl.shape[0]]
