"""Tiled COO — general sparse matrices grouped into 128x128 tiles.

The tiled layout is the source of the dense-block SpMM layout
(:mod:`spsparse_tpu.ops.block_spmm`) and of the tiled SpGEMM. Its own
plain product (:mod:`spsparse_tpu.ops.tiled_ops`) indexes through one-hot
matmuls, where a 128-wide gather/scatter costs two tile matmuls instead
of 128 scalar loads:

    y_tile += OneHot(rows)^T @ (vals * (OneHot(cols) @ x_tile))

Entries are grouped into ``(128, 128)`` tiles; only nonempty tiles are
stored (a sparse tile pattern), each padded to a static per-tile entry
budget ``tile_cap``. Per entry we store int8 row/col offsets within the
tile plus the value — 6 bytes of index+value payload. Dense x/y are touched
at whole-tile granularity: x tile rows are fetched by a block-row gather
(tiny index count), y tiles are segment-summed by tile row (tiles are kept
row-major sorted).

This format is this framework's own design; the reference has no
counterpart to cite.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .coo import SparseCOO, round_up_pow2
from .errors import SpSparseError

__all__ = ["SparseTiledCOO", "to_tiled", "pack_columns"]

Array = Any

TILE = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseTiledCOO:
    """Sparse pattern of dense-indexed 128x128 tiles.

    ``tile_row/tile_col (nt_cap,)`` int32 tile coordinates (row-major
    sorted, sentinel = nbrows/nbcols for padding); ``rows/cols (nt_cap,
    tile_cap)`` int8 in-tile offsets; ``vals (nt_cap, tile_cap)`` f32 with
    zero padding; ``n_tiles`` live-tile count.
    """

    tile_row: Array = dataclasses.field(metadata=dict(static=False))
    tile_col: Array = dataclasses.field(metadata=dict(static=False))
    rows: Array = dataclasses.field(metadata=dict(static=False))
    cols: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    n_tiles: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nt_cap(self) -> int:
        return self.tile_row.shape[0]

    @property
    def tile_cap(self) -> int:
        return self.rows.shape[1]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // TILE)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // TILE)

    def valid_mask(self) -> Array:
        return jnp.arange(self.nt_cap, dtype=jnp.int32) < self.n_tiles

    def to_dense(self) -> Array:
        nr, nc = self.nbrows * TILE, self.nbcols * TILE
        dense = jnp.zeros((nr, nc), self.vals.dtype)
        live = self.valid_mask()[:, None] & (self.vals != 0)
        gr = (jnp.where(self.valid_mask(), self.tile_row, self.nbrows)[:, None]
              * TILE + self.rows.astype(jnp.int32))
        gc = (jnp.where(self.valid_mask(), self.tile_col, self.nbcols)[:, None]
              * TILE + self.cols.astype(jnp.int32))
        gr = jnp.where(live, gr, nr)
        dense = dense.at[gr.reshape(-1), gc.reshape(-1)].add(
            jnp.where(live, self.vals, 0).reshape(-1), mode="drop")
        return dense[: self.shape[0], : self.shape[1]]


def pack_columns(a: SparseCOO) -> tuple[SparseCOO, Array]:
    """Column-permute ``a`` so each row block's columns cluster into few
    128-wide tiles (SELL-style fill raising; host-side eager).

    Low tile fill is the measured limiter of the tiled kernels on
    scattered matrices (~25 entries per 128x128 tile means every X-tile
    fetch moves ~5x the useful bytes). Each column is assigned to the row
    block that references it most (its *modal* block); a stable sort by
    owner block then packs every block's columns contiguously, so that
    block's entries land in ``ceil(distinct_cols / 128)`` tiles — the
    minimum a column permutation can achieve. Columns shared across
    blocks stay owned by their heaviest user; untouched columns go last.

    Returns ``(a_packed, order)`` where ``order`` maps new column -> old
    column: ``a_packed[:, k] == a[:, order[k]]``. Products are preserved
    by permuting the dense operand's rows once::

        to_tiled(a_packed) @ X[order]  ==  a @ X

    (``order`` is returned as a device array so ``X[order]`` is a single
    XLA gather of whole rows — lane-contiguous, cheap.)
    """
    if a.rank != 2:
        raise SpSparseError("pack_columns requires a rank-2 array")
    n = int(a.nnz)
    idx = np.asarray(a.indices)[:n].astype(np.int64)
    vals = np.asarray(a.vals)[:n]
    ncols = a.shape[1]
    nbr = -(-a.shape[0] // TILE)
    owner = np.full(ncols, nbr, np.int64)      # untouched columns last
    if n:
        rb = idx[:, 0] // TILE
        key = idx[:, 1] * nbr + rb
        uk, counts = np.unique(key, return_counts=True)
        kc, krb = uk // nbr, uk % nbr
        # Modal row block per column: heaviest (col, block) pair first.
        sel = np.lexsort((krb, -counts, kc))
        first = np.ones(sel.size, bool)
        first[1:] = kc[sel][1:] != kc[sel][:-1]
        owner[kc[sel][first]] = krb[sel][first]
    order = np.argsort(owner, kind="stable")
    inv = np.empty(ncols, np.int64)
    inv[order] = np.arange(ncols)

    new_idx = idx.copy()
    new_idx[:, 1] = inv[idx[:, 1]]
    from .coo import CooBuilder
    b = CooBuilder(a.shape, dtype=vals.dtype, index_dtype=a.index_dtype)
    b.add_many(new_idx, vals)
    return b.build(cap=a.cap), jnp.asarray(order)


def to_tiled(a: SparseCOO, *, tile_cap: int | None = None,
             nt_cap: int | None = None) -> SparseTiledCOO:
    """COO → tiled COO (host-side eager). Duplicates are preserved (they
    sum in products, same as COO semantics under ADD)."""
    if a.rank != 2:
        raise SpSparseError("to_tiled requires a rank-2 array")
    idx, vals = a.to_lists()
    idx = np.asarray(idx, np.int64).reshape(len(vals), 2)
    vals = np.asarray(vals, np.float32)
    nbc = -(-a.shape[1] // TILE)
    tr, tc = idx[:, 0] // TILE, idx[:, 1] // TILE
    key = tr * nbc + tc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts, counts = np.unique(key_s, return_index=True,
                                     return_counts=True)
    nt = uniq.shape[0]
    if tile_cap is None:
        tile_cap = round_up_pow2(int(counts.max(initial=1)))
    elif counts.size and counts.max() > tile_cap:
        raise SpSparseError(
            f"tile_cap={tile_cap} < max tile occupancy {counts.max()}")
    if nt_cap is None:
        nt_cap = round_up_pow2(max(nt, 1))
    elif nt > nt_cap:
        raise SpSparseError(f"nt_cap={nt_cap} < {nt}")

    nbr = -(-a.shape[0] // TILE)
    tile_row = np.full(nt_cap, nbr, np.int32)
    tile_col = np.full(nt_cap, nbc, np.int32)
    rows = np.zeros((nt_cap, tile_cap), np.int8)
    cols = np.zeros((nt_cap, tile_cap), np.int8)
    v = np.zeros((nt_cap, tile_cap), np.float32)
    tile_row[:nt] = (uniq // nbc).astype(np.int32)
    tile_col[:nt] = (uniq % nbc).astype(np.int32)
    tile_of = np.searchsorted(uniq, key_s)
    slot = np.arange(key_s.size) - starts[tile_of]
    src = order
    rows[tile_of, slot] = (idx[src, 0] % TILE).astype(np.int8)
    cols[tile_of, slot] = (idx[src, 1] % TILE).astype(np.int8)
    v[tile_of, slot] = vals[src]
    return SparseTiledCOO(
        tile_row=jnp.asarray(tile_row), tile_col=jnp.asarray(tile_col),
        rows=jnp.asarray(rows), cols=jnp.asarray(cols), vals=jnp.asarray(v),
        n_tiles=jnp.asarray(nt, jnp.int32), shape=a.shape)
