"""BSR (block sparse row) storage — dense blocks on the matrix units.

Mandated by the north star (BASELINE.json: "COO arrays plus CSR/BSR
views"); no reference counterpart. BSR stores a sparse pattern of *dense*
``bh x bw`` tiles. This is the format that turns SpMM into dense matmul
work: each stored tile contributes a ``(bh, bw) @ (bw, N)`` matmul, and with
``bw >= 128`` the right-hand gathers move full-lane-width contiguous chunks
instead of 1-row slivers — both the FLOP path and the memory path are then
hardware-shaped.

Layout: ``row_ptr (nbrows+1,)`` over block rows, ``bcols (nblocks_cap,)``
block-column ids (sentinel-padded), ``blocks (nblocks_cap, bh, bw)`` dense
tiles (zero-padded), plus the usual live-count scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .coo import SparseCOO, round_up_pow2
from .errors import SpSparseError

__all__ = ["SparseBSR", "to_bsr"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseBSR:
    row_ptr: Array = dataclasses.field(metadata=dict(static=False))
    bcols: Array = dataclasses.field(metadata=dict(static=False))
    blocks: Array = dataclasses.field(metadata=dict(static=False))
    nnz_blocks: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.blocks.shape[1], self.blocks.shape[2]

    @property
    def nbrows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nbcols(self) -> int:
        bw = self.blocks.shape[2]
        return -(-self.shape[1] // bw)

    @property
    def cap_blocks(self) -> int:
        return self.bcols.shape[0]

    def valid_mask(self) -> Array:
        return jnp.arange(self.cap_blocks, dtype=jnp.int32) < self.nnz_blocks

    def block_rows(self) -> Array:
        """Per-block block-row ids, derived from row_ptr."""
        return (jnp.searchsorted(
            self.row_ptr,
            jnp.arange(self.cap_blocks, dtype=self.row_ptr.dtype),
            side="right").astype(jnp.int32) - 1)

    def to_dense(self) -> Array:
        bh, bw = self.block_shape
        nr, nc = self.nbrows * bh, self.nbcols * bw
        dense = jnp.zeros((nr, nc), self.blocks.dtype)
        live = self.valid_mask()
        br = jnp.where(live, self.block_rows(), self.nbrows)
        bc = jnp.where(live, self.bcols, self.nbcols)
        # Scatter each tile; padding drops via out-of-range block ids.
        dense = dense.reshape(self.nbrows, bh, self.nbcols, bw)
        dense = dense.at[br, :, bc, :].add(
            jnp.where(live[:, None, None], self.blocks, 0), mode="drop")
        return dense.reshape(nr, nc)[: self.shape[0], : self.shape[1]]


def to_bsr(a: SparseCOO, block_shape: tuple[int, int] = (8, 128),
           *, cap_blocks: int | None = None) -> SparseBSR:
    """COO → BSR (host-side, eager): group entries into dense tiles."""
    if a.rank != 2:
        raise SpSparseError("to_bsr requires a rank-2 array")
    bh, bw = block_shape
    idx, vals = a.to_lists()
    idx = np.asarray(idx, np.int64).reshape(len(vals), 2)
    vals = np.asarray(vals)
    nbrows = -(-a.shape[0] // bh)
    nbcols = -(-a.shape[1] // bw)
    br, bc = idx[:, 0] // bh, idx[:, 1] // bw
    key = br * nbcols + bc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    nblocks = uniq.shape[0]
    if cap_blocks is None:
        cap_blocks = round_up_pow2(max(nblocks, 1))
    elif nblocks > cap_blocks:
        raise SpSparseError(f"cap_blocks={cap_blocks} < {nblocks}")

    blocks = np.zeros((cap_blocks, bh, bw), vals.dtype)
    bcols_a = np.full((cap_blocks,), nbcols, np.int32)
    block_of = np.searchsorted(uniq, key)
    np.add.at(blocks, (block_of, idx[:, 0] % bh, idx[:, 1] % bw), vals)
    bcols_a[:nblocks] = (uniq % nbcols).astype(np.int32)
    ubr = (uniq // nbcols).astype(np.int64)
    row_ptr = np.searchsorted(ubr, np.arange(nbrows + 1)).astype(np.int32)
    return SparseBSR(row_ptr=jnp.asarray(row_ptr),
                     bcols=jnp.asarray(bcols_a),
                     blocks=jnp.asarray(blocks),
                     nnz_blocks=jnp.asarray(nblocks, jnp.int32),
                     shape=a.shape)
