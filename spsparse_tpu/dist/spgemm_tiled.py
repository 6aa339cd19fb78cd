"""Distributed tiled SpGEMM — ring-rotated B blocks, block matmuls.

Scales :mod:`spsparse_tpu.ops.spgemm_tiled` across a device mesh: A is
row-partitioned (device ``p`` owns row block ``p``), B is row-partitioned
too (for ``C = A @ B^T`` device ``q``'s B rows are C's column block
``q``). B's dense tiles rotate around the ring via ``ppermute``; at step
``s`` device ``p`` multiplies its A tiles against the resident block
``q = (p + s) % P`` using the host-precomputed pair plan for ``(p, q)``
and accumulates into its local output tiles. Communication totals one
rotation of B's tiles; compute is batched 128x128 matmuls
(no per-product sort — the ESC ring variant's final sort+merge is
replaced by block segment-sums).

All per-device/per-step plans are padded to global maxima so every
device runs one program: pair slots beyond a step's real count target a
trash output slot (index ``Tout_max``), and tile-pad blocks are zero so
they contribute nothing. This module is this framework's own design; the
reference is single-process (SURVEY §2 explicit statement).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from ..core.tiled import TILE, to_tiled
from ..ops.spgemm_tiled import TiledBlocks, densify_tiled, plan_tiled_spgemm

__all__ = ["plan_dist_spgemm_tiled", "dist_spgemm_tiled",
           "DistTiledGemmPlan"]

Array = Any


@dataclasses.dataclass(frozen=True)
class DistTiledGemmPlan:
    """Host-side plan: padded per-device block stacks + per-(device, step)
    pair tables.

    ``a_blocks (Pn, Ta, T, T)``, ``a_valid``; ``b_blocks (Pn, Tb, T, T)``;
    ``pa/pb/oid (Pn, S, Pmax)`` pair tables (trash slot = Tout);
    ``out_tile_row/col (Pn, Tout)`` global coordinates of each device's
    output tiles (sentinel-padded); ``out_shape`` the global C extents.
    """

    a_blocks: np.ndarray
    b_blocks: np.ndarray
    pa: np.ndarray
    pb: np.ndarray
    oid: np.ndarray
    out_tile_row: np.ndarray
    out_tile_col: np.ndarray
    out_shape: tuple
    rows_local: int

    @property
    def n_parts(self) -> int:
        return self.a_blocks.shape[0]

    @property
    def n_out_tiles(self) -> int:
        return self.out_tile_row.shape[1]


def _part_tiled(a: SparseCOO, n_parts: int) -> list[TiledBlocks]:
    """Split rows into ``n_parts`` blocks of whole 128-tiles and tile each
    part locally (host-side, eager)."""
    nrows = a.shape[0]
    n_block_tiles = -(-nrows // TILE)
    tiles_per_part = -(-n_block_tiles // n_parts)
    rows_local = tiles_per_part * TILE
    idx, vals = a.to_lists()
    idx = np.asarray(idx, np.int64).reshape(len(vals), 2)
    vals_np = np.asarray(vals)
    parts = []
    for p in range(n_parts):
        r0, r1 = p * rows_local, min((p + 1) * rows_local, nrows)
        m = (idx[:, 0] >= r0) & (idx[:, 0] < r1)
        li = np.stack([idx[m, 0] - r0, idx[m, 1]], 1)
        part = SparseCOO.from_arrays(
            li.astype(np.int64) if li.size else np.zeros((0, 2), np.int64),
            vals_np[m], (rows_local, a.shape[1]), check=False)
        parts.append(densify_tiled(to_tiled(part)))
    return parts


def plan_dist_spgemm_tiled(A: SparseCOO, B: SparseCOO, n_parts: int, *,
                           transpose_b: bool = True) -> DistTiledGemmPlan:
    """Host-side planning for ``C = A @ B^(T?)`` over ``n_parts`` devices.

    Only ``transpose_b=True`` (the Gram/regridding form, where B's row
    blocks are C's column blocks) is supported; for ``A @ B`` partition B
    by rows of ``B^T`` (i.e. columns) and pass the transpose.
    """
    if not transpose_b:
        raise SpSparseError(
            "dist_spgemm_tiled supports transpose_b=True; for A @ B pass "
            "B pre-transposed (its column blocks are C's column blocks)")
    if A.shape[1] != B.shape[1]:
        raise SpSparseError(
            f"inner dimension mismatch: {A.shape[1]} vs {B.shape[1]}")
    a_parts = _part_tiled(A, n_parts)
    b_parts = _part_tiled(B, n_parts)
    rows_local = a_parts[0].shape[0]
    rows_local_b = b_parts[0].shape[0]
    Ta = max(p.n_tiles for p in a_parts)
    Tb = max(p.n_tiles for p in b_parts)

    a_blocks = np.zeros((n_parts, Ta, TILE, TILE), np.float32)
    b_blocks = np.zeros((n_parts, Tb, TILE, TILE), np.float32)
    for p in range(n_parts):
        a_blocks[p, : a_parts[p].n_tiles] = np.asarray(a_parts[p].blocks)
        b_blocks[p, : b_parts[p].n_tiles] = np.asarray(b_parts[p].blocks)

    # Per (p, q) pair plans in *local* block indices; per-device output
    # tile registry keyed by the *global* out tile coordinate.
    out_shape = (A.shape[0], B.shape[0])
    nbc_out = -(-(n_parts * rows_local_b) // TILE)
    raw = {}
    out_keys = [dict() for _ in range(n_parts)]
    pmax = 1
    for p in range(n_parts):
        row_off = p * (rows_local // TILE)
        for s in range(n_parts):
            q = (p + s) % n_parts
            plan = plan_tiled_spgemm(a_parts[p], b_parts[q],
                                     transpose_b=True)
            # local->global: A part p's row tiles offset by row_off; B
            # part q's block rows are C's column tiles offset by
            # q * rows_local_b / TILE.
            col_off = q * (rows_local_b // TILE)
            keyed = []
            reg = out_keys[p]
            for k in range(plan.n_pairs):
                tr = int(plan.out_tile_row[plan.oid[k]]) + row_off
                tc = int(plan.out_tile_col[plan.oid[k]]) + col_off
                key = tr * nbc_out + tc
                if key not in reg:
                    reg[key] = len(reg)
                keyed.append((int(plan.pa[k]), int(plan.pb[k]), reg[key]))
            raw[(p, s)] = keyed
            pmax = max(pmax, len(keyed))
    tout = max(max((len(r) for r in out_keys), default=1), 1)

    pa = np.zeros((n_parts, n_parts, pmax), np.int32)
    pb = np.zeros((n_parts, n_parts, pmax), np.int32)
    oid = np.full((n_parts, n_parts, pmax), tout, np.int32)  # trash slot
    for (p, s), keyed in raw.items():
        for k, (ia, ib, io) in enumerate(keyed):
            pa[p, s, k], pb[p, s, k], oid[p, s, k] = ia, ib, io
    otr = np.full((n_parts, tout), -(-out_shape[0] // TILE), np.int32)
    otc = np.full((n_parts, tout), nbc_out, np.int32)
    for p in range(n_parts):
        for key, slot in out_keys[p].items():
            otr[p, slot] = key // nbc_out
            otc[p, slot] = key % nbc_out
    return DistTiledGemmPlan(
        a_blocks=a_blocks, b_blocks=b_blocks, pa=pa, pb=pb, oid=oid,
        out_tile_row=otr, out_tile_col=otc, out_shape=out_shape,
        rows_local=rows_local)


def dist_spgemm_tiled(plan: DistTiledGemmPlan, mesh: Mesh,
                      axis: str = "x") -> TiledBlocks:
    """Execute a :func:`plan_dist_spgemm_tiled` plan over ``mesh``.

    Returns the result as global :class:`TiledBlocks` (gathered; callers
    at scale keep per-device slices — the per-device layout is the first
    axis of the pre-gather buffers).
    """
    nparts = plan.n_parts
    if mesh.shape[axis] != nparts:
        raise SpSparseError(
            f"plan built for {nparts} parts, mesh axis has "
            f"{mesh.shape[axis]}")
    Tout = plan.n_out_tiles
    Pmax = plan.pa.shape[2]

    def local_fn(a_blk, b_blk, pa, pb, oid):
        a_blk, b_blk = a_blk[0], b_blk[0]
        pa, pb, oid = pa[0], pb[0], oid[0]
        perm = [(i, (i - 1) % nparts) for i in range(nparts)]
        out = jnp.zeros((Tout + 1, TILE, TILE), jnp.float32)
        for s in range(nparts):
            prods = jax.vmap(
                lambda i, j: jax.lax.dot_general(
                    a_blk[i], b_blk[j],
                    dimension_numbers=((((1,), (1,))), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
            )(pa[s], pb[s])
            out = out + jax.ops.segment_sum(prods, oid[s],
                                            num_segments=Tout + 1)
            if s + 1 < nparts:
                b_blk = jax.lax.ppermute(b_blk, axis, perm)
        return out[None, :Tout]

    fn = jax.shard_map(local_fn, mesh=mesh, in_specs=(P(axis),) * 5,
                       out_specs=P(axis))
    out = fn(jnp.asarray(plan.a_blocks), jnp.asarray(plan.b_blocks),
             jnp.asarray(plan.pa), jnp.asarray(plan.pb),
             jnp.asarray(plan.oid))
    return TiledBlocks(
        tile_row=jnp.asarray(plan.out_tile_row.reshape(-1)),
        tile_col=jnp.asarray(plan.out_tile_col.reshape(-1)),
        blocks=out.reshape(-1, TILE, TILE), shape=plan.out_shape)
