"""Tiled SpGEMM — block-structured sparse x sparse as dense tile products.

The general ESC SpGEMM (:mod:`spsparse_tpu.ops.multiply`) sorts every
elementary product. For matrices whose nonzeros cluster into a sparse
pattern of dense(ish) 128x128 tiles — regridding / conservative-
interpolation operators, banded products, mesh couplings — the product is
*block Gustavson*: match operand tiles on the contraction block index
(host-side, static pattern), multiply the matching 128x128 tile pairs,
and sum them into the (sparse) set of occupied output tiles. No
per-entry sort, no gather; the only data-dependent step is the final
(optional) extraction of nonzero entries back to COO.

    C = A @ B           pairs (ta, tb) with A.tile_col[ta] == B.tile_row[tb]
    C = A @ B^T         pairs (ta, tb) with A.tile_col[ta] == B.tile_col[tb]
    out tile of a pair: (A.tile_row, B.tile_col or B.tile_row)

Two device paths with identical semantics:

* :func:`spgemm_tiled_xla` — batched pair products + ``segment_sum``
  (the plain reference; writes the P x 128 x 128 product stream to
  device memory before reducing it);
* :func:`spgemm_tiled_pallas` — the Hopper pair kernel (Pallas, Triton
  route): one program per output-tile slab loops over its pairs, which
  the plan keeps contiguous, and accumulates in registers. It runs for
  bf16 blocks on a GPU; float32 blocks take the plain form, which
  measured about 3x faster at full precision on an H200 (PERF.md).

Duplicate semantics are consolidate(ADD) — block accumulation sums
everything — and exact zeros are dropped at COO extraction, matching the
reference multiply contract (``multiply_sparse.hpp:238-243``: zero dot
products are not emitted).  This module is this framework's own design;
the reference has no tiled/blocked counterpart to cite.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.backend import dot_precision, runs_gpu_kernel
from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import SpSparseError
from ..core.tiled import SparseTiledCOO, TILE, to_tiled

Array = Any

__all__ = ["TiledBlocks", "densify_tiled", "TiledGemmPlan",
           "plan_tiled_spgemm", "plan_pstart", "spgemm_tiled_xla",
           "spgemm_pairs_pallas", "spgemm_tiled_pallas", "spgemm_tiled",
           "tiled_blocks_to_coo"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TiledBlocks:
    """Sparse pattern of dense 128x128 blocks (flat layout).

    ``tile_row/tile_col (T,)`` int32 block coordinates; ``blocks
    (T, TILE, TILE)`` f32/bf16 dense blocks (zero-filled outside the
    stored entries and outside ``shape``). All ``T`` blocks are live,
    with one exception: an EMPTY input is represented as a single zero
    block at sentinel coordinates (= extents) so shapes stay static —
    consumers drop it (OOB scatters drop; the pair planner masks
    sentinels; to_prepared_dense filters ``tile_row < nbrows``).
    """

    tile_row: Array = dataclasses.field(metadata=dict(static=False))
    tile_col: Array = dataclasses.field(metadata=dict(static=False))
    blocks: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        return self.blocks.shape[0]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // TILE)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // TILE)

    def to_dense(self) -> Array:
        nr, nc = self.nbrows * TILE, self.nbcols * TILE
        dense = jnp.zeros((nr // TILE, nc // TILE, TILE, TILE),
                          jnp.promote_types(self.blocks.dtype, jnp.float32))
        dense = dense.at[self.tile_row, self.tile_col].add(
            self.blocks.astype(dense.dtype))
        dense = dense.transpose(0, 2, 1, 3).reshape(nr, nc)
        return dense[: self.shape[0], : self.shape[1]]

    def to_prepared_dense(self, dtype=None):
        """Row-grouped layout for the block SpMM (host-side, eager) —
        lets a tiled-SpGEMM result feed ``Y = C @ X`` directly without a
        COO round trip."""
        from .block_spmm import PreparedTiledDense
        tr = np.asarray(self.tile_row)
        tc = np.asarray(self.tile_col)
        blocks = np.asarray(self.blocks)
        nbr, nbc = self.nbrows, self.nbcols
        live = tr < nbr
        counts = np.bincount(tr[live], minlength=nbr)
        Rt = max(int(counts.max(initial=1)), 1)
        est = nbr * Rt * TILE * TILE * blocks.dtype.itemsize
        if est > 8 << 30:
            raise SpSparseError(
                f"to_prepared_dense would materialize {est >> 30} GiB of "
                f"row-grouped blocks (nbr x Rt = {nbr} x {Rt}); extract "
                "to COO and use a row-gather layout for such patterns")
        tcols = np.full((nbr, Rt), nbc, np.int32)
        out = np.zeros((nbr, Rt, TILE, TILE), blocks.dtype)
        # Vectorized fill (same slot-from-sorted-rows trick as
        # prepare_tiled_dense): group live tiles by block row with one
        # stable sort, then one fancy-indexed write per array.
        order = np.argsort(np.where(live, tr, nbr), kind="stable")
        order = order[: int(live.sum())]
        trs = tr[order]
        slot = np.arange(trs.size) - np.searchsorted(trs, trs, side="left")
        tcols[trs, slot] = tc[order]
        np.add.at(out, (trs, slot), blocks[order])
        prep = PreparedTiledDense(tcols=jnp.asarray(tcols),
                                  blocks=jnp.asarray(out),
                                  shape=self.shape)
        return prep if dtype is None else dataclasses.replace(
            prep, blocks=prep.blocks.astype(dtype))


def densify_tiled(tl: SparseTiledCOO, *, dtype=jnp.float32) -> TiledBlocks:
    """``SparseTiledCOO`` -> flat dense blocks (host-side, eager).

    Duplicate in-tile offsets accumulate (consolidate(ADD) semantics,
    same as :func:`to_tiled`'s contract).
    """
    nt = int(tl.n_tiles)
    tr = np.asarray(tl.tile_row)[:nt]
    tc = np.asarray(tl.tile_col)[:nt]
    rows = np.asarray(tl.rows)[:nt].astype(np.int64)
    cols = np.asarray(tl.cols)[:nt].astype(np.int64)
    vals = np.asarray(tl.vals)[:nt].astype(np.float32)
    blocks = np.zeros((max(nt, 1), TILE, TILE), np.float32)
    t_of = np.repeat(np.arange(max(nt, 1))[:nt], rows.shape[1] if nt else 0)
    np.add.at(blocks, (t_of, rows.reshape(-1), cols.reshape(-1)),
              vals.reshape(-1))
    if nt == 0:
        # Empty input still needs one (zero) block for static shapes; give
        # it SENTINEL coordinates (= extents) so plan_tiled_spgemm never
        # pairs it (a live-looking (0,0) filler used to generate spurious
        # pairs and register junk output tiles in the distributed
        # planner) and to_dense's scatter drops it (OOB indices drop).
        tr = np.asarray([tl.nbrows], np.int32)
        tc = np.asarray([tl.nbcols], np.int32)
    return TiledBlocks(tile_row=jnp.asarray(tr, jnp.int32),
                       tile_col=jnp.asarray(tc, jnp.int32),
                       blocks=jnp.asarray(blocks, dtype), shape=tl.shape)


@dataclasses.dataclass(frozen=True)
class TiledGemmPlan:
    """Static (host-side) pair plan for a tiled SpGEMM.

    ``pa/pb (P,)`` operand block indices, ``oid (P,)`` output-block index
    per pair (pairs sorted by ``oid``; each output block's pairs are
    contiguous), ``out_tile_row/out_tile_col (T_out,)`` output block
    coordinates (row-major sorted), ``transpose_b`` the contraction mode,
    ``out_shape`` the result extents.
    """

    pa: np.ndarray
    pb: np.ndarray
    oid: np.ndarray
    out_tile_row: np.ndarray
    out_tile_col: np.ndarray
    transpose_b: bool
    out_shape: tuple

    @property
    def n_pairs(self) -> int:
        return self.pa.shape[0]

    @property
    def n_out_tiles(self) -> int:
        return self.out_tile_row.shape[0]


def plan_tiled_spgemm(A: TiledBlocks, B: TiledBlocks, *,
                      transpose_b: bool = False) -> TiledGemmPlan:
    """Host-side pair matching on the static tile pattern.

    The plan depends only on the *pattern* (tile coordinates), so one plan
    serves any number of value updates under one compiled program.
    """
    atr = np.asarray(A.tile_row, np.int64)
    atc = np.asarray(A.tile_col, np.int64)
    btr = np.asarray(B.tile_row, np.int64)
    btc = np.asarray(B.tile_col, np.int64)
    if transpose_b:
        k_b, j_b = btc, btr
        inner_a, inner_b = A.shape[1], B.shape[1]
        out_shape = (A.shape[0], B.shape[0])
    else:
        k_b, j_b = btr, btc
        inner_a, inner_b = A.shape[1], B.shape[0]
        out_shape = (A.shape[0], B.shape[1])
    if inner_a != inner_b:
        raise SpSparseError(
            f"inner dimension mismatch: {inner_a} vs {inner_b} "
            "(reference raises via spsparse_error, "
            "multiply_sparse.hpp:172-174)")

    # Match A.tile_col == k_b via sort + searchsorted (host, numpy).
    # Sentinel-coordinate tiles (the empty-input fillers from
    # densify_tiled, coords = extents) must never pair — even with each
    # other — so mask them out of both sides of the join.
    nb_inner = -(-inner_a // TILE)
    atc = np.where(atc < nb_inner, atc, nb_inner + 1)
    k_b = np.where(k_b < nb_inner, k_b, nb_inner + 2)
    order_b = np.argsort(k_b, kind="stable")
    kb_s = k_b[order_b]
    lo = np.searchsorted(kb_s, atc, side="left")
    hi = np.searchsorted(kb_s, atc, side="right")
    cnt = hi - lo
    pa = np.repeat(np.arange(atr.shape[0]), cnt)
    if pa.size:
        within = np.arange(pa.size) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        pb = order_b[np.repeat(lo, cnt) + within]
    else:
        pb = np.zeros(0, np.int64)

    nbc_out = -(-out_shape[1] // TILE)
    out_key = atr[pa] * nbc_out + j_b[pb]
    order = np.argsort(out_key, kind="stable")
    pa, pb, out_key = pa[order], pb[order], out_key[order]
    uniq, oid = np.unique(out_key, return_inverse=True)
    # Serpentine pair order within each output-tile group: even groups
    # ascend by pa, odd groups descend. Adjacent groups of one output
    # block row draw pairs from the same A block row, so the boundary
    # pair often reuses the tile the previous group read last.
    if pa.size:
        pa_max = int(pa.max(initial=0)) + 1
        within = np.where(oid % 2 == 1, pa_max - 1 - pa, pa)
        sorder = np.lexsort((within, oid))
        pa, pb, oid = pa[sorder], pb[sorder], oid[sorder]
    return TiledGemmPlan(
        pa=pa.astype(np.int32), pb=pb.astype(np.int32),
        oid=oid.astype(np.int32),
        out_tile_row=(uniq // nbc_out).astype(np.int32),
        out_tile_col=(uniq % nbc_out).astype(np.int32),
        transpose_b=transpose_b, out_shape=out_shape)


def _pair_dot(a, b, transpose_b: bool):
    # bf16 operands accumulate in f32 (preferred_element_type); f32
    # operands multiply at full precision.
    prec = dot_precision(a.dtype)
    contract = ((1,), (1,)) if transpose_b else ((1,), (0,))
    return jax.lax.dot_general(
        a, b, dimension_numbers=(contract, ((), ())),
        preferred_element_type=jnp.float32, precision=prec)


@functools.partial(jax.jit, static_argnames=("transpose_b", "n_out"))
def _spgemm_tiled_xla(a_blocks, b_blocks, pa, pb, oid, *,
                      transpose_b: bool, n_out: int):
    prods = jax.vmap(lambda i, j: _pair_dot(
        a_blocks[i], b_blocks[j], transpose_b))(pa, pb)
    return jax.ops.segment_sum(prods, oid, num_segments=n_out)


def spgemm_tiled_xla(A: TiledBlocks, B: TiledBlocks,
                     plan: TiledGemmPlan) -> TiledBlocks:
    """Tiled SpGEMM via XLA batched matmul + block segment-sum."""
    if plan.n_pairs == 0:
        # Empty result: sentinel-coordinate filler block (see TiledBlocks
        # docstring) — a live-looking (0,0) zero tile would pollute the
        # pattern of downstream plans.
        return TiledBlocks(
            tile_row=jnp.asarray([-(-plan.out_shape[0] // TILE)], jnp.int32),
            tile_col=jnp.asarray([-(-plan.out_shape[1] // TILE)], jnp.int32),
            blocks=jnp.zeros((1, TILE, TILE), jnp.float32),
            shape=plan.out_shape)
    out = _spgemm_tiled_xla(A.blocks, B.blocks,
                            jnp.asarray(plan.pa), jnp.asarray(plan.pb),
                            jnp.asarray(plan.oid),
                            transpose_b=plan.transpose_b,
                            n_out=plan.n_out_tiles)
    return TiledBlocks(tile_row=jnp.asarray(plan.out_tile_row),
                       tile_col=jnp.asarray(plan.out_tile_col),
                       blocks=out, shape=plan.out_shape)


def _pair_kernel(pstart_ref, pa_ref, pb_ref, a_ref, b_ref, o_ref, *,
                 transpose_b: bool, bm: int, bn: int, precision):
    # One flat grid axis over (row slab, column slab, output tile); the
    # program loops over its output tile's pairs (contiguous in plan
    # order) and keeps the running product in float32 registers, so each
    # output slab is written once and no per-pair product reaches memory.
    pid = pl.program_id(0)
    h = pid % (TILE // bm)
    w = (pid // (TILE // bm)) % (TILE // bn)
    t = pid // ((TILE // bm) * (TILE // bn))

    def body(p, acc):
        a = a_ref[pa_ref[p], pl.ds(h * bm, bm), :]            # (bm, T)
        if transpose_b:
            b = b_ref[pb_ref[p], pl.ds(w * bn, bn), :]        # (bn, T)
        else:
            b = b_ref[pb_ref[p], :, pl.ds(w * bn, bn)]        # (T, bn)
        return acc + pl.dot(a, b, trans_b=transpose_b, precision=precision)

    acc = jax.lax.fori_loop(pstart_ref[t], pstart_ref[t + 1], body,
                            jnp.zeros((bm, bn), jnp.float32))
    o_ref[t, pl.ds(h * bm, bm), pl.ds(w * bn, bn)] = acc


@functools.partial(jax.jit, static_argnames=(
    "transpose_b", "n_out", "bm", "bn", "interpret"))
def spgemm_pairs_pallas(a_blocks, b_blocks, pstart, pa, pb, *,
                        transpose_b: bool, n_out: int, bm: int = 64,
                        bn: int = 128, interpret: bool = False):
    """The Hopper pair kernel: ``(n_out, TILE, TILE)`` float32 output
    blocks, output tile ``t`` summing the products of pairs
    ``pstart[t]:pstart[t+1]`` (see :func:`plan_pstart`)."""
    b_blocks = b_blocks.astype(a_blocks.dtype)
    return pl.pallas_call(
        functools.partial(_pair_kernel, transpose_b=transpose_b, bm=bm,
                          bn=bn, precision=dot_precision(a_blocks.dtype)),
        out_shape=jax.ShapeDtypeStruct((n_out, TILE, TILE), jnp.float32),
        grid=(n_out * (TILE // bm) * (TILE // bn),),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="spgemm_pairs",
    )(pstart, pa, pb, a_blocks, b_blocks)


def plan_pstart(plan: TiledGemmPlan) -> np.ndarray:
    """Per-output-tile pair ranges: ``pstart[t] .. pstart[t+1]`` indexes
    the pairs of output tile ``t`` (``oid`` is sorted/grouped by plan
    construction)."""
    return np.searchsorted(plan.oid,
                           np.arange(plan.n_out_tiles + 1)).astype(np.int32)


def spgemm_tiled_pallas(A: TiledBlocks, B: TiledBlocks,
                        plan: TiledGemmPlan, *,
                        interpret: bool = False) -> TiledBlocks:
    """Tiled SpGEMM via the Hopper pair kernel: each output tile's pairs
    are consumed in plan order, operand tiles are read once per pair,
    and each output tile is stored once."""
    if plan.n_pairs == 0:
        return spgemm_tiled_xla(A, B, plan)
    out = spgemm_pairs_pallas(A.blocks, B.blocks,
                              jnp.asarray(plan_pstart(plan)),
                              jnp.asarray(plan.pa), jnp.asarray(plan.pb),
                              transpose_b=plan.transpose_b,
                              n_out=plan.n_out_tiles, interpret=interpret)
    return TiledBlocks(tile_row=jnp.asarray(plan.out_tile_row),
                       tile_col=jnp.asarray(plan.out_tile_col),
                       blocks=out, shape=plan.out_shape)


def tiled_blocks_to_coo(tb: TiledBlocks, *, cap: int | None = None,
                        nnz_cap: int | None = None) -> SparseCOO:
    """Extract nonzero entries of a block-tiled result into (unsorted) COO.

    Exact zeros are dropped (reference contract: zero products are not
    emitted, ``multiply_sparse.hpp:238-243``).  ``cap`` is the static
    output capacity; when None it is computed eagerly from the concrete
    nonzero count (host sync).
    """
    blocks = tb.blocks.astype(jnp.float32)
    if cap is None and nnz_cap is not None:
        cap = nnz_cap
    if cap is None:
        cap = round_up_pow2(max(int(jnp.sum(blocks != 0)), 1))
    # Compact with one sort: pack (dead-flag, position) into ONE integer
    # key (a sort's cost grows with its operand count), then gather the
    # cap surviving values by position.
    flat = blocks.reshape(-1)
    nel = flat.shape[0]
    use64 = nel >= (1 << 30)
    if use64 and not jax.config.jax_enable_x64:
        raise SpSparseError(
            "tiled_blocks_to_coo: >=2^30 block slots needs x64 enabled "
            "for the packed extraction key")
    kdt = jnp.int64 if use64 else jnp.int32
    dead_bump = jnp.asarray(nel if use64 else (1 << 30), kdt)
    key = jnp.arange(nel, dtype=kdt) + jnp.where(flat != 0, 0, dead_bump)
    key_c = jax.lax.sort((key,), num_keys=1)[0][:cap]
    if cap > nel:
        key_c = jnp.pad(key_c, (0, cap - nel), constant_values=0)
    pos_c = jnp.where(key_c >= dead_bump, key_c - dead_bump, key_c)
    vals_c = flat[pos_c]
    n_sel = jnp.sum(flat != 0).astype(jnp.int32)
    # Clamp so nnz <= cap always holds even when an explicit static cap
    # undercounts (the compaction truncates the entry list; an unclamped
    # count would mark padding slots live downstream).
    nnz = jnp.minimum(n_sel, jnp.asarray(cap, n_sel.dtype)).astype(jnp.int32)
    live = jnp.arange(cap) < nnz
    t = (pos_c // (TILE * TILE)).astype(jnp.int32)
    rc = pos_c % (TILE * TILE)
    r = (rc // TILE).astype(jnp.int32)
    c = (rc % TILE).astype(jnp.int32)
    idx_dtype = SparseCOO.empty(tb.shape, 1).index_dtype
    rows = tb.tile_row[t].astype(idx_dtype) * TILE + r
    cols = tb.tile_col[t].astype(idx_dtype) * TILE + c
    sent = jnp.asarray(SparseCOO.sentinel_index(tb.shape, idx_dtype))
    idx = jnp.stack([jnp.where(live, rows, sent[0]),
                     jnp.where(live, cols, sent[1])], axis=1)
    vals = jnp.where(live, vals_c, 0)
    return SparseCOO(indices=idx.astype(idx_dtype), vals=vals, nnz=nnz,
                     shape=tb.shape)


def spgemm_tiled(A: SparseCOO, B: SparseCOO, *, transpose_b: bool = False,
                 dtype=jnp.float32, use_pallas: bool | None = None,
                 cap: int | None = None,
                 interpret: bool = False) -> SparseCOO:
    """``C = A @ B^(T?)`` via the tiled path (eager convenience).

    Tiling, densification, and pair planning run host-side; the block
    products run on device.  Result is an *unsorted* COO (consolidated
    values, zeros dropped); call ``.consolidate()`` for a sorted result.
    For matrices without block structure (entries scattered so each
    128x128 tile holds only a few) prefer the ESC path
    (:func:`spsparse_tpu.ops.spgemm.spgemm`) — densified tiles would
    waste ``64KB/tile`` of traffic on mostly-zero blocks.

    ``use_pallas=None`` runs the Hopper pair kernel for bf16 blocks on a
    GPU and the plain XLA form otherwise; ``interpret=True`` runs the
    kernel in the Pallas interpreter."""
    if use_pallas is None:
        use_pallas = interpret or runs_gpu_kernel(dtype)
    ta = densify_tiled(to_tiled(A), dtype=dtype)
    tbk = densify_tiled(to_tiled(B), dtype=dtype)
    plan = plan_tiled_spgemm(ta, tbk, transpose_b=transpose_b)
    if use_pallas:
        out = spgemm_tiled_pallas(ta, tbk, plan, interpret=interpret)
    else:
        out = spgemm_tiled_xla(ta, tbk, plan)
    return tiled_blocks_to_coo(out, cap=cap)
