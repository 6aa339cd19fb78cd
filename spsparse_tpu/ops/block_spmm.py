"""Block-sparse SpMM ``Y = A @ X`` over dense 128x128 blocks.

Layout (:class:`PreparedTiledDense`): the occupied 128x128 tiles of ``A``
stored dense and grouped by block row — ``blocks (nbr, Rt, 128, 128)``
with ``tcols (nbr, Rt)`` their block-column ids (sentinel ``nbc`` on
padding slots; live slots come first in each row). The tile *pattern*
stays sparse: only occupied tiles are stored and multiplied.

Two implementations with the same semantics:

* the plain form (:func:`block_spmm_xla`): gather the X tile of every
  stored block, then one batched contraction over (slot, column) per
  block row — the reference, and the path on every non-GPU backend;
* the Hopper kernel (Pallas, Triton route): one program per
  (64-row slab of a block row, RHS tile) loops over that row's stored
  blocks, with ``pl.dot`` accumulating in float32 registers. It never
  materializes the gathered X tiles in device memory.

The kernel runs for bf16 blocks on a GPU, where it beats the plain form
(tensor cores, f32 accumulation; it skips the gathered-tile round trip).
float32 blocks take the plain form everywhere: at full precision (no
TF32) Triton's dot runs on the CUDA cores and measured about 3x slower
than XLA's float32 contraction on an H200 (PERF.md). The gradient rule is
shared: two batched tile contractions plus one tile-granular
``segment_sum``, in plain XLA.
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
from ..core.errors import SpSparseError
from ..core.tiled import SparseTiledCOO, TILE

Array = Any

__all__ = ["PreparedTiledDense", "prepare_tiled_dense", "spmm_tiled_dense",
           "block_spmm_xla", "block_spmm_pallas", "dense_fill_threshold"]


def dense_fill_threshold(dtype) -> float:
    """Entries per occupied 128x128 tile at or above which
    ``prepare_general`` stores dense blocks instead of a row-gather
    layout. A dense tile costs a fixed 128x128xN contraction whatever its
    fill; the gather layouts cost one N-wide X row per entry. Measured
    crossover on an H200 (N=128, PERF.md): about 0.14 us per f32 tile and
    17-19 ns per bf16 tile against ~0.5 ns per gathered entry."""
    return 48.0 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) else 320.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedTiledDense:
    """Row-grouped dense-block layout: ``tcols (nbr, Rt)`` block-col ids
    (sentinel nbc), ``blocks (nbr, Rt, TILE, TILE)`` densified tiles
    (zero where no entry)."""

    tcols: Array = dataclasses.field(metadata=dict(static=False))
    blocks: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nbr(self) -> int:
        return self.tcols.shape[0]

    @property
    def tiles_per_row(self) -> int:
        return self.tcols.shape[1]

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // TILE)


def prepare_tiled_dense(tl: SparseTiledCOO,
                        dtype=jnp.float32, *,
                        host_limit_bytes: int = 8 << 30
                        ) -> PreparedTiledDense:
    """Densify a :class:`SparseTiledCOO` into per-block-row dense tiles
    (host-side, eager).

    ``dtype=jnp.bfloat16`` halves the A-block and X-tile traffic;
    products still accumulate in f32.

    ``host_limit_bytes`` bounds the host-side f32 staging of the dense
    blocks (the guard against feeding a genuinely sparse matrix into the
    dense layout); callers that know the fill is dense and the device
    copy fits pass a higher limit."""
    nt = int(tl.n_tiles)
    tr = np.asarray(tl.tile_row)[:nt]
    tc = np.asarray(tl.tile_col)[:nt]
    rows = np.asarray(tl.rows)[:nt].astype(np.int64)
    cols = np.asarray(tl.cols)[:nt].astype(np.int64)
    vals = np.asarray(tl.vals)[:nt].astype(np.float32)
    nbr, nbc = tl.nbrows, tl.nbcols

    counts = np.bincount(tr, minlength=nbr)
    Rt = max(int(counts.max(initial=1)), 1)
    est = nbr * Rt * TILE * TILE * 4
    if est > host_limit_bytes:
        raise SpSparseError(
            f"prepare_tiled_dense would materialize {est >> 30} GiB of "
            "dense blocks (nbr x Rt = {nbr} x {Rt}); this matrix belongs "
            "on a row-gather layout (prepare_general picks one "
            "automatically at low fill)".format(nbr=nbr, Rt=Rt))
    tcols = np.full((nbr, Rt), nbc, np.int32)
    blocks = np.zeros((nbr, Rt, TILE, TILE), np.float32)
    # Vectorized fill: slot within block row from the sorted tile-row
    # stream, then ONE scatter-add over every entry of every tile.
    # Padding entries carry value 0 at offset (0,0); add.at folds them in
    # harmlessly. Live duplicate offsets accumulate, matching
    # consolidate(ADD).
    slot = np.arange(nt) - np.searchsorted(tr, tr, side="left")
    tcols[tr, slot] = tc
    cap = rows.shape[1] if rows.ndim == 2 else 0
    if nt and cap:
        bt = np.repeat(tr, cap).reshape(nt, cap)
        st = np.repeat(slot, cap).reshape(nt, cap)
        np.add.at(blocks, (bt, st, rows, cols), vals)
    return PreparedTiledDense(tcols=jnp.asarray(tcols),
                              blocks=jnp.asarray(blocks).astype(dtype),
                              shape=tl.shape)


# --- plain form -------------------------------------------------------------


def block_spmm_xla(tcols: Array, blocks: Array, Xp: Array) -> Array:
    """Plain XLA block SpMM: ``Xp (nbc*TILE, N)`` -> ``(nbr*TILE, N)``
    float32. Gathers one X tile per stored block (zero on sentinel
    slots), then contracts over (slot, column) per block row."""
    nbr, Rt = tcols.shape
    N = Xp.shape[1]
    nbc = Xp.shape[0] // TILE
    valid = tcols < nbc
    Xt = jnp.take(Xp.reshape(nbc, TILE, N), jnp.minimum(tcols, nbc - 1),
                  axis=0)                                   # (nbr,Rt,T,N)
    Xt = jnp.where(valid[:, :, None, None], Xt, 0)
    y = jnp.einsum("btij,btjn->bin", blocks, Xt.astype(blocks.dtype),
                   precision=dot_precision(blocks.dtype),
                   preferred_element_type=jnp.float32)
    return y.reshape(nbr * TILE, N)


# --- Hopper kernel ----------------------------------------------------------


def _block_spmm_kernel(tcols_ref, nlive_ref, blocks_ref, x_ref, y_ref, *,
                       nbc: int, bm: int, bn: int, n_rhs_tiles: int,
                       precision):
    # One flat grid axis (a CUDA grid's y/z extents stop at 65535 block
    # rows); consecutive programs share a block row, so its blocks and X
    # tiles are re-read from L2, not from device memory.
    pid = pl.program_id(0)
    h = pid % (TILE // bm)                      # row slab of the block row
    j = (pid // (TILE // bm)) % n_rhs_tiles     # RHS tile
    b = pid // (TILE // bm * n_rhs_tiles)       # block row

    def body(t, acc):
        tc = tcols_ref[b, t]
        a = blocks_ref[b, t, pl.ds(h * bm, bm), :]                 # (bm, T)
        x = x_ref[pl.ds(jnp.minimum(tc, nbc - 1) * TILE, TILE),
                  pl.ds(j * bn, bn)]                               # (T, bn)
        d = pl.dot(a, x, precision=precision)
        return acc + jnp.where(tc < nbc, d, 0.0)

    # live slots come first in each row: loop only over the row's prefix
    acc = jax.lax.fori_loop(0, nlive_ref[b], body,
                            jnp.zeros((bm, bn), jnp.float32))
    y_ref[pl.ds(b * TILE + h * bm, bm), pl.ds(j * bn, bn)] = acc


@functools.partial(jax.jit, static_argnames=("bm", "bn", "interpret"))
def block_spmm_pallas(tcols: Array, blocks: Array, Xp: Array, *,
                      bm: int = 64, bn: int = 64,
                      interpret: bool = False) -> Array:
    """The Hopper block SpMM kernel on the padded operands of
    :func:`block_spmm_xla` (``Xp.shape[1]`` a multiple of ``bn``)."""
    nbr, Rt = tcols.shape
    nbc = Xp.shape[0] // TILE
    Np = Xp.shape[1]
    live = tcols < nbc
    slot = jax.lax.broadcasted_iota(jnp.int32, (nbr, Rt), 1)
    nlive = jnp.max(jnp.where(live, slot + 1, 0), axis=1).astype(jnp.int32)
    return pl.pallas_call(
        functools.partial(_block_spmm_kernel, nbc=nbc, bm=bm, bn=bn,
                          n_rhs_tiles=Np // bn,
                          precision=dot_precision(blocks.dtype)),
        out_shape=jax.ShapeDtypeStruct((nbr * TILE, Np), jnp.float32),
        grid=(nbr * (TILE // bm) * (Np // bn),),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="block_spmm",
    )(tcols, nlive, blocks, Xp.astype(blocks.dtype))


# --- dispatch + gradient ----------------------------------------------------
# Math: y3[b] = sum_t blocks[b,t] @ Xtile(tc[b,t]), so the backward is two
# batched (TILE,TILE,N) contractions plus one tile-granular segment_sum.


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _block_spmm_ad(tcols, blocks, Xp, use_kernel: bool, interpret: bool):
    if use_kernel:
        return block_spmm_pallas(tcols, blocks, Xp, interpret=interpret)
    return block_spmm_xla(tcols, blocks, Xp)


def _block_spmm_ad_fwd(tcols, blocks, Xp, use_kernel, interpret):
    y = _block_spmm_ad(tcols, blocks, Xp, use_kernel, interpret)
    return y, (tcols, blocks, Xp)


def _block_spmm_ad_bwd(use_kernel, interpret, res, g):
    tcols, blocks, Xp = res
    nbr, Rt = tcols.shape
    N = g.shape[1]
    nbc = Xp.shape[0] // TILE
    g3 = g.reshape(nbr, TILE, N).astype(jnp.float32)
    valid = tcols < nbc                                     # (nbr, Rt)
    tcc = jnp.minimum(tcols, nbc - 1)
    Xt = jnp.take(Xp.reshape(nbc, TILE, N), tcc.reshape(-1), axis=0)
    Xt = Xt.reshape(nbr, Rt, TILE, N).astype(jnp.float32)   # tile gathers
    prec = jax.lax.Precision.HIGHEST
    d_blocks = jnp.einsum("bin,btjn->btij", g3, Xt, precision=prec)
    d_blocks = jnp.where(valid[:, :, None, None], d_blocks, 0.0)
    bl = jnp.where(valid[:, :, None, None],
                   blocks.astype(jnp.float32), 0.0)
    d_Xt = jnp.einsum("btij,bin->btjn", bl, g3, precision=prec)
    seg = jnp.where(valid, tcols, nbc).reshape(-1)
    d_Xp = jax.ops.segment_sum(d_Xt.reshape(nbr * Rt, TILE, N), seg,
                               num_segments=nbc + 1)[:nbc]
    f0 = np.zeros(tcols.shape, jax.dtypes.float0)
    return (f0, d_blocks.astype(blocks.dtype),
            d_Xp.reshape(nbc * TILE, N).astype(Xp.dtype))


_block_spmm_ad.defvjp(_block_spmm_ad_fwd, _block_spmm_ad_bwd)


def spmm_tiled_dense(prep: PreparedTiledDense | SparseTiledCOO, X: Array, *,
                     interpret: bool = False) -> Array:
    """``Y = A @ X`` (float32) over the dense-block layout.

    The Hopper kernel runs where ``core.backend.runs_gpu_kernel`` says
    so (bf16 blocks on a GPU); otherwise the plain XLA form. ``interpret=True``
    runs the kernel in the Pallas interpreter on any backend (tests).
    Differentiable w.r.t. ``prep.blocks`` and ``X``."""
    if isinstance(prep, SparseTiledCOO):
        prep = prepare_tiled_dense(prep)
    X = jnp.asarray(X)
    K, N = X.shape
    nbc = prep.nbc
    use_kernel = interpret or runs_gpu_kernel(prep.blocks.dtype)
    # the kernel tiles the RHS in 64-wide slabs (a Triton dot needs every
    # operand dim >= 16); the plain form takes N as is
    Np = -(-N // 64) * 64 if use_kernel else N
    Xp = jnp.pad(X.astype(prep.blocks.dtype),
                 ((0, nbc * TILE - K), (0, Np - N)))
    y = _block_spmm_ad(prep.tcols, prep.blocks, Xp, use_kernel, interpret)
    return y[: prep.shape[0], :N]
