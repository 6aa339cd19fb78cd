"""Compiled (non-interpret) checks of the Hopper kernels and the fused DIA
path on the card, each against its plain XLA form or a float64 oracle."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _regrid(rng, m, k=50, spread=128):
    from spsparse_tpu import SparseCOO
    rr = np.repeat(np.arange(m), k)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size),
                 0, 2 * m - 1)
    vv = rng.uniform(-1, 1, rr.size).astype(np.float32)
    return SparseCOO.from_arrays(np.stack([rr, cc], 1), vv, (m, 2 * m),
                                 check=False), (rr, cc, vv)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("bm,bn", [(64, 64), (128, 64), (64, 128)])
def test_block_kernel_compiled_matches_plain(gpu, rng, bm, bn):
    from spsparse_tpu.core.tiled import TILE
    from spsparse_tpu.ops import prepare_general
    from spsparse_tpu.ops.block_spmm import block_spmm_pallas, block_spmm_xla
    A, _ = _regrid(rng, 1 << 14)
    pg = prepare_general(A, dtype=jnp.bfloat16)
    assert pg.kernel == "dense_block"
    p = pg.prep
    X = jnp.asarray(rng.uniform(-1, 1, (p.nbc * TILE, 128)), jnp.bfloat16)
    yk = block_spmm_pallas(p.tcols, p.blocks, X, bm=bm, bn=bn)
    yp = block_spmm_xla(p.tcols, p.blocks, X)
    assert _rel(yk, yp) < 1e-5          # same bf16 operands, f32 sums


def test_best_spmm_routes_bf16_to_kernel_f32_to_plain(gpu, rng):
    import scipy.sparse as sps
    from spsparse_tpu.ops import best_spmm, prepare_general, spmm_route
    A, (rr, cc, vv) = _regrid(rng, 1 << 14)
    X = rng.uniform(-1, 1, (A.shape[1], 96)).astype(np.float32)
    ref = sps.csr_matrix((vv.astype(np.float64), (rr, cc)),
                         shape=A.shape) @ X.astype(np.float64)
    for dt, route, tol in ((jnp.bfloat16, "block_pallas", 2e-2),
                           (jnp.float32, "block_xla", 1e-5)):
        pg = prepare_general(A, dtype=dt)
        assert spmm_route(pg) == route
        assert _rel(best_spmm(pg, X), ref) < tol


def test_block_gradient_compiled(gpu, rng):
    import dataclasses
    from spsparse_tpu.core.tiled import TILE
    from spsparse_tpu.ops import best_spmm, prepare_general
    from spsparse_tpu.ops.block_spmm import block_spmm_xla
    A, _ = _regrid(rng, 1 << 12)
    pg = prepare_general(A, pack=False)
    X = jnp.asarray(rng.uniform(-1, 1, (A.shape[1], 64)), jnp.float32)
    W = jnp.asarray(rng.uniform(-1, 1, (A.shape[0], 64)), jnp.float32)

    def loss(bl, Xc):
        p = dataclasses.replace(pg, prep=dataclasses.replace(pg.prep,
                                                             blocks=bl))
        return jnp.sum(W * best_spmm(p, Xc))

    def loss_plain(bl, Xc):
        Xp = jnp.pad(Xc, ((0, pg.prep.nbc * TILE - Xc.shape[0]), (0, 0)))
        return jnp.sum(W * block_spmm_xla(pg.prep.tcols, bl, Xp)[
            :A.shape[0]])

    g = jax.grad(loss, argnums=(0, 1))(pg.prep.blocks, X)
    r = jax.grad(loss_plain, argnums=(0, 1))(pg.prep.blocks, X)
    for a, b in zip(g, r):
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("transpose_b", [True, False])
def test_pair_kernel_compiled_matches_plain(gpu, rng, transpose_b):
    from spsparse_tpu.core.tiled import to_tiled
    from spsparse_tpu.ops.spgemm_tiled import (densify_tiled,
                                               plan_tiled_spgemm,
                                               spgemm_tiled_pallas,
                                               spgemm_tiled_xla)
    A, _ = _regrid(rng, 1 << 12, k=8, spread=16)
    B = A if transpose_b else A.transposed((1, 0))
    for dt in (jnp.bfloat16, jnp.float32):
        ta = densify_tiled(to_tiled(A), dtype=dt)
        tb = densify_tiled(to_tiled(B), dtype=dt)
        plan = plan_tiled_spgemm(ta, tb, transpose_b=transpose_b)
        yk = spgemm_tiled_pallas(ta, tb, plan).blocks
        yp = spgemm_tiled_xla(ta, tb, plan).blocks
        assert _rel(yk, yp) < 1e-5


def test_dia_spmv_is_one_fusion_and_spmm_exact(gpu, rng):
    # The single-vector product compiles to one loop fusion. The 8-RHS
    # product does not yet: XLA copies each diagonal row out before the
    # fused sum (PERF.md), so only its result is checked here.
    from spsparse_tpu.core.dia import SparseDIA
    from spsparse_tpu.ops import best_spmm, best_spmv
    n = 1 << 20
    offs = tuple(range(-5, 6))
    data = rng.uniform(-1, 1, (len(offs), n)).astype(np.float32)
    dia = SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))
    x = jnp.asarray(rng.uniform(-1, 1, n), jnp.float32)
    X = jnp.asarray(rng.uniform(-1, 1, (n, 8)), jnp.float32)
    txt = jax.jit(best_spmv).lower(dia, x).compile().as_text()
    assert len(re.findall(r"= \S+ fusion\(", txt)) == 1
    for f, arg in ((best_spmv, x), (best_spmm, X)):
        xh = np.asarray(arg, np.float64)
        ref = np.zeros(xh.shape)
        for k, off in enumerate(offs):
            lo, hi = max(0, -off), min(n, n - off)
            d = data[k, lo:hi].reshape((-1,) + (1,) * (xh.ndim - 1))
            ref[lo:hi] += d * xh[lo + off:hi + off]
        assert _rel(f(dia, arg), ref) < 1e-5
