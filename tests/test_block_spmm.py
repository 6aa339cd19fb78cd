"""The Hopper block SpMM kernel (ops.block_spmm) in the Pallas interpreter
against its plain XLA form and the dense oracle, and its gradient rule
against ``jax.grad`` of the plain form."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu.core.tiled import TILE
from spsparse_tpu.ops.block_spmm import (PreparedTiledDense,
                                         block_spmm_pallas, block_spmm_xla,
                                         spmm_tiled_dense)


def _layout(rng, nbr, nbc, pattern, dtype=jnp.float32):
    """Hand-built dense-block layout: ``pattern[b]`` lists row b's slots
    (block-column ids, ``None`` = sentinel slot)."""
    Rt = max(len(p) for p in pattern)
    tcols = np.full((nbr, Rt), nbc, np.int32)
    blocks = np.zeros((nbr, Rt, TILE, TILE), np.float32)
    for b, row in enumerate(pattern):
        for t, c in enumerate(row):
            if c is not None:
                tcols[b, t] = c
                blocks[b, t] = rng.uniform(-1, 1, (TILE, TILE))
    return jnp.asarray(tcols), jnp.asarray(blocks, dtype)


def _dense(tcols, blocks, nbc):
    tc = np.asarray(tcols)
    bl = np.asarray(blocks, np.float64)
    A = np.zeros((tc.shape[0] * TILE, nbc * TILE))
    for b in range(tc.shape[0]):
        for t in range(tc.shape[1]):
            if tc[b, t] < nbc:
                A[b * TILE:(b + 1) * TILE,
                  tc[b, t] * TILE:(tc[b, t] + 1) * TILE] += bl[b, t]
    return A


@pytest.mark.parametrize("case", [
    # (name, nbr, nbc, pattern, N, dtype, bm, bn)
    ("one_block", 1, 1, [[0]], 64, jnp.float32, 64, 64),
    ("n_over_128", 2, 3, [[0, 2], [1]], 192, jnp.float32, 64, 64),
    ("empty_rows", 3, 2, [[], [1, 0], []], 64, jnp.float32, 64, 64),
    ("sentinel_mid_row", 2, 3, [[0, None, 2], [None, 1]], 64, jnp.float32,
     64, 64),
    ("repeat_column", 1, 2, [[1, 1, 0]], 64, jnp.float32, 64, 64),
    ("bf16", 2, 2, [[0, 1], [1]], 64, jnp.bfloat16, 64, 64),
    ("bf16_wide_slab", 2, 2, [[1], [0, 1]], 128, jnp.bfloat16, 64, 128),
    ("full_tile_slab", 2, 2, [[0], [1, 0]], 128, jnp.float32, 128, 128),
    ("thin_slab", 1, 3, [[2, 0]], 64, jnp.float32, 32, 64),
])
def test_kernel_matches_plain_and_dense(rng, case):
    name, nbr, nbc, pattern, N, dt, bm, bn = case
    tcols, blocks = _layout(rng, nbr, nbc, pattern, dt)
    Xp = jnp.asarray(rng.uniform(-1, 1, (nbc * TILE, N)), dt)
    yk = block_spmm_pallas(tcols, blocks, Xp, bm=bm, bn=bn, interpret=True)
    yp = block_spmm_xla(tcols, blocks, Xp)
    assert yk.dtype == yp.dtype == jnp.float32
    assert yk.shape == (nbr * TILE, N)
    # same operands and f32 accumulation; only the summation order differs
    np.testing.assert_allclose(np.asarray(yk), np.asarray(yp), rtol=1e-5,
                               atol=1e-4)
    ref = _dense(tcols, blocks, nbc) @ np.asarray(Xp, np.float64)
    np.testing.assert_allclose(np.asarray(yk), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,N", [(300, 410, 7), (129, 257, 65),
                                   (128, 128, 1)])
def test_wrapper_pads_and_trims(rng, m, k, N):
    """Partial edge tiles and any RHS width: the wrapper pads X to whole
    tiles (and 64-wide RHS slabs for the kernel) and trims Y."""
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.core.tiled import to_tiled
    b = CooBuilder((m, k), dtype=np.float32)
    rr = np.repeat(np.arange(m), 5)
    b.add_many(np.stack([rr, rng.integers(0, k, rr.size)], 1),
               rng.uniform(-1, 1, rr.size).astype(np.float32))
    A = b.build()
    X = rng.uniform(-1, 1, (k, N)).astype(np.float32)
    ref = np.asarray(A.to_dense(), np.float64) @ X
    for interpret in (False, True):
        Y = spmm_tiled_dense(to_tiled(A), jnp.asarray(X),
                             interpret=interpret)
        assert Y.shape == (m, N)
        np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_gradient_rule_matches_grad_of_plain_form(rng, dt):
    """The custom VJP (shared by kernel and plain form) equals
    ``jax.grad`` of the plain XLA form, including on sentinel slots."""
    tcols, blocks = _layout(rng, 2, 3, [[0, None, 2], [1]], dt)
    prep = PreparedTiledDense(tcols=tcols, blocks=blocks,
                              shape=(2 * TILE - 5, 3 * TILE - 9))
    X = jnp.asarray(rng.uniform(-1, 1, (prep.shape[1], 24)), jnp.float32)
    W = jnp.asarray(rng.uniform(-1, 1, (prep.shape[0], 24)), jnp.float32)

    def loss(bl, Xc, interpret):
        p = dataclasses.replace(prep, blocks=bl)
        return jnp.sum(W * spmm_tiled_dense(p, Xc, interpret=interpret))

    def loss_plain(bl, Xc):
        Xp = jnp.pad(Xc.astype(bl.dtype),
                     ((0, prep.nbc * TILE - Xc.shape[0]), (0, 0)))
        y = block_spmm_xla(tcols, bl, Xp)[:prep.shape[0]]
        return jnp.sum(W * y)

    gr = jax.grad(loss_plain, argnums=(0, 1))(blocks, X)
    # bf16 cotangents round to 8 mantissa bits on the way out
    tol = 2e-2 if dt == jnp.bfloat16 else 1e-5
    for interpret in (False, True):
        gk = jax.grad(loss, argnums=(0, 1))(blocks, X, interpret)
        for a, b in zip(gk, gr):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32),
                                       rtol=tol, atol=tol)
