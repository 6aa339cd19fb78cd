"""Tiled one-hot COO format tests (the plain reference of the tiled COO
format)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder
from spsparse_tpu.core.tiled import to_tiled
from spsparse_tpu.ops.tiled_ops import spmv_tiled, spmm_tiled
from spsparse_tpu import SpSparseError


def random_coo(rng, shape, nnz):
    b = CooBuilder(shape, dtype=np.float32)
    idx = np.stack([rng.integers(0, s, size=nnz) for s in shape], axis=1)
    b.add_many(idx, rng.uniform(-1, 1, size=nnz).astype(np.float32))
    return b.build()


class TestTiledFormat:
    def test_round_trip(self, rng):
        A = random_coo(rng, (300, 450), 2000)
        tl = to_tiled(A)
        np.testing.assert_allclose(np.asarray(tl.to_dense()),
                                   np.asarray(A.to_dense()), rtol=1e-6)

    def test_duplicates_sum(self):
        b = CooBuilder((10, 10), dtype=np.float32)
        b.add((3, 4), 1.0)
        b.add((3, 4), 2.0)
        tl = to_tiled(b.build())
        assert np.asarray(tl.to_dense())[3, 4] == pytest.approx(3.0)

    def test_spmv_matches_dense(self, rng):
        A = random_coo(rng, (520, 260), 4000)
        tl = to_tiled(A)
        x = rng.uniform(-1, 1, 260).astype(np.float32)
        y = spmv_tiled(tl, x)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ x,
                                   rtol=2e-4, atol=2e-4)

    def test_spmm_matches_dense(self, rng):
        A = random_coo(rng, (260, 520), 4000)
        tl = to_tiled(A)
        X = rng.uniform(-1, 1, (520, 16)).astype(np.float32)
        Y = spmm_tiled(tl, X)
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=2e-4, atol=2e-4)

    def test_under_jit(self, rng):
        A = random_coo(rng, (200, 200), 1500)
        tl = to_tiled(A)
        x = jnp.asarray(rng.uniform(-1, 1, 200).astype(np.float32))
        y = jax.jit(spmv_tiled)(tl, x)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ np.asarray(x),
                                   rtol=2e-4, atol=2e-4)

    def test_dim_mismatch(self, rng):
        A = random_coo(rng, (100, 100), 50)
        tl = to_tiled(A)
        with pytest.raises(SpSparseError):
            spmv_tiled(tl, np.ones(99, np.float32))

    def test_cap_overflow_raises(self, rng):
        A = random_coo(rng, (100, 100), 500)
        with pytest.raises(SpSparseError):
            to_tiled(A, tile_cap=1)


class TestPackColumns:
    def test_reduces_tiles_and_preserves_products(self, rng):
        from spsparse_tpu.core.tiled import pack_columns
        # Scattered columns: each 128-row block touches ~64 random column
        # blocks at fill ~16 -> packing must concentrate them.
        m, k = 1024, 8
        A = random_coo(rng, (m, 8192), m * k)
        Ap, order = pack_columns(A)
        tl0, tl1 = to_tiled(A), to_tiled(Ap)
        # 512 -> ~300 on this distribution (entries in columns owned by
        # another row block still scatter; a permutation cannot fix those).
        assert int(tl1.n_tiles) <= int(tl0.n_tiles) * 0.65
        X = rng.uniform(-1, 1, (8192, 4)).astype(np.float32)
        Y = spmm_tiled(tl1, jnp.asarray(X)[order])
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=1e-4, atol=1e-4)

    def test_spmv_and_pallas_kernel_agree(self, rng):
        from spsparse_tpu.core.tiled import pack_columns
        from spsparse_tpu.ops.block_spmm import spmm_tiled_dense
        A = random_coo(rng, (256, 2048), 1500)
        Ap, order = pack_columns(A)
        tl = to_tiled(Ap)
        x = rng.uniform(-1, 1, 2048).astype(np.float32)
        y = spmv_tiled(tl, jnp.asarray(x)[order])
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ x,
                                   rtol=1e-4, atol=1e-4)
        X = rng.uniform(-1, 1, (2048, 128)).astype(np.float32)
        Yk = spmm_tiled_dense(tl, jnp.asarray(X)[order], interpret=True)
        np.testing.assert_allclose(np.asarray(Yk),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=1e-4, atol=1e-4)

    def test_identity_on_already_local(self, rng):
        from spsparse_tpu.core.tiled import pack_columns
        # Block-diagonal matrix: already optimally packed; permutation must
        # not increase the tile count.
        b = CooBuilder((512, 512), dtype=np.float32)
        i = np.arange(512)
        b.add_many(np.stack([i, i], 1), np.ones(512, np.float32))
        A = b.build()
        Ap, order = pack_columns(A)
        assert int(to_tiled(Ap).n_tiles) <= int(to_tiled(A).n_tiles)

    def test_untouched_columns_and_empty(self, rng):
        from spsparse_tpu.core.tiled import pack_columns
        b = CooBuilder((64, 640), dtype=np.float32)
        b.add((0, 639), 2.0)
        A = b.build()
        Ap, order = pack_columns(A)
        assert np.asarray(order).shape == (640,)
        # touched column moves to the front group
        assert int(np.asarray(order)[0]) == 639
        np.testing.assert_allclose(np.asarray(Ap.to_dense())[0, 0], 2.0)
        empty = CooBuilder((16, 16), dtype=np.float32).build()
        Ae, oe = pack_columns(empty)
        np.testing.assert_array_equal(np.asarray(oe), np.arange(16))
