"""BSR view + block SpMM tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from spsparse_tpu import CooBuilder
from spsparse_tpu.core.bsr import to_bsr
from spsparse_tpu.ops.spmm import spmm, spmm_bsr


def random_coo(rng, shape, nnz):
    b = CooBuilder(shape, dtype=np.float64)
    idx = np.stack([rng.integers(0, s, size=nnz) for s in shape], axis=1)
    b.add_many(idx, rng.uniform(-1, 1, size=nnz))
    return b.build()


class TestBsr:
    def test_round_trip(self, rng):
        A = random_coo(rng, (37, 300), 120)
        bsr = to_bsr(A, (8, 128))
        np.testing.assert_allclose(np.asarray(bsr.to_dense()),
                                   np.asarray(A.to_dense()), rtol=1e-12)

    def test_duplicates_summed(self):
        b = CooBuilder((8, 128), dtype=np.float64)
        b.add((2, 3), 1.0)
        b.add((2, 3), 2.0)
        bsr = to_bsr(b.build(), (8, 128))
        assert np.asarray(bsr.to_dense())[2, 3] == 3.0

    def test_spmm_matches_dense(self, rng):
        A = random_coo(rng, (40, 260), 200)
        X = rng.uniform(-1, 1, (260, 16))
        bsr = to_bsr(A, (8, 128))
        y = spmm_bsr(bsr, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ X, rtol=1e-12)

    def test_spmm_dispatch(self, rng):
        A = random_coo(rng, (16, 256), 64)
        X = rng.uniform(-1, 1, (256, 8))
        bsr = to_bsr(A, (8, 128))
        y = spmm(bsr, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ X, rtol=1e-12)

    def test_uneven_tail_blocks(self, rng):
        # shape not a multiple of the block shape in either dimension
        A = random_coo(rng, (13, 131), 50)
        bsr = to_bsr(A, (8, 128))
        X = rng.uniform(-1, 1, (131, 4))
        y = spmm_bsr(bsr, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(A.to_dense()) @ X, rtol=1e-12)
