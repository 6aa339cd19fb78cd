"""prepare_general / spmm_general / spmv_general — the packed, kernel-
dispatched path for unstructured matrices (ops.general)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder, SpSparseError
from spsparse_tpu.ops import (best_spmv, prepare_general, spmm_general,
                              spmv_general)


def random_coo(rng, shape, nnz):
    b = CooBuilder(shape, dtype=np.float32)
    idx = np.stack([rng.integers(0, s, size=nnz) for s in shape], axis=1)
    b.add_many(idx, rng.uniform(-1, 1, size=nnz).astype(np.float32))
    return b.build()


def local_coo(rng, m, k, spread=64):
    """Column-local (regridding-style) — lands on the dense-block kernel."""
    b = CooBuilder((m, 2 * m), dtype=np.float32)
    r = np.repeat(np.arange(m), k)
    c = np.clip(r * 2 + rng.integers(-spread, spread + 1, r.size),
                0, 2 * m - 1)
    b.add_many(np.stack([r, c], 1),
               rng.uniform(-1, 1, r.size).astype(np.float32))
    return b.build()


class TestPrepareGeneral:
    def test_kernel_choice_by_fill(self, rng):
        # Post-packing fill decides. A small scattered matrix packs WELL
        # (few block rows -> columns cluster -> high fill -> tiled); the
        # gather regime needs many block rows sharing scattered columns
        # (lambda ~ 1 entry/column), where packing can't raise fill.
        packable = random_coo(rng, (512, 8192), 2000)
        assert prepare_general(packable).kernel in ("dense_block",
                                                    "gather_ell", "gather")
        scattered = random_coo(rng, (4096, 32768), 32768)
        assert prepare_general(scattered).kernel in ("gather", "gather_ell")
        dense_ish = local_coo(rng, 512, 50)                # fill >> 64
        assert prepare_general(dense_ish).kernel == "dense_block"
        # mid fill (40 entries in each diagonal tile, below the
        # dense-block threshold): a row-gather layout
        bld = CooBuilder((512, 512), dtype=np.float32)
        for blk in range(4):
            r = blk * 128 + np.arange(40)
            bld.add_many(np.stack([r, r], 1),
                         rng.uniform(-1, 1, 40).astype(np.float32))
        assert prepare_general(bld.build()).kernel in ("gather",
                                                       "gather_ell")

    def test_gather_layout_matches_dense_and_grads(self, rng):
        import jax
        A = random_coo(rng, (4096, 32768), 32768)
        pg = prepare_general(A)
        # bounded row lengths route to the ELL reduce
        assert pg.kernel == "gather_ell" and pg.order is None
        X = rng.uniform(-1, 1, (A.shape[1], 16)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X))
        Ad = np.asarray(A.to_dense())
        np.testing.assert_allclose(np.asarray(Y), Ad @ X, rtol=1e-4,
                                   atol=1e-5)
        g = jax.grad(lambda Xc: jnp.sum(spmm_general(pg, Xc) ** 2))(
            jnp.asarray(X))
        ref = 2.0 * Ad.T @ (Ad @ X)
        np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-3,
                                   atol=1e-4)

    @pytest.mark.parametrize("maker,nnz", [("scattered", 2000),
                                           ("local", None)])
    def test_spmm_matches_dense(self, rng, maker, nnz):
        A = (random_coo(rng, (384, 1024), nnz) if maker == "scattered"
             else local_coo(rng, 384, 40))
        pg = prepare_general(A)
        X = rng.uniform(-1, 1, (A.shape[1], 128)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X), interpret=True)
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=1e-4, atol=1e-4)

    def test_spmv_and_best_spmv_dispatch(self, rng):
        A = local_coo(rng, 256, 30)
        pg = prepare_general(A)
        x = rng.uniform(-1, 1, A.shape[1]).astype(np.float32)
        y1 = spmv_general(pg, jnp.asarray(x), interpret=True)
        y2 = best_spmv(pg, jnp.asarray(x))
        ref = np.asarray(A.to_dense()) @ x
        np.testing.assert_allclose(np.asarray(y1), ref, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(y2), ref, rtol=1e-4,
                                   atol=1e-4)

    def test_no_pack_skips_gather(self, rng):
        A = random_coo(rng, (128, 512), 400)
        pg = prepare_general(A, pack=False)
        assert pg.order is None      # identity: no X gather at all
        X = rng.uniform(-1, 1, (512, 4)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X), interpret=True)
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=1e-4, atol=1e-4)

    def test_bf16_with_low_fill_routes_ell(self, rng):
        # Shared columns across many row blocks keep fill low even after
        # packing -> gather regime. Bounded rows take the ELL layout,
        # which HONORS the bf16 request (vals stored bf16, f32
        # accumulate) instead of warning.
        A = random_coo(rng, (2048, 16384), 16384)
        pg = prepare_general(A, dtype=jnp.bfloat16)
        assert pg.kernel == "gather_ell"
        assert pg.prep.vals.dtype == jnp.bfloat16
        X = rng.uniform(-1, 1, (A.shape[1], 16)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X))
        ref = np.asarray(A.to_dense()) @ X
        rel = np.abs(np.asarray(Y) - ref).max() / np.abs(ref).max()
        assert rel < 2e-2

    def test_long_tailed_rows_keep_entry_list(self, rng):
        # one row with a huge count blows the ELL padding bound ->
        # entry-list + segment_sum layout, with the bf16 warning intact
        b = CooBuilder((1024, 8192), dtype=np.float32)
        hot = np.stack([np.zeros(3000, np.int64),
                        rng.integers(0, 8192, 3000)], 1)
        cold = np.stack([rng.integers(1, 1024, 1000),
                         rng.integers(0, 8192, 1000)], 1)
        b.add_many(np.concatenate([hot, cold]),
                   rng.uniform(-1, 1, 4000).astype(np.float32))
        A = b.build()
        with pytest.warns(UserWarning, match="row-gather"):
            pg = prepare_general(A, dtype=jnp.bfloat16)
        assert pg.kernel == "gather"
        X = rng.uniform(-1, 1, (A.shape[1], 8)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=1e-4, atol=1e-4)

    def test_bf16_mode(self, rng):
        A = local_coo(rng, 256, 40)
        pg = prepare_general(A, dtype=jnp.bfloat16)
        assert pg.kernel == "dense_block"
        X = rng.uniform(-1, 1, (A.shape[1], 64)).astype(np.float32)
        Y = spmm_general(pg, jnp.asarray(X), interpret=True)
        np.testing.assert_allclose(np.asarray(Y),
                                   np.asarray(A.to_dense()) @ X,
                                   rtol=2e-2, atol=2e-2)

    def test_inner_mismatch_raises(self, rng):
        pg = prepare_general(random_coo(rng, (64, 128), 100))
        with pytest.raises(SpSparseError):
            spmm_general(pg, jnp.zeros((64, 4)))


class TestBestSpmm:
    def test_routes_every_format(self, rng):
        from spsparse_tpu.core.bsr import to_bsr
        from spsparse_tpu.core.dia import to_dia
        from spsparse_tpu.core.tiled import to_tiled
        from spsparse_tpu.ops import best_spmm
        from spsparse_tpu import to_csr

        # banded matrix representable in every format
        n = 96
        b = CooBuilder((n, n), dtype=np.float32)
        for off in (-1, 0, 2):
            r = np.arange(max(0, -off), min(n, n - off))
            b.add_many(np.stack([r, r + off], 1),
                       rng.uniform(-1, 1, r.size).astype(np.float32))
        A = b.build()
        X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
        ref = np.asarray(A.to_dense()) @ X
        for conv in (to_csr, to_dia, to_tiled,
                     lambda a: to_bsr(a, (8, 8)),
                     prepare_general):
            Y = best_spmm(conv(A), jnp.asarray(X))
            np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-4,
                                       atol=1e-4, err_msg=str(conv))
