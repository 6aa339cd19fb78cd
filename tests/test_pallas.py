"""Structured-layout SpMV/SpMM tests: the fused DIA path, the block SpMM
(Hopper kernel in the Pallas interpreter, and its plain XLA form), the
dispatch, and their gradients. The compiled kernels run in tests_gpu/."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder, to_csr


def random_csr(rng, n, m, nnz):
    b = CooBuilder((n, m), dtype=np.float32)
    idx = np.stack([rng.integers(0, n, nnz), rng.integers(0, m, nnz)], 1)
    b.add_many(idx, rng.uniform(-1, 1, nnz).astype(np.float32))
    return b.build(), to_csr(b.build())


def _dense_of_dia(data, offsets, n, m=None):
    """Differentiable dense matrix of DIA ``data`` (rows i, cols i+off)."""
    m = n if m is None else m
    dense = jnp.zeros((n, m), jnp.float32)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, m - off)
        idx = jnp.arange(lo, hi)
        dense = dense.at[idx, idx + off].set(data[k, lo:hi])
    return dense


class TestMrhsDia:
    """Multi-RHS banded products: ``best_spmm`` on a ``SparseDIA`` reads
    each diagonal once for all columns."""

    def test_matches_dense(self, rng):
        from spsparse_tpu.core.dia import to_dia
        from spsparse_tpu.ops import best_spmm
        n = 2000
        b = CooBuilder((n, n), dtype=np.float32)
        for off in (-2, 0, 1, 3):
            r = np.arange(max(0, -off), min(n, n - off))
            b.add_many(np.stack([r, r + off], 1),
                       rng.uniform(-1, 1, r.size).astype(np.float32))
        A = b.build()
        X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
        Y = best_spmm(to_dia(A), X)
        ref = np.asarray(A.to_dense()) @ X
        np.testing.assert_allclose(np.asarray(Y), ref, rtol=2e-5, atol=2e-5)

    def test_too_many_rhs_raises(self, rng):
        # the fused path has no RHS limit: 9 (formerly rejected) and 33
        # right-hand sides both run and match the dense product
        from spsparse_tpu.core.dia import to_dia
        from spsparse_tpu.ops import best_spmm
        b = CooBuilder((64, 64), dtype=np.float32)
        b.add((0, 0), 1.0)
        b.add((5, 7), 2.0)
        A = b.build()
        for R in (9, 33):
            X = rng.uniform(-1, 1, (64, R)).astype(np.float32)
            np.testing.assert_allclose(
                np.asarray(best_spmm(to_dia(A), X)),
                np.asarray(A.to_dense()) @ X, rtol=1e-6, atol=1e-6)


def _banded_dia(rng, n, offsets, dtype=np.float32, m=None):
    from spsparse_tpu.core.dia import SparseDIA
    m = n if m is None else m
    offs = np.asarray(offsets)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < m)
    vals = np.where(valid, rng.uniform(-1, 1, (n, offs.size)), 0).astype(dtype)
    return SparseDIA(data=jnp.asarray(vals.T.copy()),
                     offsets=tuple(int(o) for o in offs), shape=(n, m))


class TestDiaStreamingKernel:
    """The fused DIA expression (``spmv_dia``): shifted static windows of
    one padded ``x``, summed over diagonals."""

    def test_matches_dense_odd_n(self, rng):
        from spsparse_tpu.ops import spmv_dia
        n = 1000  # odd sizes: exercises padding + trim
        dia = _banded_dia(rng, n, [-3, -1, 0, 2, 5])
        x = rng.uniform(-1, 1, n).astype(np.float32)
        y = spmv_dia(dia, x)
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(dia.to_dense()) @ x, rtol=2e-5,
            atol=2e-5)

    def test_large_offsets_cross_pad_boundary(self, rng):
        from spsparse_tpu.ops import spmv_dia
        n = 2048
        dia = _banded_dia(rng, n, [-300, -129, -128, 0, 127, 128, 301])
        x = rng.uniform(-1, 1, n).astype(np.float32)
        y = spmv_dia(dia, x)
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(dia.to_dense()) @ x, rtol=2e-5,
            atol=2e-5)

    def test_bf16_data_path(self, rng):
        from spsparse_tpu.ops import prepare_dia, spmv_dia
        n = 512
        dia = _banded_dia(rng, n, [-2, 0, 1])
        prep = prepare_dia(dia, dtype=jnp.bfloat16)
        assert prep.data.dtype == jnp.bfloat16
        x = rng.uniform(-1, 1, n).astype(np.float32)
        y = spmv_dia(prep, x)
        assert y.dtype == jnp.float32          # accumulates in f32
        ref = np.asarray(dia.to_dense()).astype(np.float32) @ x
        # bf16 diagonals: ~3 significant digits per term, 3 terms/row
        np.testing.assert_allclose(np.asarray(y), ref, rtol=2e-2, atol=2e-2)

    def test_prepared_reuse_matches_one_off(self, rng):
        from spsparse_tpu.ops import best_spmv, prepare_dia
        n = 384
        dia = _banded_dia(rng, n, [-1, 0, 1])
        prep = prepare_dia(dia)
        x = rng.uniform(-1, 1, n).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(best_spmv(dia, x)),
                                      np.asarray(best_spmv(prep, x)))

    @pytest.mark.parametrize("n,m,offsets", [
        (300, 500, (-2, 0, 7, 250)),      # wide
        (500, 300, (-250, -1, 0, 3)),     # tall
        (64, 64, (-100, 0, 100)),         # out-of-range diagonals skipped
        (1, 1, (0,)),
    ])
    def test_rectangular_and_degenerate(self, rng, n, m, offsets):
        from spsparse_tpu.ops import spmv_dia
        dia = _banded_dia(rng, n, offsets, m=m)
        for x in (rng.uniform(-1, 1, m).astype(np.float32),
                  rng.uniform(-1, 1, (m, 3)).astype(np.float32)):
            np.testing.assert_allclose(
                np.asarray(spmv_dia(dia, x)),
                np.asarray(dia.to_dense()) @ x, rtol=2e-5, atol=2e-5)

    def test_out_of_range_data_is_masked(self, rng):
        # garbage (even NaN) stored outside the matrix must not leak in
        from spsparse_tpu.core.dia import SparseDIA
        from spsparse_tpu.ops import prepare_dia, spmv_dia
        n = 16
        data = np.ones((3, n), np.float32)
        data[0, 0] = np.nan           # row 0 of offset -1: col -1
        data[2, n - 1] = np.inf       # last row of offset +1: col n
        dia = SparseDIA(data=jnp.asarray(data), offsets=(-1, 0, 1),
                        shape=(n, n))
        x = np.ones(n, np.float32)
        ref = np.full(n, 3.0)
        ref[0] = ref[-1] = 2.0
        np.testing.assert_array_equal(np.asarray(spmv_dia(dia, x)), ref)
        assert np.isfinite(np.asarray(prepare_dia(dia).data)).all()

    def test_float64_stays_float64(self, rng):
        from spsparse_tpu.ops import spmv_dia
        dia = _banded_dia(rng, 200, (-1, 0, 1), dtype=np.float64)
        x = rng.uniform(-1, 1, 200)
        y = spmv_dia(dia, x)
        assert y.dtype == jnp.float64
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(dia.to_dense()) @ x,
                                   rtol=1e-13, atol=1e-13)


class TestBestSpmvDispatch:
    """``best_spmv`` must route every operand type to a correct
    implementation."""

    def _oracle(self, dense, x):
        return np.asarray(dense) @ np.asarray(x)

    def test_dia_operand(self, rng):
        from spsparse_tpu.ops.spmv_kernels import best_spmv
        dia = _banded_dia(rng, 200, [-1, 0, 3])
        x = rng.uniform(-1, 1, 200).astype(np.float32)
        np.testing.assert_allclose(np.asarray(best_spmv(dia, x)),
                                   self._oracle(dia.to_dense(), x),
                                   rtol=1e-5, atol=1e-5)

    def test_prepared_dia_operand(self, rng):
        from spsparse_tpu.ops import prepare_dia
        from spsparse_tpu.ops.spmv_kernels import best_spmv
        dia = _banded_dia(rng, 256, [-2, 0, 1])
        prep = prepare_dia(dia)
        x = rng.uniform(-1, 1, 256).astype(np.float32)
        np.testing.assert_allclose(np.asarray(best_spmv(prep, x)),
                                   self._oracle(dia.to_dense(), x),
                                   rtol=2e-5, atol=2e-5)

    def test_ell_csr_coo_operands(self, rng):
        from spsparse_tpu.core.structure import to_ell
        from spsparse_tpu.ops.spmv_kernels import best_spmv
        A, csr = random_csr(rng, 120, 90, 700)
        x = rng.uniform(-1, 1, 90).astype(np.float32)
        ref = self._oracle(A.to_dense(), x)
        for op in (A, csr, to_ell(csr)):
            np.testing.assert_allclose(np.asarray(best_spmv(op, x)), ref,
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=str(type(op)))


class TestTiledDenseKernel:
    """Dense-block SpMM: the Hopper kernel in the Pallas interpreter and
    the plain XLA form, against the dense oracle."""

    def _mat(self, rng, m=300, k=410, K=7):
        from spsparse_tpu import CooBuilder
        rr = np.repeat(np.arange(m), K)
        cc = rng.integers(0, k, rr.size)
        b = CooBuilder((m, k), dtype=np.float32)
        b.add_many(np.stack([rr, cc], 1),
                   rng.uniform(-1, 1, rr.size).astype(np.float32))
        return b.build()

    def test_matches_dense_oracle(self, rng):
        from spsparse_tpu.core.tiled import to_tiled
        from spsparse_tpu.ops.block_spmm import spmm_tiled_dense
        A = self._mat(rng)
        X = rng.uniform(-1, 1, (410, 64)).astype(np.float32)
        Y = np.asarray(spmm_tiled_dense(to_tiled(A), jnp.asarray(X),
                                        interpret=True))
        ref = np.asarray(A.to_dense()) @ X
        np.testing.assert_allclose(Y, ref, atol=5e-5)

    def test_bf16_blocks_f32_accumulate(self, rng):
        # Mixed bf16/f32 mode: blocks and X stream in bf16, products
        # accumulate in f32.
        from spsparse_tpu.core.tiled import to_tiled
        from spsparse_tpu.ops.block_spmm import (prepare_tiled_dense,
                                                 spmm_tiled_dense)
        A = self._mat(rng, m=200, k=300, K=9)
        prep = prepare_tiled_dense(to_tiled(A), dtype=jnp.bfloat16)
        assert prep.blocks.dtype == jnp.bfloat16
        X = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
        Y = np.asarray(spmm_tiled_dense(prep, jnp.asarray(X),
                                        interpret=True))
        assert Y.dtype == np.float32
        ref = np.asarray(A.to_dense()) @ X
        # bf16 inputs: ~3 decimal digits; 9-term dots stay within ~1%.
        np.testing.assert_allclose(Y, ref, rtol=0.03, atol=0.03)

    def test_duplicate_offsets_accumulate(self):
        from spsparse_tpu.core.coo import SparseCOO
        from spsparse_tpu.core.tiled import to_tiled
        from spsparse_tpu.ops.block_spmm import prepare_tiled_dense
        idx = np.array([[1, 2], [1, 2], [0, 0]], np.int32)
        A = SparseCOO.from_arrays(idx, np.array([2.0, 3.0, 1.0], np.float32),
                                  (4, 4))
        prep = prepare_tiled_dense(to_tiled(A))
        blk = np.asarray(prep.blocks)[0, 0]
        assert blk[1, 2] == 5.0 and blk[0, 0] == 1.0

    def test_wide_row_guard(self, rng):
        # No block-row width limit any more (the kernel keeps one block
        # at a time): a row of 40 stored blocks runs and matches.
        from spsparse_tpu.ops.block_spmm import (PreparedTiledDense,
                                                 spmm_tiled_dense)
        Rt = 40
        blocks = rng.uniform(-1, 1, (1, Rt, 128, 128)).astype(np.float32)
        prep = PreparedTiledDense(
            tcols=jnp.arange(Rt, dtype=jnp.int32)[None, :],
            blocks=jnp.asarray(blocks), shape=(128, Rt * 128))
        X = rng.uniform(-1, 1, (Rt * 128, 8)).astype(np.float32)
        Y = spmm_tiled_dense(prep, jnp.asarray(X), interpret=True)
        ref = np.concatenate(list(blocks[0]), axis=1) @ X
        np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-4,
                                   atol=1e-4)


class TestKernelAutodiff:
    """Gradients through the structured paths: the fused DIA expression
    (plain autodiff) and the block SpMM's custom VJP, against a
    differentiable jnp reimplementation of the same math."""

    def test_dia_spmv_grads_match_xla(self, rng):
        from spsparse_tpu.core.dia import SparseDIA
        from spsparse_tpu.ops import spmv_dia
        n = 300
        dia = _banded_dia(rng, n, (-7, -1, 0, 2, 130))
        x = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))
        w = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))

        def loss_fused(data, xc):
            d = SparseDIA(data=data, offsets=dia.offsets, shape=dia.shape)
            return jnp.vdot(w, spmv_dia(d, xc))

        def loss_ref(data, xc):
            return jnp.vdot(w, _dense_of_dia(data, dia.offsets, n) @ xc)

        gk = jax.grad(loss_fused, argnums=(0, 1))(dia.data, x)
        gr = jax.grad(loss_ref, argnums=(0, 1))(dia.data, x)
        # the fused path zeroes out-of-matrix slots of d_data; so does the
        # dense form (those slots never reach a dense entry)
        np.testing.assert_allclose(gk[0], gr[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gk[1], gr[1], rtol=1e-5, atol=1e-6)

    def test_dia_spmv_grad_under_jit(self, rng):
        from spsparse_tpu.ops import best_spmv, prepare_dia
        n = 200
        dia = _banded_dia(rng, n, (-1, 0, 1))
        prep = prepare_dia(dia)
        x = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))

        @jax.jit
        def g(xc):
            return jax.grad(lambda v: jnp.sum(best_spmv(prep, v) ** 2))(xc)

        Ad = np.asarray(dia.to_dense())
        y = Ad @ np.asarray(x)
        ref = 2.0 * Ad.T @ y
        np.testing.assert_allclose(g(x), ref, rtol=1e-4, atol=1e-5)

    def test_mrhs_grads_match_dense(self, rng):
        from spsparse_tpu.core.dia import SparseDIA
        from spsparse_tpu.ops import best_spmm
        n = 260
        dia = _banded_dia(rng, n, (-2, 0, 3))
        X = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        W = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))

        def loss_fused(data, Xc):
            d = SparseDIA(data=data, offsets=dia.offsets, shape=dia.shape)
            return jnp.sum(W * best_spmm(d, Xc))

        def loss_ref(data, Xc):
            return jnp.sum(W * (_dense_of_dia(data, dia.offsets, n) @ Xc))

        gk = jax.grad(loss_fused, argnums=(0, 1))(dia.data, X)
        gr = jax.grad(loss_ref, argnums=(0, 1))(dia.data, X)
        np.testing.assert_allclose(gk[0], gr[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gk[1], gr[1], rtol=1e-5, atol=1e-6)

    @staticmethod
    def _tiled_prep(rng):
        from spsparse_tpu.core.tiled import to_tiled
        from spsparse_tpu.ops.block_spmm import prepare_tiled_dense
        n, m, nnz = 300, 400, 600
        b = CooBuilder((n, m), dtype=np.float32)
        idx = np.stack([rng.integers(0, n, nnz), rng.integers(0, m, nnz)], 1)
        b.add_many(idx, rng.uniform(-1, 1, nnz).astype(np.float32))
        A = b.build().consolidate((0, 1))
        return A, prepare_tiled_dense(to_tiled(A))

    def test_tiled_dense_grads_match_padded_ref(self, rng):
        # the Hopper kernel (interpret mode) under the shared gradient rule
        self._check_tiled_dense_grads(rng, interpret=True)

    def test_tiled_dense_plain_grads_match_padded_ref(self, rng):
        self._check_tiled_dense_grads(rng, interpret=False)

    def _check_tiled_dense_grads(self, rng, interpret):
        import dataclasses
        from spsparse_tpu.core.tiled import TILE
        from spsparse_tpu.ops.block_spmm import spmm_tiled_dense
        A, prep = self._tiled_prep(rng)
        N = 16
        X = jnp.asarray(rng.uniform(-1, 1, (A.shape[1], N))
                        .astype(np.float32))
        W = jnp.asarray(rng.uniform(-1, 1, (A.shape[0], N))
                        .astype(np.float32))
        nbr, Rt = prep.tcols.shape
        nbc = prep.nbc

        def loss_kernel(blocks, Xc):
            p = dataclasses.replace(prep, blocks=blocks)
            return jnp.sum(W * spmm_tiled_dense(p, Xc, interpret=interpret))

        def loss_ref(blocks, Xc):
            Xp = jnp.pad(Xc, ((0, nbc * TILE - Xc.shape[0]), (0, 0)))
            y = jnp.zeros((nbr * TILE, N), jnp.float32)
            tc = np.asarray(prep.tcols)
            for b_ in range(nbr):
                for t in range(Rt):
                    if tc[b_, t] >= nbc:
                        continue
                    xt = Xp[tc[b_, t] * TILE:(tc[b_, t] + 1) * TILE]
                    y = y.at[b_ * TILE:(b_ + 1) * TILE].add(
                        jnp.matmul(blocks[b_, t], xt,
                                   precision=jax.lax.Precision.HIGHEST))
            return jnp.sum(W * y[: A.shape[0]])

        gk = jax.grad(loss_kernel, argnums=(0, 1))(prep.blocks, X)
        gr = jax.grad(loss_ref, argnums=(0, 1))(prep.blocks, X)
        np.testing.assert_allclose(gk[0], gr[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gk[1], gr[1], rtol=1e-5, atol=1e-6)

    def test_grad_through_spmm_general_and_best_spmv(self, rng):
        from spsparse_tpu.ops import best_spmv, prepare_dia, prepare_general
        from spsparse_tpu.ops.general import spmm_general
        A, _ = self._tiled_prep(rng)
        pg = prepare_general(A)
        X = jnp.asarray(rng.uniform(-1, 1, (A.shape[1], 8))
                        .astype(np.float32))
        g = jax.grad(lambda Xc: jnp.sum(
            spmm_general(pg, Xc, interpret=True) ** 2))(X)
        Ad = np.asarray(A.to_dense())
        ref = 2.0 * Ad.T @ (Ad @ np.asarray(X))
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-5)

        dia = _banded_dia(rng, 256, (-1, 0, 1))
        prep = prepare_dia(dia)
        x = jnp.asarray(rng.uniform(-1, 1, 256).astype(np.float32))
        gx = jax.grad(lambda v: jnp.sum(best_spmv(prep, v) ** 2))(x)
        Dd = np.asarray(dia.to_dense())
        refx = 2.0 * Dd.T @ (Dd @ np.asarray(x))
        np.testing.assert_allclose(gx, refx, rtol=1e-4, atol=1e-5)


class TestMrhsDiaFastPath:
    """Multi-RHS DIA through ``best_spmm``: block-multiple and ragged row
    counts, single-column agreement, and gradients."""

    def _dia(self, rng, n):
        from spsparse_tpu.core.dia import to_dia
        b = CooBuilder((n, n), dtype=np.float32)
        for off in (-2, -1, 0, 1, 2):
            r = np.arange(max(0, -off), min(n, n - off))
            b.add_many(np.stack([r, r + off], 1),
                       rng.uniform(-1, 1, r.size).astype(np.float32))
        return to_dia(b.build())

    def test_fast_path_matches_dense(self, rng):
        from spsparse_tpu.ops import best_spmm
        n = 1024
        dia = self._dia(rng, n)
        X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
        Y = best_spmm(dia, X)
        ref = np.asarray(dia.to_dense()) @ X
        np.testing.assert_allclose(np.asarray(Y), ref, rtol=2e-5, atol=2e-5)

    def test_fast_path_matches_padded_path(self, rng):
        """Each column of the multi-RHS product equals the single-vector
        product of that column."""
        from spsparse_tpu.ops import best_spmm, best_spmv
        n = 1536
        dia = self._dia(rng, n)
        X8 = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
        Yf = np.asarray(best_spmm(dia, X8))
        for j in (0, 3, 7):
            np.testing.assert_allclose(Yf[:, j],
                                       np.asarray(best_spmv(dia, X8[:, j])),
                                       rtol=1e-6, atol=1e-6)

    def test_fast_path_grads(self, rng):
        from spsparse_tpu.core.dia import SparseDIA
        from spsparse_tpu.ops import best_spmm
        n = 512
        dia = self._dia(rng, n)
        X = jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32))
        W = jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32))

        def loss_fused(data, Xc):
            d = SparseDIA(data=data, offsets=dia.offsets, shape=dia.shape)
            return jnp.sum(W * best_spmm(d, Xc))

        def loss_ref(data, Xc):
            return jnp.sum(W * (_dense_of_dia(data, dia.offsets, n) @ Xc))

        gk = jax.grad(loss_fused, argnums=(0, 1))(dia.data, X)
        gr = jax.grad(loss_ref, argnums=(0, 1))(dia.data, X)
        np.testing.assert_allclose(gk[0], gr[0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gk[1], gr[1], rtol=1e-4, atol=1e-5)
