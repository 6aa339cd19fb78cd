"""JAX-transform coverage: grad/vmap/jit through the sparse ops.

No reference counterpart (a C++ template library has no autodiff); being
transparently differentiable and batchable is a core capability of the
accelerator re-design — sparse operators drop into training loops.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder, to_csr, to_ell
from spsparse_tpu.core.dia import to_dia
from spsparse_tpu.ops.spmm import spmv, spmm
from spsparse_tpu.ops.spmv_kernels import spmv_dia
from spsparse_tpu.solvers import cg_solve, power_iteration
import dataclasses


def random_coo(rng, shape, nnz, dtype=np.float64):
    b = CooBuilder(shape, dtype=dtype)
    idx = np.stack([rng.integers(0, s, size=nnz) for s in shape], axis=1)
    b.add_many(idx, rng.uniform(-1, 1, size=nnz))
    return b.build()


class TestGrad:
    def test_grad_wrt_x(self, rng):
        A = random_coo(rng, (6, 5), 12)
        csr = to_csr(A)
        x = jnp.asarray(rng.uniform(-1, 1, 5))

        g = jax.grad(lambda v: jnp.sum(spmv(csr, v) ** 2))(x)
        Ad = np.asarray(A.to_dense())
        expect = 2 * Ad.T @ (Ad @ np.asarray(x))
        np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-10)

    def test_grad_wrt_vals(self, rng):
        A = random_coo(rng, (6, 5), 12)
        csr = to_csr(A)
        x = jnp.asarray(rng.uniform(-1, 1, 5))

        def loss(vals):
            csr2 = dataclasses.replace(csr, vals=vals)
            return jnp.sum(spmv(csr2, x))

        g = np.asarray(jax.grad(loss)(csr.vals))
        # d/dvals sum(A@x) = x[col] per entry
        cols = np.asarray(csr.cols)
        live = np.arange(csr.cap) < int(csr.nnz)
        expect = np.where(live, np.asarray(x)[np.minimum(cols, 4)] *
                          (cols < 5), 0.0)
        np.testing.assert_allclose(g, expect, rtol=1e-10)

    def test_grad_through_spmm(self, rng):
        A = random_coo(rng, (6, 5), 12)
        ell = to_ell(A)
        X = jnp.asarray(rng.uniform(-1, 1, (5, 3)))
        g = jax.grad(lambda v: jnp.sum(spmm(ell, v)))(X)
        Ad = np.asarray(A.to_dense())
        np.testing.assert_allclose(np.asarray(g),
                                   np.outer(Ad.sum(0), np.ones(3)),
                                   rtol=1e-10)

    def test_grad_through_dia_and_cg(self, rng):
        A = random_coo(rng, (8, 8), 20)
        # SPD operator: D = A A^T + 2I applied via dense is the oracle
        Ad = np.asarray(A.to_dense())
        M = Ad @ Ad.T + 2 * np.eye(8)
        b = jnp.asarray(rng.uniform(-1, 1, 8))

        csr = to_csr(A)

        def solve(bv):
            mv = lambda v: spmv(csr, spmv(csr, v, transpose=True)) + 2 * v
            x, _ = cg_solve(mv, bv, iters=16)
            return jnp.sum(x)

        g = np.asarray(jax.grad(solve)(b))
        expect = np.linalg.solve(M.T, np.ones(8))
        np.testing.assert_allclose(g, expect, rtol=1e-6, atol=1e-8)


class TestVmap:
    def test_vmap_spmv_over_x(self, rng):
        A = random_coo(rng, (6, 5), 12)
        csr = to_csr(A)
        X = jnp.asarray(rng.uniform(-1, 1, (4, 5)))
        Y = jax.vmap(lambda v: spmv(csr, v))(X)
        np.testing.assert_allclose(np.asarray(Y),
                                   (np.asarray(A.to_dense()) @
                                    np.asarray(X).T).T, rtol=1e-10)

    def test_vmap_spmv_dia(self, rng):
        b = CooBuilder((8, 8), dtype=np.float64)
        for i in range(8):
            b.add((i, i), float(i + 1))
            if i:
                b.add((i, i - 1), 0.5)
        A = b.build()
        dia = to_dia(A)
        X = jnp.asarray(rng.uniform(-1, 1, (3, 8)))
        Y = jax.vmap(lambda v: spmv_dia(dia, v))(X)
        np.testing.assert_allclose(np.asarray(Y),
                                   (np.asarray(A.to_dense()) @
                                    np.asarray(X).T).T, rtol=1e-12)


class TestSolvers:
    def test_cg_converges(self, rng):
        A = random_coo(rng, (12, 12), 40)
        csr = to_csr(A)
        b = jnp.asarray(rng.uniform(-1, 1, 12))
        mv = lambda v: spmv(csr, spmv(csr, v, transpose=True)) + v
        x, rs = cg_solve(mv, b, iters=40)
        Ad = np.asarray(A.to_dense())
        M = Ad @ Ad.T + np.eye(12)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(M, b),
                                   rtol=1e-8, atol=1e-10)
        assert float(rs) < 1e-16

    def test_power_iteration(self, rng):
        A = random_coo(rng, (10, 10), 40)
        csr = to_csr(A)
        mv = lambda v: spmv(csr, spmv(csr, v, transpose=True))
        v0 = jnp.asarray(rng.uniform(0.1, 1, 10))
        _, lam = power_iteration(mv, v0, iters=200)
        Ad = np.asarray(A.to_dense())
        expect = np.linalg.eigvalsh(Ad @ Ad.T).max()
        np.testing.assert_allclose(float(lam), expect, rtol=1e-6)


class TestPreconditionedCG:
    def test_jacobi_pcg_converges_faster(self, rng):
        from spsparse_tpu.solvers import (cg_solve, pcg_solve,
                                          jacobi_preconditioner)
        n = 64
        # Badly scaled SPD diagonal + small coupling
        diag = 10.0 ** rng.uniform(-2, 2, n)
        A = np.diag(diag)
        Q = rng.uniform(-0.05, 0.05, (n, n))
        A = A + Q @ Q.T
        b = rng.uniform(-1, 1, n)
        mv = lambda v: jnp.asarray(A) @ v
        x_cg, rs_cg = cg_solve(mv, jnp.asarray(b), iters=24)
        x_pcg, rs_pcg = pcg_solve(mv, jnp.asarray(b), iters=24,
                                  minv=jnp.asarray(
                                      jacobi_preconditioner(
                                          jnp.asarray(np.diag(A)))))
        assert float(rs_pcg) < float(rs_cg) * 1e-2
        ref = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(x_pcg), ref, rtol=1e-5,
                                   atol=1e-7)

    def test_pcg_none_equals_cg(self, rng):
        from spsparse_tpu.solvers import cg_solve, pcg_solve
        A = random_coo(rng, (10, 10), 30)
        csr = to_csr(A)
        mv = lambda v: spmv(csr, spmv(csr, v, transpose=True)) + v
        b = jnp.asarray(rng.uniform(-1, 1, 10))
        x1, _ = cg_solve(mv, b, iters=15)
        x2, _ = pcg_solve(mv, b, iters=15, minv=None)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


class TestGradThroughMultiplyChain:
    def test_grad_wrt_operand_vals_matches_fd(self, rng):
        # The ESC pipeline (sorts, segmented scans, compactions) is
        # differentiable end-to-end: d/dA.vals of a functional of
        # multiply(A, B) matches finite differences.
        from spsparse_tpu.ops import multiply

        def rand(shape, n):
            b = CooBuilder(shape, dtype=np.float64)
            idx = np.stack([rng.integers(0, s, n) for s in shape], 1)
            b.add_many(idx, rng.uniform(0.5, 1.5, n))
            return b.build()

        A, B = rand((6, 5), 12), rand((5, 7), 14)

        def loss(avals):
            A2 = dataclasses.replace(A, vals=avals)
            C = multiply(1.0, A2, B, expand_cap=256, cap=128)
            return jnp.sum(C.vals ** 2)

        g = jax.grad(loss)(A.vals)
        eps = 1e-6
        for k in (0, 3, 7):
            fd = (loss(A.vals.at[k].add(eps))
                  - loss(A.vals.at[k].add(-eps))) / (2 * eps)
            np.testing.assert_allclose(float(g[k]), float(fd), rtol=1e-5)
