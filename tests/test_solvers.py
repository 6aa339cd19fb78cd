"""Preconditioner + extended-solver coverage (solvers.precond /
bicgstab / chebyshev).

No reference counterpart (the reference stops at the multiply chain); the
oracles here are dense numpy solves/diagonals.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder, to_csr
from spsparse_tpu.core.bsr import to_bsr
from spsparse_tpu.core.dia import to_dia
from spsparse_tpu.core.tiled import to_tiled
from spsparse_tpu.ops.spmm import spmv
from spsparse_tpu.solvers import (bicgstab_solve, block_jacobi_preconditioner, gmres_solve,
                                  cg_solve, chebyshev_solve,
                                  extract_diag_blocks, extract_diagonal,
                                  jacobi_preconditioner,
                                  neumann_preconditioner, pcg_solve)


def random_coo(rng, shape, nnz, dtype=np.float64, with_diag=True):
    b = CooBuilder(shape, dtype=dtype)
    idx = np.stack([rng.integers(0, s, size=nnz) for s in shape], axis=1)
    b.add_many(idx, rng.uniform(-1, 1, size=nnz))
    if with_diag:
        n = min(shape)
        di = np.arange(n)
        b.add_many(np.stack([di, di], 1), rng.uniform(1, 2, size=n))
    return b.build()


def spd_banded(rng, n, band=2, dtype=np.float64):
    """Diagonally dominant SPD band matrix (dense + COO)."""
    A = np.zeros((n, n), dtype)
    for off in range(1, band + 1):
        v = rng.uniform(-0.3, 0.3, n - off)
        A[np.arange(n - off), np.arange(off, n)] = v
        A[np.arange(off, n), np.arange(n - off)] = v
    A[np.arange(n), np.arange(n)] = (np.abs(A).sum(1) +
                                     rng.uniform(0.5, 1.5, n))
    ii, jj = np.nonzero(A)
    b = CooBuilder((n, n), dtype=dtype)
    b.add_many(np.stack([ii, jj], 1), A[ii, jj])
    return A, b.build()


class TestExtractDiagonal:
    def test_matches_dense_across_formats(self, rng):
        A = random_coo(rng, (40, 40), 160)
        expect = np.diag(np.asarray(A.to_dense()))
        for conv, rtol in ((lambda a: a, 1e-12), (to_csr, 1e-12),
                           (to_dia, 1e-12), (to_tiled, 1e-6),  # tiled is f32
                           (lambda a: to_bsr(a, (8, 8)), 1e-12)):
            got = np.asarray(extract_diagonal(conv(A)))
            np.testing.assert_allclose(got, expect, rtol=rtol, atol=0,
                                       err_msg=str(conv))

    def test_rectangular_and_duplicates(self, rng):
        b = CooBuilder((5, 9), dtype=np.float64)
        b.add((2, 2), 3.0)
        b.add((2, 2), 4.0)      # duplicates sum (ADD semantics)
        b.add((4, 7), 1.0)      # off-diagonal ignored
        A = b.build()
        got = np.asarray(extract_diagonal(A))
        assert got.shape == (5,)
        np.testing.assert_array_equal(got, [0, 0, 7.0, 0, 0])

    def test_dia_without_main_diagonal(self, rng):
        b = CooBuilder((6, 6), dtype=np.float64)
        for i in range(5):
            b.add((i, i + 1), float(i + 1))
        got = np.asarray(extract_diagonal(to_dia(b.build())))
        np.testing.assert_array_equal(got, np.zeros(6))

    def test_jittable_on_coo(self, rng):
        A = random_coo(rng, (16, 16), 48)
        got = jax.jit(extract_diagonal)(A)
        np.testing.assert_allclose(np.asarray(got),
                                   np.diag(np.asarray(A.to_dense())),
                                   rtol=1e-12)

    def test_diag_blocks_match_dense(self, rng):
        A = random_coo(rng, (20, 20), 120)
        Ad = np.asarray(A.to_dense())
        blocks = np.asarray(extract_diag_blocks(A, 8))
        assert blocks.shape == (3, 8, 8)
        for k in range(3):
            lo, hi = 8 * k, min(8 * (k + 1), 20)
            expect = np.zeros((8, 8))
            expect[: hi - lo, : hi - lo] = Ad[lo:hi, lo:hi]
            np.testing.assert_allclose(blocks[k], expect, rtol=1e-12)


class TestBlockJacobi:
    def test_beats_jacobi_on_block_structure(self, rng):
        # Block-diagonal-dominant SPD matrix with strong in-block coupling:
        # point Jacobi ignores the coupling, block Jacobi inverts it.
        n, bs = 64, 8
        A = np.zeros((n, n))
        for k in range(n // bs):
            Q = rng.uniform(-1, 1, (bs, bs))
            A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = Q @ Q.T + np.eye(bs)
        off = rng.uniform(-0.01, 0.01, (n, n))
        A = A + off @ off.T
        ii, jj = np.nonzero(A)
        bld = CooBuilder((n, n), dtype=np.float64)
        bld.add_many(np.stack([ii, jj], 1), A[ii, jj])
        Acoo = bld.build()
        b = jnp.asarray(rng.uniform(-1, 1, n))
        mv = lambda v: jnp.asarray(A) @ v

        mj = jacobi_preconditioner(extract_diagonal(Acoo))
        mb = block_jacobi_preconditioner(Acoo, bs=bs)
        _, rs_j = pcg_solve(mv, b, iters=12, minv=mj)
        x_b, rs_b = pcg_solve(mv, b, iters=12, minv=mb)
        assert float(rs_b) < float(rs_j) * 1e-2
        np.testing.assert_allclose(np.asarray(x_b), np.linalg.solve(A, b),
                                   rtol=1e-6, atol=1e-8)

    def test_nonmultiple_extent_and_empty_rows(self, rng):
        # n not a multiple of bs; trailing pad block must act as identity.
        A, Acoo = spd_banded(rng, 21)
        b = jnp.asarray(rng.uniform(-1, 1, 21))
        mb = block_jacobi_preconditioner(Acoo, bs=8)
        x, rs = pcg_solve(lambda v: jnp.asarray(A) @ v, b, iters=25,
                          minv=mb)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-10)


class TestNeumann:
    def test_k1_equals_jacobi(self, rng):
        A, Acoo = spd_banded(rng, 32)
        csr = to_csr(Acoo)
        d = extract_diagonal(csr)
        mv = lambda v: spmv(csr, v)
        b = jnp.asarray(rng.uniform(-1, 1, 32))
        x1, _ = pcg_solve(mv, b, iters=9, minv=jacobi_preconditioner(d))
        x2, _ = pcg_solve(mv, b, iters=9,
                          minv=neumann_preconditioner(mv, d, k=1))
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                                   rtol=1e-12)

    def test_k3_beats_jacobi(self, rng):
        A, Acoo = spd_banded(rng, 96, band=3)
        csr = to_csr(Acoo)
        d = extract_diagonal(csr)
        mv = lambda v: spmv(csr, v)
        b = jnp.asarray(rng.uniform(-1, 1, 96))
        _, rs_j = pcg_solve(mv, b, iters=8, minv=jacobi_preconditioner(d))
        x, rs_n = pcg_solve(mv, b, iters=8,
                            minv=neumann_preconditioner(mv, d, k=3))
        assert float(rs_n) < float(rs_j)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-5, atol=1e-7)


class TestBiCGStab:
    def test_nonsymmetric_matches_dense_solve(self, rng):
        n = 48
        A = np.eye(n) * 4 + rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
        b = rng.uniform(-1, 1, n)
        x, rs = bicgstab_solve(lambda v: jnp.asarray(A) @ v,
                               jnp.asarray(b), iters=n)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-7, atol=1e-9)
        assert float(rs) < 1e-18

    def test_preconditioned_on_sparse_operator(self, rng):
        # Nonsymmetric banded operator through the CSR SpMV path.
        n = 64
        A = np.zeros((n, n))
        A[np.arange(n), np.arange(n)] = rng.uniform(2, 3, n)
        A[np.arange(n - 1), np.arange(1, n)] = rng.uniform(-1, 1, n - 1)
        A[np.arange(2, n), np.arange(n - 2)] = rng.uniform(-1, 1, n - 2)
        ii, jj = np.nonzero(A)
        bld = CooBuilder((n, n), dtype=np.float64)
        bld.add_many(np.stack([ii, jj], 1), A[ii, jj])
        csr = to_csr(bld.build())
        mv = lambda v: spmv(csr, v)
        b = jnp.asarray(rng.uniform(-1, 1, n))
        minv = jacobi_preconditioner(extract_diagonal(csr))
        x, _ = bicgstab_solve(mv, b, iters=40, minv=minv)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-10)

    def test_jit_and_breakdown_guard(self, rng):
        # b = 0 drives rho to 0 immediately; guarded divisions must keep
        # the fixed-iteration scan finite and return x = 0.
        A, _ = spd_banded(rng, 16)
        x, rs = jax.jit(lambda bv: bicgstab_solve(
            lambda v: jnp.asarray(A) @ v, bv, iters=8))(jnp.zeros(16))
        assert np.all(np.isfinite(np.asarray(x)))
        np.testing.assert_array_equal(np.asarray(x), np.zeros(16))


class TestChebyshev:
    def test_matches_dense_solve_with_true_bounds(self, rng):
        A, Acoo = spd_banded(rng, 80)
        w = np.linalg.eigvalsh(A)
        csr = to_csr(Acoo)
        mv = lambda v: spmv(csr, v)
        b = jnp.asarray(rng.uniform(-1, 1, 80))
        x, rs = chebyshev_solve(mv, b, lam_min=float(w[0]),
                                lam_max=float(w[-1]), iters=60)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-10)

    def test_no_inner_products_until_final(self, rng):
        # The scan body must contain no reductions: jaxpr of one body step
        # applied via scan should have no dot/reduce over the vector other
        # than the matvec itself. We check the cheap observable instead:
        # chebyshev with loose Gershgorin bounds still converges.
        A, Acoo = spd_banded(rng, 64)
        lam_max = float(np.abs(A).sum(1).max())        # Gershgorin
        lam_min = float((2 * np.diag(A) - np.abs(A).sum(1)).min())
        assert lam_min > 0
        csr = to_csr(Acoo)
        b = jnp.asarray(rng.uniform(-1, 1, 64))
        x, rs = chebyshev_solve(lambda v: spmv(csr, v), b,
                                lam_min=lam_min, lam_max=lam_max, iters=80)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-7, atol=1e-9)


class TestGMRES:
    def test_nonsymmetric_matches_dense_solve(self, rng):
        n = 40
        A = np.eye(n) * 3 + rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
        b = rng.uniform(-1, 1, n)
        x, rs = gmres_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                            m=20, restarts=4)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-10)
        assert float(rs) < 1e-20

    def test_full_dimension_is_direct(self, rng):
        # m = n makes a single restart exact (up to roundoff).
        n = 12
        A = np.eye(n) * 2 + rng.uniform(-1, 1, (n, n)) / 4
        b = rng.uniform(-1, 1, n)
        x, rs = gmres_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                            m=n, restarts=1)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-9, atol=1e-11)

    def test_preconditioned_sparse_operator(self, rng):
        # Right-preconditioned GMRES through the CSR SpMV path on an
        # ill-scaled nonsymmetric banded operator.
        n = 64
        A = np.zeros((n, n))
        A[np.arange(n), np.arange(n)] = 10.0 ** rng.uniform(-1.5, 1.5, n)
        A[np.arange(n - 1), np.arange(1, n)] = rng.uniform(-0.3, 0.3, n - 1)
        A[np.arange(3, n), np.arange(n - 3)] = rng.uniform(-0.3, 0.3, n - 3)
        ii, jj = np.nonzero(A)
        bld = CooBuilder((n, n), dtype=np.float64)
        bld.add_many(np.stack([ii, jj], 1), A[ii, jj])
        csr = to_csr(bld.build())
        mv = lambda v: spmv(csr, v)
        b = jnp.asarray(rng.uniform(-1, 1, n))
        minv = jacobi_preconditioner(extract_diagonal(csr))
        _, rs_plain = gmres_solve(mv, b, m=10, restarts=2)
        _, rs_prec = gmres_solve(mv, b, m=10, restarts=2, minv=minv)
        assert float(rs_prec) < float(rs_plain)
        x, _ = gmres_solve(mv, b, m=16, restarts=8, minv=minv)
        np.testing.assert_allclose(np.asarray(x),
                                   np.linalg.solve(A, np.asarray(b)),
                                   rtol=1e-7, atol=1e-9)

    def test_jittable_and_zero_rhs(self, rng):
        n = 16
        A = np.eye(n) * 2 + rng.uniform(-0.1, 0.1, (n, n))
        x, rs = jax.jit(lambda bv: gmres_solve(
            lambda v: jnp.asarray(A) @ v, bv, m=8, restarts=2))(
            jnp.zeros(n))
        assert np.all(np.isfinite(np.asarray(x)))
        np.testing.assert_array_equal(np.asarray(x), np.zeros(n))


class TestLanczosBounds:
    def test_encloses_spectrum_and_feeds_chebyshev(self, rng):
        from spsparse_tpu.solvers import lanczos_bounds
        A, Acoo = spd_banded(rng, 100, band=3)
        w = np.linalg.eigvalsh(A)
        csr = to_csr(Acoo)
        mv = lambda v: spmv(csr, v)
        v0 = jnp.asarray(rng.uniform(-1, 1, 100))
        lo, hi = lanczos_bounds(mv, v0, iters=30)
        assert float(lo) <= w[0] * 1.001 and float(hi) >= w[-1] * 0.999
        assert float(lo) > 0
        b = jnp.asarray(rng.uniform(-1, 1, 100))
        x, rs = chebyshev_solve(mv, b, lam_min=float(lo),
                                lam_max=float(hi), iters=80)
        np.testing.assert_allclose(np.asarray(x),
                                   np.linalg.solve(A, np.asarray(b)),
                                   rtol=1e-7, atol=1e-9)

    def test_jittable(self, rng):
        from spsparse_tpu.solvers import lanczos_bounds
        A, _ = spd_banded(rng, 32)
        lo, hi = jax.jit(lambda v: lanczos_bounds(
            lambda u: jnp.asarray(A) @ u, v, iters=16))(
            jnp.asarray(rng.uniform(-1, 1, 32)))
        w = np.linalg.eigvalsh(A)
        assert float(lo) <= w[0] * 1.001 and float(hi) >= w[-1] * 0.999


class TestImplicitCG:
    def test_forward_matches_cg(self, rng):
        from spsparse_tpu.solvers import cg_solve_implicit
        A, Acoo = spd_banded(rng, 48)
        csr = to_csr(Acoo)
        b = jnp.asarray(rng.uniform(-1, 1, 48))
        x1 = cg_solve_implicit(lambda v: spmv(csr, v), b, iters=40)
        x2, _ = cg_solve(lambda v: spmv(csr, v), b, iters=40)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                                   rtol=1e-10, atol=1e-12)

    def test_grad_wrt_rhs_is_inverse_transpose_row(self, rng):
        # d/db (c^T A^{-1} b) = A^{-T} c = A^{-1} c for SPD A.
        from spsparse_tpu.solvers import cg_solve_implicit
        A, Acoo = spd_banded(rng, 32)
        csr = to_csr(Acoo)
        c = rng.uniform(-1, 1, 32)

        def loss(bv):
            x = cg_solve_implicit(lambda v: spmv(csr, v), bv, iters=40)
            return jnp.vdot(jnp.asarray(c), x)

        g = jax.grad(loss)(jnp.asarray(rng.uniform(-1, 1, 32)))
        np.testing.assert_allclose(np.asarray(g), np.linalg.solve(A, c),
                                   rtol=1e-8, atol=1e-10)

    def test_grad_wrt_operator_values(self, rng):
        # Differentiate through the matrix VALUES closed over by matvec:
        # for loss = c^T x(s) with (s*A) x = b, d loss/d s = -c^T A^{-1}
        # b / s^2 ... checked against finite differences.
        from spsparse_tpu.solvers import cg_solve_implicit
        A, Acoo = spd_banded(rng, 24)
        csr = to_csr(Acoo)
        b = jnp.asarray(rng.uniform(-1, 1, 24))
        c = jnp.asarray(rng.uniform(-1, 1, 24))

        def loss(s):
            x = cg_solve_implicit(lambda v: s * spmv(csr, v), b, iters=40)
            return jnp.vdot(c, x)

        s0 = 1.3
        g = float(jax.grad(loss)(jnp.asarray(s0)))
        eps = 1e-5
        fd = (float(loss(jnp.asarray(s0 + eps)))
              - float(loss(jnp.asarray(s0 - eps)))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-5)


    def test_breakdown_safe(self, rng):
        # v0 = ones on a constant-row-sum-ish operator exhausts the Krylov
        # space early; dead Lanczos steps must not inject spurious Ritz
        # value 0 (they used to: lam_min came back ~0).
        from spsparse_tpu.solvers import lanczos_bounds
        n = 16
        M = np.diag(np.full(n, 4.0))
        M[np.arange(n - 1), np.arange(1, n)] = -1
        M[np.arange(1, n), np.arange(n - 1)] = -1
        w = np.linalg.eigvalsh(M)
        lo, hi = lanczos_bounds(lambda v: jnp.asarray(M) @ v,
                                jnp.ones(n), iters=10)
        assert 0 < float(lo) <= w[0] * 1.001
        assert float(hi) >= w[-1] * 0.999


class TestChebyshevIterationContract:
    def test_exactly_iters_updates(self, rng):
        # Pin against a step-by-step numpy reference doing exactly
        # `iters` solution updates (the scan does iters-1, the flush 1).
        n = 12
        A = np.diag(rng.uniform(1, 50, n))
        A[0, 1] = A[1, 0] = 0.7
        b = rng.uniform(-1, 1, n)
        w = np.linalg.eigvalsh(A)
        lo, hi = float(w[0]), float(w[-1])

        def cheb_np(iters):
            theta, delta = (hi + lo) / 2, (hi - lo) / 2
            sigma1 = theta / delta
            x = np.zeros(n)
            r = b - A @ x
            d = r / theta
            rho = 1 / sigma1
            for _ in range(iters):
                x = x + d
                r = r - A @ d
                rho_new = 1 / (2 * sigma1 - rho)
                d = rho_new * rho * d + (2 * rho_new / delta) * r
                rho = rho_new
            return x

        for iters in (1, 3, 17):
            x, _ = chebyshev_solve(lambda v: jnp.asarray(A) @ v,
                                   jnp.asarray(b), lam_min=lo, lam_max=hi,
                                   iters=iters)
            np.testing.assert_allclose(np.asarray(x), cheb_np(iters),
                                       rtol=1e-12, err_msg=f"iters={iters}")


class TestBatchedCG:
    """cg_solve_mrhs: k independent CGs sharing each operator application
    (the multi-RHS amortization the DIA mrhs kernel exists for)."""

    def test_columns_match_single_rhs_cg(self, rng):
        A, coo = spd_banded(rng, 96, band=3)
        Aj = jnp.asarray(A)
        B = jnp.asarray(rng.uniform(-1, 1, (96, 5)))
        from spsparse_tpu.solvers import cg_solve_mrhs
        X, rs = cg_solve_mrhs(lambda M: Aj @ M, B, iters=40)
        assert X.shape == (96, 5) and rs.shape == (5,)
        for k in range(5):
            xk, rk = cg_solve(lambda v: Aj @ v, B[:, k], iters=40)
            np.testing.assert_allclose(np.asarray(X[:, k]), np.asarray(xk),
                                       rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(X),
                                   np.linalg.solve(A, np.asarray(B)),
                                   rtol=1e-8, atol=1e-10)

    def test_preconditioned_and_jittable(self, rng):
        A, coo = spd_banded(rng, 64, band=2)
        Aj = jnp.asarray(A)
        B = jnp.asarray(rng.uniform(-1, 1, (64, 3)))
        from spsparse_tpu.solvers import cg_solve_mrhs
        minv = jacobi_preconditioner(jnp.diag(Aj))

        @jax.jit
        def run(B):
            return cg_solve_mrhs(lambda M: Aj @ M, B, iters=30, minv=minv)

        X, rs = run(B)
        np.testing.assert_allclose(np.asarray(X),
                                   np.linalg.solve(A, np.asarray(B)),
                                   rtol=1e-8, atol=1e-10)
        # per-column match vs single-RHS pcg_solve (same math, same order)
        for k in range(3):
            xk, _ = pcg_solve(lambda v: Aj @ v, B[:, k], iters=30, minv=minv)
            np.testing.assert_allclose(np.asarray(X[:, k]), np.asarray(xk),
                                       rtol=1e-9, atol=1e-12)

    def test_breakdown_isolated_per_column(self, rng):
        # Column 0 has b = 0 (instant breakdown: rs = 0); other columns must
        # still converge — no cross-column coupling.
        A, _ = spd_banded(rng, 48, band=2)
        Aj = jnp.asarray(A)
        B = np.asarray(rng.uniform(-1, 1, (48, 3)))
        B[:, 0] = 0.0
        from spsparse_tpu.solvers import cg_solve_mrhs
        X, rs = cg_solve_mrhs(lambda M: Aj @ M, jnp.asarray(B), iters=40)
        assert np.all(np.isfinite(np.asarray(X)))
        np.testing.assert_allclose(np.asarray(X[:, 0]), 0.0, atol=0)
        np.testing.assert_allclose(np.asarray(X[:, 1:]),
                                   np.linalg.solve(A, B[:, 1:]),
                                   rtol=1e-8, atol=1e-10)

    def test_over_sparse_mrhs_operator(self, rng):
        # End-to-end over the multi-RHS DIA product (each diagonal read
        # once for all columns), the operator this solver exists to
        # amortize.
        from spsparse_tpu.core.dia import to_dia
        from spsparse_tpu.ops import best_spmm, prepare_dia
        from spsparse_tpu.solvers import cg_solve_mrhs
        n = 256
        A, coo = spd_banded(rng, n, band=2, dtype=np.float32)
        dia = prepare_dia(to_dia(coo), dtype=jnp.float32)
        B = jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32))
        X, rs = cg_solve_mrhs(lambda M: best_spmm(dia, M), B, iters=30)
        np.testing.assert_allclose(
            np.asarray(X), np.linalg.solve(A, np.asarray(B)),
            rtol=2e-4, atol=2e-4)

    def test_rejects_vector_rhs(self, rng):
        from spsparse_tpu.solvers import cg_solve_mrhs
        with pytest.raises(ValueError):
            cg_solve_mrhs(lambda M: M, jnp.ones(8), iters=1)


class TestCGS:
    def test_nonsymmetric_matches_dense_solve(self, rng):
        n = 48
        A = np.eye(n) * 4 + rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
        b = rng.uniform(-1, 1, n)
        from spsparse_tpu.solvers import cgs_solve
        x, rs = cgs_solve(lambda v: jnp.asarray(A) @ v,
                          jnp.asarray(b), iters=n)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-7, atol=1e-9)
        assert float(rs) < 1e-16

    def test_preconditioned(self, rng):
        n = 32
        A = np.diag(rng.uniform(2, 5, n))
        A[np.arange(n - 1), np.arange(1, n)] = rng.uniform(-0.5, 0.5, n - 1)
        b = rng.uniform(-1, 1, n)
        from spsparse_tpu.solvers import cgs_solve
        x, _ = cgs_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                         iters=24, minv=jnp.asarray(1 / np.diag(A)))
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-10)

    def test_breakdown_guard_zero_rhs(self, rng):
        from spsparse_tpu.solvers import cgs_solve
        A, _ = spd_banded(rng, 16)
        x, _ = jax.jit(lambda bv: cgs_solve(
            lambda v: jnp.asarray(A) @ v, bv, iters=8))(jnp.zeros(16))
        np.testing.assert_array_equal(np.asarray(x), np.zeros(16))


class TestTFQMR:
    def test_nonsymmetric_matches_dense_solve(self, rng):
        n = 48
        A = np.eye(n) * 4 + rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
        b = rng.uniform(-1, 1, n)
        from spsparse_tpu.solvers import tfqmr_solve
        x, rs = tfqmr_solve(lambda v: jnp.asarray(A) @ v,
                            jnp.asarray(b), iters=n)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-7, atol=1e-9)
        assert float(rs) < 1e-16

    def test_matches_scipy_tfqmr(self, rng):
        import scipy.sparse.linalg as spl
        n = 24
        A = np.eye(n) * 3 + rng.uniform(-1, 1, (n, n)) / n
        b = rng.uniform(-1, 1, n)
        from spsparse_tpu.solvers import tfqmr_solve
        x, _ = tfqmr_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                           iters=n)
        x_ref, info = spl.tfqmr(A, b, rtol=1e-12, maxiter=2 * n)
        assert info == 0
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-6,
                                   atol=1e-9)

    def test_sparse_operator_jit(self, rng):
        n = 64
        A = np.zeros((n, n))
        A[np.arange(n), np.arange(n)] = rng.uniform(2, 3, n)
        A[np.arange(n - 1), np.arange(1, n)] = rng.uniform(-1, 1, n - 1)
        ii, jj = np.nonzero(A)
        bld = CooBuilder((n, n), dtype=np.float64)
        bld.add_many(np.stack([ii, jj], 1), A[ii, jj])
        csr = to_csr(bld.build())
        from spsparse_tpu.solvers import tfqmr_solve
        b = jnp.asarray(rng.uniform(-1, 1, n))
        x, _ = jax.jit(lambda bv: tfqmr_solve(
            lambda v: spmv(csr, v), bv, iters=48))(b)
        np.testing.assert_allclose(np.asarray(x),
                                   np.linalg.solve(A, np.asarray(b)),
                                   rtol=1e-8, atol=1e-10)

    def test_breakdown_guard_zero_rhs(self, rng):
        from spsparse_tpu.solvers import tfqmr_solve
        A, _ = spd_banded(rng, 16)
        x, _ = tfqmr_solve(lambda v: jnp.asarray(A) @ v, jnp.zeros(16),
                           iters=8)
        assert np.all(np.isfinite(np.asarray(x)))
        np.testing.assert_array_equal(np.asarray(x), np.zeros(16))


class TestOnenormest:
    def test_lower_bound_and_quality(self, rng):
        from spsparse_tpu.solvers import onenormest
        ratios = []
        for s in range(10):
            E = np.random.default_rng(s).standard_normal((40, 40))
            ii, jj = E.nonzero()
            bld = CooBuilder((40, 40), dtype=np.float64)
            bld.add_many(np.stack([ii, jj], 1), E[ii, jj])
            est = float(onenormest(bld.build(), t=2, itmax=5, seed=s))
            true = np.abs(E).sum(axis=0).max()
            assert est <= true * (1 + 1e-12)      # always a lower bound
            ratios.append(est / true)
        assert np.mean(ratios) > 0.9              # and usually sharp

    def test_exact_on_diagonal(self):
        from spsparse_tpu.solvers import onenormest
        d = np.array([1.0, -7.0, 3.0, 2.0])
        bld = CooBuilder((4, 4), dtype=np.float64)
        bld.add_many(np.stack([np.arange(4)] * 2, 1), d)
        assert np.isclose(float(onenormest(bld.build(), t=2, itmax=4)), 7.0)

    def test_operator_product(self, rng):
        # ||A @ A||_1 without materializing the product
        from spsparse_tpu.solvers import aslinearoperator, onenormest
        E = rng.standard_normal((30, 30))
        ii, jj = E.nonzero()
        bld = CooBuilder((30, 30), dtype=np.float64)
        bld.add_many(np.stack([ii, jj], 1), E[ii, jj])
        op = aslinearoperator(bld.build())
        est = float(onenormest(op @ op, t=4, itmax=6))
        true = np.abs(E @ E).sum(axis=0).max()
        assert est <= true * (1 + 1e-12) and est > 0.7 * true

    def test_rejects_rectangular(self, rng):
        from spsparse_tpu.core.errors import SpSparseError
        from spsparse_tpu.solvers import onenormest
        with pytest.raises(SpSparseError, match="square"):
            onenormest(random_coo(rng, (4, 6), 5))
