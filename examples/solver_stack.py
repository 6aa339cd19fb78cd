"""Example: the solver + preconditioner stack on a sparse operator.

Builds an ill-scaled SPD banded system, then solves it four ways —
CG, Jacobi-PCG, block-Jacobi-PCG, and Chebyshev (with Lanczos-estimated
spectral bounds) — and differentiates through the solve with the
implicit-gradient wrapper. Runs on CPU or GPU:

    python examples/solver_stack.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    import jax
    import jax.numpy as jnp

    import spsparse_tpu as sp
    from spsparse_tpu.ops.spmm import spmv
    from spsparse_tpu.solvers import (block_jacobi_preconditioner,
                                      cg_solve, cg_solve_implicit,
                                      chebyshev_solve, extract_diagonal,
                                      jacobi_preconditioner, lanczos_bounds,
                                      pcg_solve)

    n = 4096
    rng = np.random.default_rng(0)

    # Ill-scaled SPD pentadiagonal operator.
    s = 10.0 ** rng.uniform(-2, 2, n)
    b = sp.CooBuilder((n, n), dtype=np.float64)
    for off in (1, 2):
        r = np.arange(n - off)
        v = rng.uniform(-0.3, 0.3, n - off) * s[r] * s[r + off]
        b.add_many(np.stack([r, r + off], 1), v)
        b.add_many(np.stack([r + off, r], 1), v)
    diag = s * s * rng.uniform(1.5, 2.5, n)
    b.add_many(np.stack([np.arange(n)] * 2, 1), diag)
    A = b.build()
    csr = sp.to_csr(A)
    mv = lambda v: spmv(csr, v)  # noqa: E731
    rhs = jnp.asarray(rng.uniform(-1, 1, n))

    iters = 80
    _, rs_cg = cg_solve(mv, rhs, iters=iters)
    d = extract_diagonal(csr)
    _, rs_j = pcg_solve(mv, rhs, iters=iters,
                        minv=jacobi_preconditioner(d))
    _, rs_bj = pcg_solve(mv, rhs, iters=iters,
                         minv=block_jacobi_preconditioner(A, bs=128))
    lo, hi = lanczos_bounds(mv, rhs, iters=30)
    _, rs_ch = chebyshev_solve(mv, rhs, lam_min=float(lo),
                               lam_max=float(hi), iters=iters)
    print(f"residual^2 after {iters} iters:")
    print(f"  cg             {float(rs_cg):.3e}")
    print(f"  pcg jacobi     {float(rs_j):.3e}")
    print(f"  pcg blockjac   {float(rs_bj):.3e}")
    print(f"  chebyshev      {float(rs_ch):.3e}  "
          f"(bounds [{float(lo):.3g}, {float(hi):.3g}], no inner products)")

    # Differentiate a functional of the solution w.r.t. the rhs — one
    # extra CG solve, not iters unrolled SpMVs.
    loss = lambda bb: jnp.sum(cg_solve_implicit(mv, bb, iters=iters))  # noqa: E731
    g = jax.grad(loss)(rhs)
    print(f"implicit-gradient norm: {float(jnp.linalg.norm(g)):.6g}")


if __name__ == "__main__":
    main()
