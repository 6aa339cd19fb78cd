"""Example: conjugate gradients on a row-partitioned operator.

Solves (A^T A + 0.5 I) x = b with the distributed ring-ppermute SpMV over
however many devices are available (on CPU, force a virtual mesh first —
see the __main__ block). Run:

    python examples/distributed_cg.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import spsparse_tpu as sp
    from spsparse_tpu.dist import dist_spmv, partition_rows, partition_vector
    from spsparse_tpu.solvers import cg_solve

    devs = np.asarray(jax.devices())
    P = len(devs)
    mesh = Mesh(devs, ("x",))
    n = 16 * P

    rng = np.random.default_rng(0)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    for off in (-1, 0, 1):
        r = np.arange(max(0, -off), min(n, n - off))
        b.add_many(np.stack([r, r + off], 1),
                   rng.uniform(-1, 1, r.size).astype(np.float32))
    A = b.build()
    part = partition_rows(A, P)
    part_t = partition_rows(A.transposed((1, 0)), P)

    rhs = partition_vector(rng.uniform(-1, 1, n).astype(np.float32), P)

    def matvec(p):
        # SPD operator: y = A^T (A p) + 0.5 p, both products distributed.
        y = dist_spmv(part, p, mesh, method="ring")
        y = dist_spmv(part_t, y, mesh, method="ring")
        return y + 0.5 * p

    x, rs = jax.jit(lambda r: cg_solve(matvec, r, iters=30))(rhs)
    print(f"devices={P}  final |r|^2 = {float(rs):.3e}")

    dense = np.asarray(A.to_dense())
    M = dense.T @ dense + 0.5 * np.eye(n)
    ref = np.linalg.solve(M, np.asarray(rhs).reshape(-1)[:n])
    err = np.abs(np.asarray(x).reshape(-1)[:n] - ref).max()
    print(f"max abs error vs dense solve: {err:.2e}")


if __name__ == "__main__":
    import os

    import jax

    if not os.environ.get("SPSPARSE_USE_GPU"):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    main()
