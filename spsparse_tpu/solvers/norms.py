"""Norm estimation for implicitly-defined operators.

``onenormest`` is the Higham-Tisseur block 1-norm estimator
(scipy.sparse.linalg.onenormest): a handful of block matvecs with ``A``
and ``A^T`` instead of materializing columns, so it works for operator
*products* (``inv``-free condition estimates, ``expm_multiply`` step-size
selection) where the matrix never exists. Device-first shape: the ``t``
probe vectors ride a single ``(n, t)`` block through ``matmat`` (one
fused pass), and the iteration count is static under ``lax.scan`` — the
estimate is a lower bound that is almost always exact (Higham & Tisseur
2000); the reference library has no norm machinery at all
(SURVEY.md §2; ``coo_norm`` covers the explicit-entry norms).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from .linop import LinearOperator, aslinearoperator

__all__ = ["onenormest"]

Array = Any


def onenormest(A, *, t: int = 2, itmax: int = 5, seed: int = 0) -> Array:
    """Estimate ``||A||_1`` (max column abs-sum) of a square operator.

    ``A`` may be a :class:`LinearOperator` (needs ``rmatvec``), a
    :class:`SparseCOO`, or any format ``aslinearoperator`` accepts.
    ``t`` probe columns, ``itmax`` forward/adjoint rounds — both static,
    so the whole estimator jits. Differences from scipy: fixed iteration
    count (no early-exit/parallel-column resampling — on a device the extra
    fixed rounds are cheaper than host round-trips), so in rare
    adversarial cases the estimate can be a slightly weaker lower bound.
    """
    op = A if isinstance(A, LinearOperator) else aslinearoperator(A)
    m, n = op.shape
    if m != n:
        raise SpSparseError(f"onenormest needs a square operator, got "
                            f"{op.shape}")
    t = max(1, min(int(t), n))
    # probe block: ones column + random sign columns (Higham-Tisseur X0)
    rng = np.random.default_rng(seed)
    X = np.ones((n, t))
    if t > 1:
        X[:, 1:] = rng.choice([-1.0, 1.0], size=(n, t - 1))
    X /= n
    X = jnp.asarray(X)

    def body(carry, _):
        X, visited = carry
        Y = op.matmat(X)                           # (n, t)
        ests = jnp.sum(jnp.abs(Y), axis=0)
        S = jnp.where(Y >= 0, 1.0, -1.0).astype(Y.dtype)
        Z = op.rmatmat(S)                          # (n, t)
        h = jnp.max(jnp.abs(Z), axis=1)            # (n,)
        # next probes: unit vectors at the t largest h entries among
        # columns not yet visited (revisiting wastes the whole round —
        # the Higham-Tisseur "already been here" rule)
        _, idx = jax.lax.top_k(jnp.where(visited, -jnp.inf, h), t)
        visited = visited.at[idx].set(True)
        # keep the carry dtype stable (op may compute in a narrower type)
        Xn = jnp.zeros((n, t), X.dtype).at[idx, jnp.arange(t)].set(1.0)
        return (Xn, visited), jnp.max(ests)

    _, ests = jax.lax.scan(body, (X, jnp.zeros(n, bool)), None,
                           length=max(1, int(itmax)))
    return jnp.max(ests)
