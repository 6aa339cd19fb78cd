"""In-jit validation: checkify-based structural checks.

The reference validates eagerly through its pluggable error handler
(bounds on ``add``, sortedness in ``dim_beginnings``, inner-dimension
matches — SURVEY §5). Host-side entry points here do the same, but code
running *under jit* cannot raise; this module provides the jit-era
equivalent via ``jax.experimental.checkify``: functional checks that
travel with the computation and surface as errors when the caller chooses
to pay for them (debug mode), and compile to nothing otherwise.

Usage::

    from jax.experimental import checkify
    checked = checkify.checkify(lambda a: validate_coo(a))
    err, _ = jax.jit(checked)(coo)
    err.throw()   # raises on the host if any check failed
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.experimental import checkify

from .coo import SparseCOO

__all__ = ["validate_coo", "check_capacity"]


def validate_coo(a: SparseCOO) -> None:
    """Checkify assertions: live indices in bounds, nnz within capacity.

    Mirrors the reference's ``add()`` bounds contract
    (VectorCooArray.hpp:246-262) for arrays assembled inside jit, where the
    eager builder checks cannot run.
    """
    live = a.valid_mask()
    checkify.check(a.nnz >= 0, "SparseCOO nnz is negative")
    checkify.check(a.nnz <= a.cap,
                   "SparseCOO nnz exceeds capacity (overflowed cap)")
    shape = jnp.asarray(a.shape, a.indices.dtype)
    in_bounds = (a.indices >= 0) & (a.indices < shape)
    ok = jnp.all(jnp.where(live[:, None], in_bounds, True))
    checkify.check(ok, "Sparse index out of bounds among live entries")


def check_capacity(n_needed, cap: int, what: str = "output") -> None:
    """Checkify guard for capacity overflows of jitted producers
    (consolidate/SpGEMM with user-chosen static caps)."""
    checkify.check(n_needed <= cap,
                   "spsparse {what} overflowed static capacity", what=what)
