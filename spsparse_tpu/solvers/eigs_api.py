"""scipy-signature spectral entry points: ``eigs`` / ``eigsh`` with
shift-invert (``sigma=``) — thin dispatch over the engines in
:mod:`spsparse_tpu.solvers.spectral` plus the direct tier.

The engines stay the device-first primitives (device Arnoldi/Lanczos
decompositions; host small-eig); what this module adds is scipy's
calling convention: pass a :class:`SparseCOO` (or a
:class:`~spsparse_tpu.solvers.linop.LinearOperator`, or a bare matvec)
instead of wiring matvec closures, and pass ``sigma`` to get interior
eigenvalues through the standard shift-invert composition — the inner
``(A - sigma I)^-1`` is the native LU (:func:`spsparse_tpu.solvers.
direct.splu`), factored once on the host, applied per Krylov step.
Real shifts only (the factorization tier is real f64; scipy's complex
sigma is out of scope — documented divergence)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.algebra import coo_add, coo_scale
from ..core.construct import coo_eye
from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from .direct import splu
from .spectral import arnoldi_eigs, lanczos_eigsh

__all__ = ["eigs", "eigsh"]


def _as_matvec(A):
    """(matvec, n) from SparseCOO / LinearOperator / callable."""
    if isinstance(A, SparseCOO):
        from ..core.structure import to_csr
        from ..ops.spmm import spmv
        if A.rank != 2 or A.shape[0] != A.shape[1]:
            raise SpSparseError(f"eigs needs a square matrix, "
                                f"got {A.shape}")
        csr = to_csr(A)
        return (lambda v: spmv(csr, v)), int(A.shape[0])
    shape = getattr(A, "shape", None)
    if callable(A):
        n = int(shape[0]) if shape else None
        return A, n
    raise SpSparseError("eigs: A must be a SparseCOO, LinearOperator or "
                        "matvec callable")


def _shifted_lu(A: SparseCOO, sigma: float):
    if not isinstance(A, SparseCOO):
        raise SpSparseError("sigma (shift-invert) requires a SparseCOO "
                            "matrix — the inner solve factorizes A - "
                            "sigma*I with the native LU")
    n = int(A.shape[0])
    shifted = coo_add(A, coo_scale(coo_eye(n, dtype=np.float64),
                                   -float(sigma)))
    return splu(shifted, permc_spec="RCM")


def _v0(v0, n, seed=0):
    if v0 is not None:
        return jnp.asarray(v0)
    if n is None:
        raise SpSparseError("pass v0= when A is a bare matvec with no "
                            ".shape")
    return jnp.asarray(np.random.default_rng(seed).standard_normal(n))


def eigs(A, k: int = 6, *, sigma: float | None = None, which: str = "LM",
         v0=None, ncv: int | None = None, restarts: int = 8,
         tol: float = 1e-10, return_eigenvectors: bool = True):
    """``k`` eigenpairs of a general square operator
    (scipy.sparse.linalg.eigs signature). Without ``sigma``: the
    explicitly-restarted Arnoldi engine
    (:func:`~spsparse_tpu.solvers.spectral.arnoldi_eigs`). With
    ``sigma``: shift-invert — eigenvalues of ``(A - sigma I)^-1`` are
    computed (``which`` applies to the *transformed* values, scipy's
    convention, so the default ``'LM'`` returns the eigenvalues nearest
    ``sigma``) and mapped back ``lam = sigma + 1/theta``."""
    mv, n = _as_matvec(A)
    if sigma is None:
        vals, vecs = arnoldi_eigs(mv, _v0(v0, n), k=k, which=which,
                                  iters=ncv, restarts=restarts, tol=tol)
    else:
        lu = _shifted_lu(A, sigma)
        theta, vecs = arnoldi_eigs(lu.solve, _v0(v0, int(A.shape[0])),
                                   k=k, which=which, iters=ncv,
                                   restarts=restarts, tol=tol)
        vals = sigma + 1.0 / theta
    return (vals, vecs) if return_eigenvectors else vals


def eigsh(A, k: int = 6, *, sigma: float | None = None,
          which: str = "LM", v0=None, ncv: int | None = None,
          return_eigenvectors: bool = True):
    """``k`` eigenpairs of a symmetric operator
    (scipy.sparse.linalg.eigsh signature; engine:
    :func:`~spsparse_tpu.solvers.spectral.lanczos_eigsh`).

    ``which``: ``'LA'``/``'SA'`` (algebraic extremes), or ``'LM'`` —
    largest magnitude, resolved by taking both spectrum ends and
    keeping the k largest ``|lam|`` (scipy's eigsh default). ``'SM'``
    without ``sigma`` is refused, as in ARPACK practice — pass the
    shift instead. With ``sigma``: shift-invert through the native LU;
    returns the eigenvalues nearest ``sigma``, ascending."""
    mv, n = _as_matvec(A)
    ncv_eff = ncv or (min(max(6 * k + 40, 64), n) if n else None)
    if sigma is not None:
        lu = _shifted_lu(A, sigma)
        nn = int(A.shape[0])
        ncv_eff = ncv or min(max(6 * k + 40, 64), nn)
        # theta = 1/(lam - sigma): the wanted (nearest-sigma) pairs have
        # the LARGEST |theta| — on either side of zero, so take both
        # spectrum ends of the transformed operator.
        ta, ua = lanczos_eigsh(lu.solve, _v0(v0, nn), k=k,
                               iters=ncv_eff, which="LA")
        ts, us = lanczos_eigsh(lu.solve, _v0(v0, nn, seed=1), k=k,
                               iters=ncv_eff, which="SA")
        theta = np.concatenate([np.asarray(ta), np.asarray(ts)])
        U = jnp.concatenate([ua, us], axis=1)
        ok = np.abs(theta) > 1e-300
        lam = np.where(ok, sigma + 1.0 / np.where(ok, theta, 1.0), np.inf)
        order = np.argsort(np.abs(lam - sigma), kind="stable")
        sel, seen = [], []
        for i in order:
            if any(abs(lam[i] - lam[j]) < 1e-9 * max(1.0, abs(lam[i]))
                   for j in seen):
                continue
            seen.append(i)
            sel.append(i)
            if len(sel) == k:
                break
        sel = np.asarray(sel)
        asc = sel[np.argsort(lam[sel])]
        return ((jnp.asarray(lam[asc]), U[:, asc])
                if return_eigenvectors else jnp.asarray(lam[asc]))
    if which in ("LA", "SA"):
        vals, vecs = lanczos_eigsh(mv, _v0(v0, n), k=k, iters=ncv_eff,
                                   which=which)
    elif which == "LM":
        va, ua = lanczos_eigsh(mv, _v0(v0, n), k=k, iters=ncv_eff,
                               which="LA")
        vs, us = lanczos_eigsh(mv, _v0(v0, n, seed=1), k=k, iters=ncv_eff,
                               which="SA")
        allv = np.concatenate([np.asarray(va), np.asarray(vs)])
        allu = jnp.concatenate([ua, us], axis=1)
        # dedupe pairs found from both ends, then top-k by magnitude
        order = np.argsort(-np.abs(allv), kind="stable")
        sel, seen = [], []
        for i in order:
            if any(abs(allv[i] - allv[j]) < 1e-9 * max(1, abs(allv[i]))
                   for j in seen):
                continue
            seen.append(i)
            sel.append(i)
            if len(sel) == k:
                break
        sel = np.asarray(sel)
        asc = sel[np.argsort(allv[sel])]
        vals, vecs = jnp.asarray(allv[asc]), allu[:, asc]
    elif which == "SM":
        raise SpSparseError("eigsh(which='SM') without sigma is the "
                            "slow-converging ARPACK trap; pass "
                            "sigma=0.0 for the shift-invert route")
    else:
        raise SpSparseError(f"which must be LA/SA/LM/SM, got {which!r}")
    return (vals, vecs) if return_eigenvectors else vals
