"""Spectral solvers: symmetric eigenpairs and singular triplets over any
matvec — the ``scipy.sparse.linalg.eigsh / lobpcg / svds`` capability tier,
built device-first.

No reference counterpart (citibeth/spsparse stops at the multiply chain);
these complete the iterative-solver story the way the reference's users
(regridding / conservative-interpolation pipelines) consume sparse
operators downstream: spectral bounds for Chebyshev, low-rank structure of
regridding operators, truncated SVDs of interpolation matrices.

Device-first design decisions (vs the textbook/scipy formulations):

* **Everything is a fixed-iteration ``lax.fori_loop``/``scan``** — no
  data-dependent convergence breaks; shapes are static; one compile.
* **Full reorthogonalization via CGS2** (two skinny ``(m, n) @ (n,)``
  matmuls per step) instead of modified Gram-Schmidt's serial dot chain —
  the same matmul-shaped choice as :func:`~.iterative.gmres_solve`, and
  on a device it is *cheaper* than selective reorthogonalization's
  branchy bookkeeping. Basis products run at full float32 precision
  (:func:`_mm`).
* **Small dense eigen/SVD problems** (the ``iters x iters`` tridiagonal /
  bidiagonal, LOBPCG's ``3k x 3k`` Rayleigh-Ritz) go through
  ``jnp.linalg`` — XLA runs these on-device; no host round trip.
* **Breakdown is masked, not branched**: a Lanczos/bidiagonalization
  breakdown (Krylov space exhausted) zeroes the dead basis rows; dead
  Ritz pairs are then identified *post hoc* by their ~0-norm Ritz vectors
  and pushed to the back of the selection order (see
  ``_mask_dead_ritz``). LOBPCG handles rank-deficient search spaces by
  eigenvalue-whitening the Gram matrix (pseudo-inverse square root)
  instead of scipy's try/except Cholesky fallback chain.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array

__all__ = ["lanczos_eigsh", "arnoldi_eigs", "lobpcg_solve",
           "svds_lanczos", "funm_multiply", "expm_multiply"]


def _mm(a: Array, b: Array) -> Array:
    """Basis products at full precision (a GPU would run float32 ``@`` in
    TF32, which breaks the reorthogonalization)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _cgs2(V: Array, w: Array, j, m: int):
    """Project ``w`` off the first ``j+1`` rows of ``V`` (CGS, applied
    twice). Rows past ``j`` are zero by construction so the mask keeps the
    projection exact under jit's static shapes."""
    mask = (jnp.arange(m) <= j).astype(w.dtype)
    w = w - _mm(_mm(V, w) * mask, V)
    w = w - _mm(_mm(V, w) * mask, V)
    return w


def _lanczos_decomp(matvec: Callable[[Array], Array], v0: Array,
                    iters: int):
    """Lanczos with full (CGS2) reorthogonalization.

    Returns ``(V, alpha, beta)`` with ``V (iters+1, n)`` orthonormal rows
    (dead rows zero after breakdown), ``alpha (iters,)`` diagonal and
    ``beta (iters,)`` off-diagonal of the tridiagonal ``T``
    (``beta[j]`` couples steps ``j`` and ``j+1``; ``beta[iters-1]`` is the
    residual coupling used for error bounds). On breakdown the dead
    ``alpha`` entries repeat the last valid Rayleigh quotient with zero
    coupling — the resulting spurious Ritz pairs have zero-norm Ritz
    vectors and are filtered by the callers."""
    n = v0.shape[0]
    dt = v0.dtype
    nrm0 = jnp.sqrt(jnp.vdot(v0, v0))
    V = jnp.zeros((iters + 1, n), dt).at[0].set(
        v0 / jnp.where(nrm0 == 0, 1, nrm0))
    alpha = jnp.zeros(iters, dt)
    beta = jnp.zeros(iters, dt)

    def step(j, carry):
        V, alpha, beta, alive, last_a = carry
        w = matvec(V[j])
        a = jnp.vdot(V[j], w)
        w = _cgs2(V, w, j, iters + 1)
        b_ = jnp.sqrt(jnp.vdot(w, w))
        tiny = jnp.asarray(1e-12, dt) * jnp.maximum(jnp.abs(a), 1)
        alive_next = alive & (b_ > tiny)
        a_eff = jnp.where(alive, a, last_a)
        V = V.at[j + 1].set(
            jnp.where(alive_next, w / jnp.where(b_ == 0, 1, b_), 0))
        return (V, alpha.at[j].set(a_eff),
                beta.at[j].set(jnp.where(alive_next, b_, 0)),
                alive_next, jnp.where(alive, a, last_a))

    V, alpha, beta, _, _ = jax.lax.fori_loop(
        0, iters, step,
        (V, alpha, beta, jnp.asarray(nrm0 > 0), jnp.zeros((), dt)))
    return V, alpha, beta


def _mask_dead_ritz(vals: Array, vec_norms: Array, largest: bool) -> Array:
    """Replace Ritz values whose Ritz vectors have ~zero norm (spurious
    post-breakdown pairs, see :func:`_lanczos_decomp`) with -/+inf so a
    subsequent top-k/bottom-k never selects them."""
    dead = vec_norms < 0.5
    bad = jnp.asarray(-jnp.inf if largest else jnp.inf, vals.dtype)
    return jnp.where(dead, bad, vals)


def lanczos_eigsh(matvec: Callable[[Array], Array], v0: Array, *,
                  k: int, iters: int | None = None,
                  which: str = "LA") -> tuple[Array, Array]:
    """``k`` extreme eigenpairs of a symmetric operator by Lanczos with
    full reorthogonalization (the ``scipy.sparse.linalg.eigsh``
    capability; same ``which`` convention for ``"LA"``/``"SA"``).

    ``iters`` (default ``min(max(2k + 16, 24), n)``) is the Krylov size —
    static, one compile. Cost per step: one ``matvec`` + two ``(iters, n)``
    skinny matmuls (CGS2). Returns ``(vals (k,), vecs (n, k))``, vals in
    scipy order (ascending), ``A @ vecs ~ vecs * vals``.

    Works over any local or distributed matvec; for row-partitioned
    operators pass vectors with a flat global layout (the basis matmuls
    and reductions shard cleanly under ``jit`` + sharding annotations)."""
    if which not in ("LA", "SA"):
        raise ValueError(f"which must be 'LA' or 'SA', got {which!r}")
    n = v0.shape[0]
    if iters is None:
        iters = min(max(2 * k + 16, 24), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    V, alpha, beta = _lanczos_decomp(matvec, v0, iters)
    T = (jnp.diag(alpha) + jnp.diag(beta[:-1], 1)
         + jnp.diag(beta[:-1], -1))
    w, Y = jnp.linalg.eigh(T)                       # ascending
    # Dead pairs (breakdown padding) have eigenvectors supported on the
    # zeroed V rows, so their LIFTED vectors have ~0 norm (Y's own columns
    # are always unit — eigh is orthonormal); lnorm is the live/dead
    # signal.
    lifted = _mm(V[:iters].T, Y)                    # (n, iters)
    lnorm = jnp.linalg.norm(lifted, axis=0)
    largest = which == "LA"
    w = _mask_dead_ritz(w, lnorm, largest)
    if largest:
        vals, sel = jax.lax.top_k(w, k)
        vals, sel = vals[::-1], sel[::-1]           # ascending, scipy-style
    else:
        nvals, sel = jax.lax.top_k(-w, k)           # -w descending ...
        vals = -nvals                               # ... = w ascending
    vecs = lifted[:, sel]
    vecs = vecs / jnp.maximum(jnp.linalg.norm(vecs, axis=0), 1e-30)
    return vals, vecs


def funm_multiply(matvec: Callable[[Array], Array], v: Array, *,
                  f: Callable[[Array], Array],
                  iters: int = 32) -> Array:
    """``f(A) @ v`` for a symmetric operator via the Lanczos
    approximation: with ``A V^T ~ V^T T`` on the Krylov basis,
    ``f(A) v ~ ||v|| * V^T f(T) e_1``; ``f`` is applied to the Ritz
    values of the small ``iters x iters`` tridiagonal (one on-device
    ``eigh``). This is the whole matrix-function family in one primitive
    — ``exp`` (:func:`expm_multiply`), ``sqrt`` (sampling Gaussians with
    sparse-precision covariance), ``log``, spectral filters — at the cost
    of ``iters`` matvecs + the CGS2 basis work.

    ``f`` must be defined on the operator's spectrum (e.g. ``jnp.sqrt``
    needs a PSD operator). Post-breakdown spurious Ritz pairs contribute
    nothing: their eigenvectors have zero first component (the ``e_1``
    weight), so no masking is needed. Fixed ``iters``, jit-compatible.

    No reference counterpart; completes the Krylov tier next to
    :func:`lanczos_eigsh` (same decomposition, different small-problem
    consumer)."""
    V, alpha, beta = _lanczos_decomp(matvec, v, iters)
    T = (jnp.diag(alpha) + jnp.diag(beta[:-1], 1)
         + jnp.diag(beta[:-1], -1))
    w, Y = jnp.linalg.eigh(T)
    nrm = jnp.sqrt(jnp.vdot(v, v))
    coeff = _mm(Y, jnp.asarray(f(w), Y.dtype) * Y[0, :])   # f(T) e_1
    return nrm * _mm(coeff, V[:iters])


def expm_multiply(matvec: Callable[[Array], Array], v: Array, *,
                  t: float = 1.0, iters: int = 32) -> Array:
    """``exp(t A) @ v`` for symmetric ``A`` by Lanczos
    (:func:`funm_multiply` with ``f = exp(t .)``) — the
    ``scipy.sparse.linalg.expm_multiply`` capability for the symmetric
    case (heat/diffusion propagation through a sparse operator)."""
    tt = jnp.asarray(t, v.dtype)
    return funm_multiply(matvec, v, f=lambda w: jnp.exp(tt * w),
                         iters=iters)


def _whiten(G: Array) -> tuple[Array, Array]:
    """Pseudo-inverse square root of a symmetric PSD Gram matrix by
    eigenvalue masking — LOBPCG's rank-deficiency guard (replaces scipy's
    Cholesky-with-fallbacks). Directions with eigenvalue below
    ``100*eps * max`` (dtype-relative: Gram noise scales with machine
    epsilon) are dropped (zero columns)."""
    g, U = jnp.linalg.eigh(G)
    gmax = jnp.maximum(g[-1], 0)
    eps_rel = 100 * jnp.finfo(G.dtype).eps
    ok = g > eps_rel * jnp.maximum(gmax, jnp.finfo(G.dtype).tiny)
    inv_sqrt = jnp.where(ok, 1 / jnp.sqrt(jnp.where(ok, g, 1)), 0)
    return U * inv_sqrt[None, :], ok


def lobpcg_solve(matmat: Callable[[Array], Array], X0: Array, *,
                 iters: int,
                 minv: Array | Callable[[Array], Array] | None = None,
                 largest: bool = False) -> tuple[Array, Array]:
    """Locally-optimal block preconditioned conjugate gradient (LOBPCG)
    for ``k`` extreme eigenpairs of a symmetric operator — the blocked,
    preconditionable alternative to :func:`lanczos_eigsh` (the
    ``scipy.sparse.linalg.lobpcg`` capability).

    Device shape: the operator is applied to the whole ``(n, k)`` block at
    once (amortizing the matrix stream exactly like
    :func:`~.iterative.cg_solve_mrhs`), and each iteration is one
    ``3k x 3k`` Rayleigh-Ritz problem built from two ``(n, 3k)`` skinny
    matmuls. Rank-deficient search spaces (converged directions, zero
    initial P) are handled by eigenvalue-whitening the Gram matrix — no
    Cholesky failure paths, jit-stable.

    ``minv``: Jacobi vector ``(n,)``, or callable ``(n, k) -> (n, k)``.
    Returns ``(vals (k,), X (n, k))``, vals ascending when
    ``largest=False`` (the default: smallest pairs, scipy's
    ``largest=False`` mode), descending when ``largest=True``."""
    if X0.ndim != 2:
        raise ValueError(f"X0 must be (n, k), got {X0.shape}")
    n, k = X0.shape
    dt = X0.dtype
    if minv is None:
        apply_m = lambda r: r                                 # noqa: E731
    elif callable(minv):
        apply_m = minv
    else:
        mv = jnp.asarray(minv)
        apply_m = lambda r: mv[:, None] * r                   # noqa: E731

    def rr(S, AS):
        """Rayleigh-Ritz on the (whitened) span of S's columns. Dropped
        (rank-deficient) directions leave zero rows/cols in the whitened
        M whose spurious 0 eigenvalues would win the *smallest* selection;
        a large diagonal penalty pushes them past the far end instead."""
        W, ok = _whiten(_mm(S.T, S))
        M = _mm(_mm(W.T, _mm(S.T, AS)), W)
        big = jnp.asarray(1, M.dtype) / jnp.finfo(M.dtype).eps ** 2
        pen = jnp.where(ok, 0, -big if largest else big)
        M = M + jnp.diag(pen.astype(M.dtype))
        w, Y = jnp.linalg.eigh(M)
        if largest:
            w, Y = w[::-1], Y[:, ::-1]
        C = _mm(W, Y[:, :k])                                  # (cols, k)
        return w[:k], C

    # Initial Rayleigh-Ritz on X0 alone.
    X = X0
    AX = matmat(X)
    lam, C = rr(X, AX)
    X, AX = _mm(X, C), _mm(AX, C)
    P = jnp.zeros_like(X)
    AP = jnp.zeros_like(X)

    def body(carry, _):
        X, AX, P, AP, lam = carry
        R = AX - X * lam[None, :]
        Wd = apply_m(R)
        # Project the preconditioned residual off X (keeps the Gram matrix
        # well-scaled; full orthonormality comes from the whitening).
        Wd = Wd - _mm(X, _mm(X.T, Wd))
        wn = jnp.linalg.norm(Wd, axis=0)
        Wd = Wd / jnp.maximum(wn, 1e-30)[None, :]
        AW = matmat(Wd)
        S = jnp.concatenate([X, Wd, P], axis=1)               # (n, 3k)
        AS = jnp.concatenate([AX, AW, AP], axis=1)
        lam_new, C = rr(S, AS)
        Xn = _mm(S, C)
        AXn = _mm(AS, C)
        # P = the W+P contribution to the new X (standard LOBPCG three-term
        # recurrence): zero the X-block rows of C.
        Cp = C.at[:k, :].set(0)
        Pn = _mm(S, Cp)
        APn = _mm(AS, Cp)
        return (Xn, AXn, Pn, APn, lam_new), lam_new

    (X, AX, _, _, lam), _ = jax.lax.scan(
        body, (X, AX, P, AP, lam), None, length=iters)
    # Final residual-free normalization.
    nr = jnp.maximum(jnp.linalg.norm(X, axis=0), 1e-30)
    return lam.astype(dt), X / nr[None, :]


def svds_lanczos(matvec: Callable[[Array], Array],
                 rmatvec: Callable[[Array], Array], v0: Array, *,
                 k: int, iters: int | None = None
                 ) -> tuple[Array, Array, Array]:
    """Top-``k`` singular triplets of a (sparse) operator by Golub-Kahan
    bidiagonalization with full CGS2 reorthogonalization of BOTH bases
    (the ``scipy.sparse.linalg.svds`` capability).

    ``matvec: (n,) -> (m,)`` applies ``A``; ``rmatvec: (m,) -> (n,)``
    applies ``A^T``; ``v0 (n,)`` seeds the right basis. ``iters`` is the
    bidiagonalization length (default ``min(max(2k + 16, 24), n)``).

    Returns ``(U (m, k), s (k,), Vt (k, n))`` with singular values
    descending, ``A ~ U @ diag(s) @ Vt`` on the dominant subspace."""
    n = v0.shape[0]
    dt = v0.dtype
    if iters is None:
        iters = min(max(2 * k + 16, 24), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    m = matvec(v0).shape[0]

    nrm0 = jnp.sqrt(jnp.vdot(v0, v0))
    Vb = jnp.zeros((iters, n), dt).at[0].set(
        v0 / jnp.where(nrm0 == 0, 1, nrm0))
    Ub = jnp.zeros((iters, m), dt)
    alpha = jnp.zeros(iters, dt)                # A v_j = a_j u_j + ...
    beta = jnp.zeros(iters, dt)                 # A^T u_j = a_j v_j + b_j v_{j+1}

    def step(j, carry):
        Vb, Ub, alpha, beta, alive = carry
        # u_j from A v_j, orthogonalized against previous u's.
        p = matvec(Vb[j])
        p = _cgs2(Ub, p, j - 1, iters)          # project off u_0..u_{j-1}
        a = jnp.sqrt(jnp.vdot(p, p))
        ok_a = alive & (a > 1e-12)
        u = jnp.where(ok_a, p / jnp.where(a == 0, 1, a), 0)
        Ub = Ub.at[j].set(u)
        # v_{j+1} from A^T u_j, orthogonalized against previous v's.
        q = rmatvec(u)
        q = _cgs2(Vb, q, j, iters)
        b_ = jnp.sqrt(jnp.vdot(q, q))
        ok_b = ok_a & (b_ > 1e-12)
        Vb = jax.lax.cond(
            j + 1 < iters,
            lambda Vb: Vb.at[jnp.minimum(j + 1, iters - 1)].set(
                jnp.where(ok_b, q / jnp.where(b_ == 0, 1, b_), 0)),
            lambda Vb: Vb, Vb)
        return (Vb, Ub, alpha.at[j].set(jnp.where(ok_a, a, 0)),
                beta.at[j].set(jnp.where(ok_b, b_, 0)), ok_a)

    Vb, Ub, alpha, beta, _ = jax.lax.fori_loop(
        0, iters, step, (Vb, Ub, alpha, beta, jnp.asarray(nrm0 > 0)))

    # With this recurrence (u_j from A v_j; v_{j+1} from A^T u_j):
    #   A^T u_j = a_j v_j + b_j v_{j+1}
    #   =>  u_{j-1}^T A v_j = b_{j-1},  u_j^T A v_j = a_j, others 0,
    # so B[i, j] = u_i^T A v_j is UPPER bidiagonal (diag alpha, superdiag
    # beta) and  A @ Vb.T = Ub.T @ B  on the computed bases.
    B = jnp.diag(alpha) + jnp.diag(beta[:-1], 1)
    Pb, s, Qt = jnp.linalg.svd(B)               # B = Pb s Qt, descending
    # Dead directions: zero basis rows make lifted vectors short.
    Uk_full = _mm(Ub.T, Pb)                      # (m, iters)
    Vk_full = _mm(Vb.T, Qt.T)                    # (n, iters)
    un = jnp.linalg.norm(Uk_full, axis=0)
    vn = jnp.linalg.norm(Vk_full, axis=0)
    s = jnp.where((un > 0.5) & (vn > 0.5), s, 0)
    order = jnp.argsort(-s)[:k]
    s_k = s[order]
    U = Uk_full[:, order]
    Vt = Vk_full[:, order].T
    U = U / jnp.maximum(jnp.linalg.norm(U, axis=0), 1e-30)[None, :]
    Vt = Vt / jnp.maximum(jnp.linalg.norm(Vt, axis=1), 1e-30)[:, None]
    return U, s_k, Vt


# ----------------------------------------------------------------------
# Nonsymmetric eigenpairs: explicitly-restarted Arnoldi
# ----------------------------------------------------------------------

def _arnoldi_decomp(matvec: Callable[[Array], Array], v0: Array,
                    iters: int):
    """Arnoldi with CGS2 reorthogonalization: returns ``(V, H)`` with
    ``V (iters+1, n)`` orthonormal rows and ``H (iters+1, iters)``
    upper-Hessenberg, ``A V[:m].T = V.T H`` (dead rows zero after an
    invariant-subspace breakdown, mirroring :func:`_lanczos_decomp`).
    Device-resident, one compile per (n, iters)."""
    n = v0.shape[0]
    dt = v0.dtype
    m = iters
    nrm0 = jnp.sqrt(jnp.vdot(v0, v0))
    V = jnp.zeros((m + 1, n), dt).at[0].set(
        v0 / jnp.where(nrm0 == 0, 1, nrm0))
    H = jnp.zeros((m + 1, m), dt)

    def step(j, carry):
        V, H, alive = carry
        w = matvec(V[j])
        mask = (jnp.arange(m + 1) <= j).astype(dt)
        h1 = _mm(V, w) * mask
        w = w - _mm(h1, V)
        h2 = _mm(V, w) * mask          # CGS second pass
        w = w - _mm(h2, V)
        h = h1 + h2
        b_ = jnp.sqrt(jnp.vdot(w, w))
        scale = jnp.maximum(jnp.max(jnp.abs(h)), 1)
        alive_next = alive & (b_ > jnp.asarray(1e-12, dt) * scale)
        V = V.at[j + 1].set(
            jnp.where(alive_next, w / jnp.where(b_ == 0, 1, b_), 0))
        hcol = jnp.where(alive, h.at[j + 1].set(
            jnp.where(alive_next, b_, 0)), 0)
        return V, H.at[:, j].set(hcol), alive_next

    V, H, _ = jax.lax.fori_loop(0, m, step, (V, H, jnp.asarray(nrm0 > 0)))
    return V, H


def _select_ritz(w, which: str, k: int):
    """Indices of the k wanted Ritz values (scipy's which codes)."""
    import numpy as np
    key = {"LM": -np.abs(w), "SM": np.abs(w),
           "LR": -w.real, "SR": w.real,
           "LI": -w.imag, "SI": w.imag}.get(which)
    if key is None:
        raise ValueError(f"which must be one of LM/SM/LR/SR/LI/SI, "
                         f"got {which!r}")
    return np.argsort(key, kind="stable")[:k]


def arnoldi_eigs(matvec: Callable[[Array], Array], v0: Array, *, k: int = 6,
                 which: str = "LM", iters: int | None = None,
                 restarts: int = 8, tol: float = 1e-10):
    """``k`` eigenpairs of a general (nonsymmetric) operator — the
    ``scipy.sparse.linalg.eigs`` capability (same ``which`` codes,
    complex output).

    Host/device split: the Krylov decomposition (matvecs + skinny CGS2
    matmuls) runs on device (:func:`_arnoldi_decomp`); the small
    ``(iters, iters)`` Hessenberg eigenproblem runs on the host
    (numpy — complex Schur work is not a device shape). Convergence is by
    *explicit* restarts — the start vector is re-seeded with the sum of
    the wanted Ritz vectors and the decomposition re-run (``restarts``
    cycles, each one compile-cached) — rather than ARPACK's implicit
    QR shifts; with ``tol > 0`` cycles stop early once every wanted
    pair's residual bound ``|h_{m+1,m}| |y_m|`` is below
    ``tol * |ritz|``. Eager / host-returning; the jittable symmetric
    path is :func:`lanczos_eigsh`.

    Returns ``(vals (k,) complex, vecs (n, k) complex)``, wanted-order
    like scipy (no further sorting guarantee within ties)."""
    import numpy as np
    n = v0.shape[0]
    if iters is None:
        iters = min(max(3 * k + 20, 36), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    m = iters
    v = jnp.asarray(v0)
    vals = vecs = None
    for _ in range(max(1, restarts)):
        V, H = _arnoldi_decomp(matvec, v, m)
        Hn = np.asarray(H)
        Vn = np.asarray(V)
        w, Y = np.linalg.eig(Hn[:m, :m])
        lifted = Vn[:m].T @ Y                       # (n, m) complex
        lnorm = np.linalg.norm(lifted, axis=0)
        # spurious post-breakdown pairs -> push to the unwanted end.
        # The sentinel must be worst under the *specific* sort key
        # (_select_ritz): 0 is only safe for LM (|0| minimal) — for
        # LR/LI a 0 sentinel would outrank genuinely negative-real/imag
        # eigenvalues, and for SI a +inf real sentinel has imag 0.
        dead = lnorm < 0.5
        sent = {"LM": 0.0, "SM": np.inf,
                "LR": complex(-np.inf, 0.0), "SR": complex(np.inf, 0.0),
                "LI": complex(0.0, -np.inf),
                "SI": complex(0.0, np.inf)}.get(which, 0.0)
        # (unknown `which` falls through to _select_ritz's ValueError)
        w = np.where(dead, sent, w)
        sel = _select_ritz(w, which, k)
        vals = w[sel]
        vecs = lifted[:, sel] / np.where(lnorm[sel] == 0, 1, lnorm[sel])
        res = np.abs(Hn[m, m - 1]) * np.abs(Y[m - 1, sel])
        if tol > 0 and np.all(res <= tol * np.maximum(np.abs(vals), 1e-30)):
            break
        # explicit restart: re-seed with the wanted Ritz directions
        seed = vecs.real.sum(axis=1) + vecs.imag.sum(axis=1)
        nr = np.linalg.norm(seed)
        if nr == 0:
            break
        v = jnp.asarray(seed / nr, jnp.asarray(v0).dtype)
    return vals, vecs
