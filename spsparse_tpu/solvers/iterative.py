"""Iterative solvers over sparse operators (single- and multi-chip).

The reference library stops at the multiply chain; real deployments of a
sparse framework run *iterations* of those products (conservative-regridding
pipelines, solvers). These are the end-to-end drivers used by the benchmark
harness and the multi-chip dry run: conjugate gradients and power iteration,
formulated so the matrix operator is pluggable — a local CSR/ELL SpMV or a
row-partitioned :func:`spsparse_tpu.dist.dist_spmv` under ``shard_map``.

Everything is functional and ``lax.scan``-friendly: no data-dependent
Python control flow, fixed iteration counts, carries as pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

Array = Any

__all__ = ["CGState", "cg_step", "cg_solve", "pcg_solve", "cg_solve_mrhs",
           "jacobi_preconditioner", "power_iteration", "bicgstab_solve",
           "chebyshev_solve", "gmres_solve", "lanczos_bounds",
           "cg_solve_implicit"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CGState:
    x: Array = dataclasses.field(metadata=dict(static=False))
    r: Array = dataclasses.field(metadata=dict(static=False))
    p: Array = dataclasses.field(metadata=dict(static=False))
    rs: Array = dataclasses.field(metadata=dict(static=False))


def safe_div(num, den):
    """``num / den`` with 0 where ``den == 0`` — the masked-denominator
    breakdown guard shared by every fixed-iteration solver here (a
    converged/broken-down iterate carries unchanged instead of producing
    NaNs that poison the remaining iterations)."""
    ok = den != 0
    return jnp.where(ok, num / jnp.where(ok, den, 1), 0)


def cg_step(matvec: Callable[[Array], Array], state: CGState) -> CGState:
    """One conjugate-gradient iteration for SPD ``A``.

    ``matvec`` may be a local SpMV or a distributed one; the reductions are
    plain ``jnp`` sums, which XLA turns into cross-device ``psum``s when the
    operands are sharded.
    """
    Ap = matvec(state.p)
    denom = jnp.vdot(state.p, Ap)
    alpha = state.rs / jnp.where(denom == 0, 1, denom)
    x = state.x + alpha * state.p
    r = state.r - alpha * Ap
    rs_new = jnp.vdot(r, r)
    beta = rs_new / jnp.where(state.rs == 0, 1, state.rs)
    p = r + beta * state.p
    return CGState(x=x, r=r, p=p, rs=rs_new)


def cg_solve(matvec: Callable[[Array], Array], b: Array, *, iters: int,
             x0: Array | None = None) -> tuple[Array, Array]:
    """Fixed-iteration CG; returns ``(x, final_residual_norm_sq)``."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    state = CGState(x=x0, r=r0, p=r0, rs=jnp.vdot(r0, r0))

    def body(state, _):
        return cg_step(matvec, state), None

    state, _ = jax.lax.scan(body, state, None, length=iters)
    return state.x, state.rs


def pcg_solve(matvec: Callable[[Array], Array], b: Array, *, iters: int,
              minv: Array | Callable[[Array], Array] | None = None,
              x0: Array | None = None) -> tuple[Array, Array]:
    """Preconditioned CG: ``minv`` is the preconditioner application —
    either a dense vector (Jacobi: elementwise ``1/diag(A)``) or a callable
    ``z = M^{-1} r``. Falls back to plain CG when ``minv`` is None."""
    if minv is None:
        return cg_solve(matvec, b, iters=iters, x0=x0)
    apply_m = minv if callable(minv) else (lambda r: minv * r)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    z0 = apply_m(r0)
    state = (x0, r0, z0, jnp.vdot(r0, z0))

    def body(state, _):
        x, r, p, rz = state
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(denom == 0, 1, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, r, _, _), _ = jax.lax.scan(body, state, None, length=iters)
    return x, jnp.vdot(r, r)


def cg_solve_mrhs(matmat: Callable[[Array], Array], B: Array, *,
                  iters: int, minv: Array | Callable[[Array], Array]
                  | None = None, x0: Array | None = None
                  ) -> tuple[Array, Array]:
    """Batched (multi-RHS) preconditioned CG: solve ``A X = B`` for an SPD
    operator and ``B`` of shape ``(n, k)``, all ``k`` systems advanced in
    lockstep with *per-column* step lengths.

    Why this exists: the operator application dominates a CG iteration,
    and a multi-RHS operator amortizes the matrix stream across columns —
    :func:`ops.best_spmm` on a DIA operator reads each diagonal once for
    all ``k`` columns. ``matmat`` maps ``(n, k) -> (n, k)``:
    :func:`ops.best_spmm`, or any dense matmul. This is the block-Krylov building block the reference's
    single-element iteration model cannot express (no reference counterpart;
    the closest is the ``#if 0``'d dense-vector multiply sketch,
    /root/reference/slib/spsparse/multiply_dense.hpp:8-36).

    Each column follows exactly the mathematics of :func:`pcg_solve` (this
    is k independent CGs sharing operator applications, not O'Leary block
    CG — no cross-column coupling, so one column's breakdown never poisons
    the others; a converged column carries unchanged through the remaining
    iterations via the same masked-denominator guards as :func:`cg_step`).
    ``minv`` is a per-row vector (Jacobi), an ``(n, k)``-broadcastable
    array, or a callable ``Z = M^{-1} R``. Returns ``(X, rs)`` with ``rs``
    the per-column final ``||r||^2`` (shape ``(k,)``).

    ``B`` may also carry extra leading axes with columns LAST — e.g. the
    row-partitioned ``(P, rows_local, k)`` layout of
    :func:`spsparse_tpu.dist.dist_spmm_bucketed` — so one batched CG can
    drive k distributed solves; the per-column reductions sum over every
    axis but the last (a global ``psum`` under ``shard_map``).
    """
    if B.ndim < 2:
        raise ValueError(f"cg_solve_mrhs expects B of shape (..., n, k), "
                         f"got {B.shape}")
    if minv is None or callable(minv):
        apply_m = (lambda r: r) if minv is None else minv
    else:
        # Per-row array (Jacobi): anything one axis short of B broadcasts
        # across columns — (n,) for the (n, k) layout, (P, blk) for the
        # partitioned (P, blk, k) layout; its shape must equal B's row
        # shape exactly (a (k,) per-COLUMN vector is NOT per-row and would
        # otherwise be misapplied silently when n == k). Full-rank arrays
        # must broadcast against B.
        mv = jnp.asarray(minv)
        if mv.ndim == B.ndim - 1:
            if mv.shape != B.shape[:-1]:
                raise ValueError(
                    f"cg_solve_mrhs: per-row minv must have shape "
                    f"B.shape[:-1] = {B.shape[:-1]}, got {mv.shape}; for a "
                    f"per-column preconditioner pass shape (1, k) or a "
                    f"callable")
            apply_m = lambda r: mv[..., None] * r  # noqa: E731
        else:
            try:
                np.broadcast_shapes(mv.shape, B.shape)
            except ValueError:
                raise ValueError(
                    f"cg_solve_mrhs: minv shape {mv.shape} does not "
                    f"broadcast against B shape {B.shape}") from None
            apply_m = lambda r: mv * r  # noqa: E731

    def col_dot(u, v):
        return jnp.sum(u * v, axis=tuple(range(u.ndim - 1)))

    x0 = jnp.zeros_like(B) if x0 is None else x0
    r0 = B - matmat(x0)
    z0 = apply_m(r0)
    state = (x0, r0, z0, col_dot(r0, z0))

    def body(state, _):
        x, r, p, rz = state
        Ap = matmat(p)
        denom = col_dot(p, Ap)
        alpha = rz / jnp.where(denom == 0, 1, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = col_dot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, r, _, _), _ = jax.lax.scan(body, state, None, length=iters)
    return x, col_dot(r, r)


def jacobi_preconditioner(diag: Array, eps: float = 1e-12) -> Array:
    """Elementwise inverse-diagonal preconditioner vector for
    :func:`pcg_solve` (guards zero diagonal entries)."""
    return jnp.where(jnp.abs(diag) > eps, 1.0 / diag, 1.0)


def bicgstab_solve(matvec: Callable[[Array], Array], b: Array, *,
                   iters: int, minv: Array | Callable[[Array], Array]
                   | None = None, x0: Array | None = None
                   ) -> tuple[Array, Array]:
    """BiCGStab for general (non-symmetric) ``A`` — CG covers only the SPD
    case; regridding operators composed with their transposes are SPD, but
    raw interpolation matrices are not. Fixed iteration count, scan-carried
    state, optional (right-applied, van der Vorst form) preconditioner.
    Returns ``(x, final_residual_norm_sq)``.

    Breakdown guards: the rho/omega denominators are masked like
    :func:`cg_step`'s; a converged/broken-down iterate carries unchanged
    (alpha,beta become 0/finite), matching the fixed-iteration contract.
    """
    apply_m = ((lambda r: r) if minv is None
               else minv if callable(minv) else (lambda r: minv * r))
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rhat = r0

    def body(state, _):
        x, r, p, v, rho, alpha, omega = state
        rho_new = jnp.vdot(rhat, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        ph = apply_m(p)
        v = matvec(ph)
        alpha = safe_div(rho_new, jnp.vdot(rhat, v))
        s = r - alpha * v
        sh = apply_m(s)
        t = matvec(sh)
        omega = safe_div(jnp.vdot(t, s), jnp.vdot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega), None

    one = jnp.ones((), b.dtype)
    state = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one)
    (x, r, *_), _ = jax.lax.scan(body, state, None, length=iters)
    return x, jnp.vdot(r, r)


def cgs_solve(matvec: Callable[[Array], Array], b: Array, *,
              iters: int, minv: Array | Callable[[Array], Array]
              | None = None, x0: Array | None = None
              ) -> tuple[Array, Array]:
    """Conjugate Gradient Squared (Sonneveld) for general ``A`` — the
    transpose-free cousin of BiCG (scipy.sparse.linalg.cgs): two matvecs
    per iteration, no ``A^T`` stream (a second transposed operator stream
    would double the memory traffic, which is why the transpose-free
    variants are the ones shipped — see also :func:`tfqmr_solve`).
    Convergence is faster than BiCGStab when it converges but the squared
    polynomial makes residuals oscillate; prefer BiCGStab/GMRES when
    smooth decay matters. Fixed ``iters`` under ``lax.scan`` with the
    same ``safe_div`` breakdown masking as :func:`bicgstab_solve`.
    Returns ``(x, final_residual_norm_sq)`` of the recurrence residual.
    """
    apply_m = ((lambda r: r) if minv is None
               else minv if callable(minv) else (lambda r: minv * r))
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rtld = r0

    def body(state, _):
        x, r, p, q, rho = state
        rho_new = jnp.vdot(rtld, r)
        beta = safe_div(rho_new, rho)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        vhat = matvec(apply_m(p))
        alpha = safe_div(rho_new, jnp.vdot(rtld, vhat))
        q = u - alpha * vhat
        uhat = apply_m(u + q)
        x = x + alpha * uhat
        r = r - alpha * matvec(uhat)
        return (x, r, p, q, rho_new), None

    one = jnp.ones((), b.dtype)
    state = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one)
    (x, r, *_), _ = jax.lax.scan(body, state, None, length=iters)
    return x, jnp.vdot(r, r)


def tfqmr_solve(matvec: Callable[[Array], Array], b: Array, *,
                iters: int, x0: Array | None = None
                ) -> tuple[Array, Array]:
    """Transpose-Free QMR (Freund 1993; scipy.sparse.linalg.tfqmr) for
    general ``A``: CGS's two matvecs per iteration but with the
    quasi-minimal-residual smoothing, so the residual decays monotonely
    instead of oscillating. No ``A^T`` needed (see :func:`cgs_solve` for
    why the transpose-free variants are the shipped menu; QMR/BiCG
    proper are deliberately not shipped — their ``A^T`` stream doubles
    operator traffic and TFQMR/CGS dominate them in practice).

    Fixed ``iters`` (each = one even+odd half-step pair) under
    ``lax.scan``; ``safe_div`` masks Lanczos breakdowns. Returns
    ``(x, true_final_residual_norm_sq)`` (one extra matvec at the end —
    the QMR ``tau`` only bounds the residual)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    dt = b.dtype
    rtld = r0

    def half(x, d, w, tau, theta, eta, y, Ay, alpha):
        w = w - alpha * Ay
        d = y + safe_div(theta * theta * eta, alpha) * d
        theta = safe_div(jnp.sqrt(jnp.vdot(w, w)), tau)
        c2 = safe_div(jnp.ones((), dt), 1 + theta * theta)
        tau = tau * theta * jnp.sqrt(c2)
        eta = c2 * alpha
        x = x + eta * d
        return x, d, w, tau, theta, eta

    def body(state, _):
        x, w, y1, Ay1, v, d, tau, theta, eta, rho = state
        sigma = jnp.vdot(rtld, v)
        alpha = safe_div(rho, sigma)
        y2 = y1 - alpha * v
        Ay2 = matvec(y2)
        # NB the odd half-step needs A@y1 itself — v only equals A@y1 on
        # the very first iteration (afterwards v is the CGS direction
        # image A@p), so Ay1 is carried explicitly.
        x, d, w, tau, theta, eta = half(x, d, w, tau, theta, eta,
                                        y1, Ay1, alpha)
        x, d, w, tau, theta, eta = half(x, d, w, tau, theta, eta,
                                        y2, Ay2, alpha)
        rho_new = jnp.vdot(rtld, w)
        beta = safe_div(rho_new, rho)
        y1 = w + beta * y2
        Ay1 = matvec(y1)
        v = Ay1 + beta * (Ay2 + beta * v)
        return (x, w, y1, Ay1, v, d, tau, theta, eta, rho_new), None

    tau0 = jnp.sqrt(jnp.vdot(r0, r0))
    Ar0 = matvec(r0)
    state = (x0, r0, r0, Ar0, Ar0, jnp.zeros_like(b), tau0,
             jnp.zeros((), dt), jnp.zeros((), dt), jnp.vdot(rtld, r0))
    (x, *_), _ = jax.lax.scan(body, state, None, length=iters)
    r = b - matvec(x)
    return x, jnp.vdot(r, r)


def minres_solve(matvec: Callable[[Array], Array], b: Array, *,
                 iters: int, x0: Array | None = None
                 ) -> tuple[Array, Array]:
    """MINRES (Paige & Saunders) for symmetric — possibly *indefinite* —
    operators: CG requires positive definiteness, BiCGStab/GMRES pay for
    generality they don't need on a symmetric saddle-point or shifted
    operator. One matvec + O(n) vector work per iteration; Lanczos
    tridiagonalization with an implicit QR via carried Givens rotations.

    Fixed ``iters`` under ``lax.scan`` (static shapes); breakdown/early
    convergence (``beta -> 0``) freezes the iterate via masked updates,
    matching the fixed-iteration contract of :func:`cg_solve`. Returns
    ``(x, rnorm_sq_estimate)`` (the recurrence's ``|eta|^2``, which tracks
    ``||b - A x||^2`` in exact arithmetic)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x0)
    beta1 = jnp.sqrt(jnp.vdot(r, r))
    dt = b.dtype
    one = jnp.ones((), dt)
    zero = jnp.zeros((), dt)
    v = r * safe_div(one, beta1)
    state = (x0, v, jnp.zeros_like(b),          # x, v_j, v_{j-1}
             jnp.zeros_like(b), jnp.zeros_like(b),  # w, w_prev
             zero,                               # beta_j (0 on entry)
             one, one, zero, zero,               # c, c_old, s, s_old
             beta1,                              # eta (residual estimate)
             beta1 > 0)                          # alive

    def body(state, _):
        (x, v, v_prev, w, w_prev, beta, c, c_old, s, s_old, eta,
         alive) = state
        Av = matvec(v)
        alpha = jnp.vdot(v, Av)
        r_next = Av - alpha * v - beta * v_prev
        beta_n = jnp.sqrt(jnp.vdot(r_next, r_next))
        # Apply the two previous rotations to the new tridiagonal column,
        # then form the rotation eliminating beta_{j+1}.
        rho1_hat = c * alpha - c_old * s * beta
        rho1 = jnp.sqrt(rho1_hat**2 + beta_n**2)
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        c_new = safe_div(rho1_hat, rho1)
        s_new = safe_div(beta_n, rho1)
        w_next = (v - rho3 * w_prev - rho2 * w) * safe_div(one, rho1)
        upd = alive & (rho1 != 0)
        x = jnp.where(upd, x + (c_new * eta) * w_next, x)
        eta = jnp.where(upd, -s_new * eta, eta)
        alive_next = upd & (beta_n > 0)
        v_next = r_next * safe_div(one, beta_n)
        return (x, jnp.where(alive_next, v_next, v),
                jnp.where(alive_next, v, v_prev),
                jnp.where(upd, w_next, w), jnp.where(upd, w, w_prev),
                jnp.where(alive_next, beta_n, beta),
                jnp.where(upd, c_new, c), jnp.where(upd, c, c_old),
                jnp.where(upd, s_new, s), jnp.where(upd, s, s_old),
                eta, alive_next), None

    (x, *_, eta, _), _ = jax.lax.scan(body, state, None, length=iters)
    return x, eta**2


def chebyshev_solve(matvec: Callable[[Array], Array], b: Array, *,
                    lam_min: float, lam_max: float, iters: int,
                    x0: Array | None = None) -> tuple[Array, Array]:
    """Chebyshev semi-iteration for SPD ``A`` with spectrum inside
    ``[lam_min, lam_max]`` (e.g. from :func:`power_iteration` plus a
    Gershgorin lower bound). Needs NO inner products — on a device mesh
    that removes every per-iteration ``psum`` latency barrier that CG
    pays, which is why it is the classic communication-avoiding smoother.
    Returns ``(x, final_residual_norm_sq)`` (one reduction at the end)."""
    theta = (lam_max + lam_min) / 2
    delta = (lam_max - lam_min) / 2
    sigma1 = theta / delta
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    d0 = r0 / theta

    def body(state, _):
        x, d, r, rho = state
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        return (x, d, r, rho_new), None

    state = (x0, d0, r0, jnp.asarray(1.0 / sigma1, b.dtype))
    # The scan body applies one update and prepares the next direction;
    # the post-loop flush applies the last one, so `length=iters-1` gives
    # exactly `iters` solution updates (matching every other solver's
    # fixed-iteration contract).
    (x, d, r, _), _ = jax.lax.scan(body, state, None,
                                   length=max(iters - 1, 0))
    x = x + d
    r = r - matvec(d)
    return x, jnp.vdot(r, r)


def cg_solve_implicit(matvec: Callable[[Array], Array], b: Array, *,
                      iters: int,
                      minv: Array | Callable[[Array], Array] | None = None
                      ) -> Array:
    """:func:`cg_solve`/:func:`pcg_solve` wrapped in
    ``lax.custom_linear_solve`` — gradients flow by the implicit function
    theorem (one more CG solve on the cotangent) instead of unrolling
    ``iters`` SpMVs through autodiff.

    Unrolled-CG backprop stores every iterate (O(iters * n) residency —
    rematerialization pressure at the 1M-row scales this library targets)
    and differentiates a long serial chain; the implicit form's backward
    pass is a single solve with the *same* operator (SPD ⇒ symmetric), so
    memory is O(n) and backward cost equals forward cost. Differentiable
    w.r.t. ``b`` and any parameters closed over by ``matvec``.
    Returns ``x`` only (residual monitoring belongs to the explicit
    functions)."""
    def solve(mv, rhs):
        return pcg_solve(mv, rhs, iters=iters, minv=minv)[0]

    return jax.lax.custom_linear_solve(matvec, b, solve, symmetric=True)


def lanczos_bounds(matvec: Callable[[Array], Array], v0: Array, *,
                   iters: int = 30,
                   safety: float = 1.05) -> tuple[Array, Array]:
    """Estimated ``(lam_min, lam_max)`` of an SPD operator by Lanczos with
    full reorthogonalization — the natural input to
    :func:`chebyshev_solve`. Ritz values of the ``iters x iters``
    tridiagonal underestimate the extreme eigenvalues, so the returned
    interval is widened by ``safety`` (max scaled up, min scaled down;
    Chebyshev only needs an *enclosing* interval to converge).

    Full reorthogonalization costs two skinny matmuls per step (same CGS2
    pattern as :func:`gmres_solve`) and keeps the basis usable at the
    small fixed ``iters`` this needs. Static shapes; jit-compatible."""
    n = v0.shape[0]
    dt = v0.dtype
    nrm0 = jnp.sqrt(jnp.vdot(v0, v0))
    V = jnp.zeros((iters + 1, n), dt).at[0].set(
        v0 / jnp.where(nrm0 == 0, 1, nrm0))
    alpha = jnp.zeros(iters, dt)
    beta = jnp.zeros(iters, dt)          # beta[j] couples step j to j+1

    def step(j, carry):
        V, alpha, beta, alive, last_a = carry
        w = matvec(V[j])
        a = jnp.vdot(V[j], w)
        mask = (jnp.arange(iters + 1) <= j).astype(dt)
        w = w - ((V @ w) * mask) @ V
        w = w - ((V @ w) * mask) @ V     # second pass (CGS2)
        b_ = jnp.sqrt(jnp.vdot(w, w))
        # Lanczos BREAKDOWN (b_ ~ 0: the Krylov space is exhausted — v0
        # touched an invariant subspace) must not write zero rows into T:
        # a zero diagonal entry injects a spurious Ritz value 0 that
        # wrecks lam_min. Dead steps repeat the last valid Rayleigh
        # quotient (inside the true spectrum) with zero coupling.
        tiny = jnp.asarray(1e-12, dt) * jnp.maximum(jnp.abs(a), 1)
        alive_next = alive & (b_ > tiny)
        a_eff = jnp.where(alive, a, last_a)
        b_eff = jnp.where(alive_next, b_, 0)
        V = V.at[j + 1].set(
            jnp.where(alive_next, w / jnp.where(b_ == 0, 1, b_), 0))
        return (V, alpha.at[j].set(a_eff), beta.at[j].set(b_eff),
                alive_next, jnp.where(alive, a, last_a))

    V, alpha, beta, _, _ = jax.lax.fori_loop(
        0, iters, step,
        (V, alpha, beta, jnp.asarray(nrm0 > 0), jnp.zeros((), dt)))
    T = (jnp.diag(alpha) + jnp.diag(beta[:-1], 1) + jnp.diag(beta[:-1], -1))
    ritz = jnp.linalg.eigvalsh(T)
    return ritz[0] / safety, ritz[-1] * safety


def gmres_solve(matvec: Callable[[Array], Array], b: Array, *,
                m: int = 20, restarts: int = 4,
                minv: Array | Callable[[Array], Array] | None = None,
                x0: Array | None = None) -> tuple[Array, Array]:
    """Restarted GMRES(m) for general ``A`` — the robust non-symmetric
    Krylov method (no BiCGStab-style breakdown). Fixed ``m`` and
    ``restarts`` keep every shape static for ``jit``.

    The Arnoldi basis ``V (m+1, n)`` is built with vectorized classical
    Gram-Schmidt *reorthogonalized once* (CGS2 — one extra ``V @ w`` pair,
    which is two skinny matmuls instead of MGS's ``m`` serial
    dots; CGS2 restores MGS-level orthogonality loss). The small
    ``(m+1, m)`` least-squares problem is solved densely per restart.
    Right preconditioning (``x = M^{-1} u``), like :func:`bicgstab_solve`.
    Returns ``(x, final_residual_norm_sq)``."""
    apply_m = ((lambda r: r) if minv is None
               else minv if callable(minv) else (lambda r: minv * r))
    x = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dt = b.dtype

    def arnoldi_step(j, carry):
        V, H = carry
        w = matvec(apply_m(V[j]))
        # CGS2: rows of V past j are zero, so the masked projections are
        # exact; the second pass removes CGS's orthogonality loss.
        mask = (jnp.arange(m + 1) <= j).astype(dt)
        h1 = (V @ w) * mask
        w = w - h1 @ V
        h2 = (V @ w) * mask
        w = w - h2 @ V
        h = h1 + h2
        nrm = jnp.sqrt(jnp.vdot(w, w))
        H = H.at[:, j].set(h).at[j + 1, j].set(nrm)
        V = V.at[j + 1].set(w / jnp.where(nrm == 0, 1, nrm))
        return V, H

    def restart(x, _):
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.vdot(r, r))
        V0 = jnp.zeros((m + 1, n), dt).at[0].set(
            r / jnp.where(beta == 0, 1, beta))
        V, H = jax.lax.fori_loop(0, m, arnoldi_step,
                                 (V0, jnp.zeros((m + 1, m), dt)))
        e1 = jnp.zeros(m + 1, dt).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1)
        return x + apply_m(y @ V[:m]), None

    x, _ = jax.lax.scan(restart, x, None, length=restarts)
    r = b - matvec(x)
    return x, jnp.vdot(r, r)


def power_iteration(matvec: Callable[[Array], Array], v0: Array, *,
                    iters: int) -> tuple[Array, Array]:
    """Dominant eigenpair estimate by normalized power iteration."""
    def body(v, _):
        w = matvec(v)
        nrm = jnp.sqrt(jnp.vdot(w, w))
        return w / jnp.where(nrm == 0, 1, nrm), nrm

    v, nrms = jax.lax.scan(body, v0, None, length=iters)
    lam = nrms[-1]
    return v, lam
