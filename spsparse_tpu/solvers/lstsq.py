"""Sparse least-squares solvers over a (matvec, rmatvec) operator pair —
the ``scipy.sparse.linalg.lsqr / cgls`` capability tier.

The reference's domain (regridding / conservative interpolation) consumes
rectangular sparse operators whose normal equations are the natural
solve; these provide ``min ||A x - b||^2 + damp^2 ||x||^2`` without ever
forming ``A^T A`` (one SpMV + one transposed SpMV per iteration, both
through whatever kernel the operator closure picked).

Device-first shape: fixed iteration counts under ``lax.scan`` (static
shapes, one compile), reductions as whole-vector dots (a single ``psum``
each under sharding), scalar recurrences carried in the scan state. No
reference counterpart (citibeth/spsparse has no solver layer).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array

__all__ = ["cgls_solve", "lsqr_solve", "lsmr_solve"]

from .iterative import safe_div as _safe_div  # noqa: E402  shared guard


def cgls_solve(matvec: Callable[[Array], Array],
               rmatvec: Callable[[Array], Array], b: Array, *,
               iters: int, damp: float = 0.0,
               x0: Array | None = None) -> tuple[Array, Array]:
    """CGLS: conjugate gradients on the regularized normal equations
    ``(A^T A + damp^2 I) x = A^T b`` in factored form (residuals kept as
    ``r = b - A x``, never squaring the condition number in storage).

    ``matvec: (n,) -> (m,)``, ``rmatvec: (m,) -> (n,)``, ``b (m,)``.
    Returns ``(x (n,), gnorm_sq)`` where ``gnorm_sq = ||A^T r - damp^2
    x||^2`` is the final normal-equation residual (0 at the exact
    least-squares solution)."""
    dampf = jnp.asarray(damp, b.dtype)
    n_like = rmatvec(b)
    x0 = jnp.zeros_like(n_like) if x0 is None else x0
    r0 = b - matvec(x0)
    s0 = rmatvec(r0) - dampf**2 * x0
    gamma0 = jnp.vdot(s0, s0)

    def body(state, _):
        x, r, p, gamma = state
        q = matvec(p)
        delta = jnp.vdot(q, q) + dampf**2 * jnp.vdot(p, p)
        alpha = _safe_div(gamma, delta)
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r) - dampf**2 * x
        gamma_new = jnp.vdot(s, s)
        beta = _safe_div(gamma_new, gamma)
        p = s + beta * p
        return (x, r, p, gamma_new), None

    (x, r, _, gamma), _ = jax.lax.scan(
        body, (x0, r0, s0, gamma0), None, length=iters)
    return x, gamma


def lsqr_solve(matvec: Callable[[Array], Array],
               rmatvec: Callable[[Array], Array], b: Array, *,
               iters: int, damp: float = 0.0) -> tuple[Array, Array]:
    """LSQR (Paige & Saunders): Golub-Kahan bidiagonalization with an
    implicit QR of the bidiagonal — analytically equivalent to CGLS but
    with better-behaved recurrences on ill-conditioned ``A``.

    ``matvec: (n,) -> (m,)``, ``rmatvec: (m,) -> (n,)``, ``b (m,)``.
    Solves ``min ||A x - b||^2 + damp^2 ||x||^2`` from ``x0 = 0`` (the
    LSQR recurrence requires it; shift ``b`` by ``A x0`` externally for a
    warm start). Returns ``(x, rnorm_sq_estimate)`` — the recurrence's
    running estimate of the *regularized* residual
    ``||A x - b||^2 + damp^2 ||x||^2`` (exact in exact arithmetic; equals
    ``||r||^2`` when ``damp == 0``)."""
    dt = b.dtype
    dampf = jnp.asarray(damp, dt)

    beta1 = jnp.sqrt(jnp.vdot(b, b))
    u = b * _safe_div(jnp.asarray(1, dt), beta1)
    av = rmatvec(u)
    alpha1 = jnp.sqrt(jnp.vdot(av, av))
    v = av * _safe_div(jnp.asarray(1, dt), alpha1)

    x = jnp.zeros_like(v)
    w = v
    phibar = beta1
    rhobar = alpha1

    def body(state, _):
        x, w, u, v, alpha, beta, phibar, rhobar, psi2 = state
        # Bidiagonalization step: beta_{i+1} u_{i+1} = A v_i - alpha_i u_i
        u_next = matvec(v) - alpha * u
        beta_n = jnp.sqrt(jnp.vdot(u_next, u_next))
        u_next = u_next * _safe_div(jnp.asarray(1, dt), beta_n)
        #                    alpha_{i+1} v_{i+1} = A^T u_{i+1} - beta v_i
        v_next = rmatvec(u_next) - beta_n * v
        alpha_n = jnp.sqrt(jnp.vdot(v_next, v_next))
        v_next = v_next * _safe_div(jnp.asarray(1, dt), alpha_n)

        # Eliminate the damping entry (rotation on the regularized system).
        rhobar1 = jnp.sqrt(rhobar**2 + dampf**2)
        c1 = _safe_div(rhobar, rhobar1)
        s1 = _safe_div(dampf, rhobar1)
        psi = s1 * phibar               # damping's residual contribution
        phibar1 = c1 * phibar

        # Plane rotation eliminating beta_{i+1}.
        rho = jnp.sqrt(rhobar1**2 + beta_n**2)
        c = _safe_div(rhobar1, rho)
        s = _safe_div(beta_n, rho)
        theta = s * alpha_n
        rhobar_next = -c * alpha_n
        phi = c * phibar1
        phibar_next = s * phibar1

        x = x + _safe_div(phi, rho) * w
        w = v_next - _safe_div(theta, rho) * w
        return (x, w, u_next, v_next, alpha_n, beta_n,
                phibar_next, rhobar_next, psi2 + psi**2), None

    state = (x, w, u, v, alpha1, beta1, phibar, rhobar,
             jnp.zeros((), dt))
    (x, *_, phibar, _, psi2), _ = jax.lax.scan(
        body, state, None, length=iters)
    return x, phibar**2 + psi2


def lsmr_solve(matvec: Callable[[Array], Array],
               rmatvec: Callable[[Array], Array], b: Array, *,
               iters: int, damp: float = 0.0) -> tuple[Array, Array]:
    """LSMR (Fong & Saunders): MINRES applied to the normal equations
    through the same Golub-Kahan bidiagonalization as :func:`lsqr_solve`.
    Where LSQR's residual ``||A x - b||`` decreases monotonically, LSMR's
    *normal-equation* residual ``||A^T r||`` does — the better stopping
    quantity for ill-conditioned least squares.

    Solves ``min ||A x - b||^2 + damp^2 ||x||^2`` from ``x0 = 0``.
    Returns ``(x, gnorm_sq_estimate)`` — the recurrence's estimate of
    ``||A^T r - damp^2 x||^2`` (the regularized normal-equation
    residual; 0 at the exact solution). Fixed ``iters`` under
    ``lax.scan``, breakdowns masked like the siblings."""
    dt = b.dtype
    dampf = jnp.asarray(damp, dt)
    one = jnp.ones((), dt)

    beta1 = jnp.sqrt(jnp.vdot(b, b))
    u = b * _safe_div(one, beta1)
    av = rmatvec(u)
    alpha1 = jnp.sqrt(jnp.vdot(av, av))
    v = av * _safe_div(one, alpha1)

    x = jnp.zeros_like(v)
    h = v
    hbar = jnp.zeros_like(v)
    state = (x, h, hbar, u, v,
             alpha1,                    # alpha_k
             alpha1,                    # alphabar
             one, jnp.zeros((), dt),    # cbar, sbar
             alpha1 * beta1,            # zetabar
             one, one)                  # rho, rhobar (previous)

    def body(state, _):
        (x, h, hbar, u, v, alpha, alphabar, cbar, sbar, zetabar,
         rho_old, rhobar_old) = state
        # Golub-Kahan step (identical to LSQR's).
        u_n = matvec(v) - alpha * u
        beta_n = jnp.sqrt(jnp.vdot(u_n, u_n))
        u_n = u_n * _safe_div(one, beta_n)
        v_n = rmatvec(u_n) - beta_n * v
        alpha_n = jnp.sqrt(jnp.vdot(v_n, v_n))
        v_n = v_n * _safe_div(one, alpha_n)

        # Damping rotation on alphabar.
        alphahat = jnp.sqrt(alphabar**2 + dampf**2)
        # First QR rotation (eliminate beta_{k+1}).
        rho = jnp.sqrt(alphahat**2 + beta_n**2)
        c = _safe_div(alphahat, rho)
        s = _safe_div(beta_n, rho)
        theta_new = s * alpha_n
        alphabar_n = c * alpha_n
        # Second rotation (the MINRES-on-T part).
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = jnp.sqrt(rhotemp**2 + theta_new**2)
        cbar_n = _safe_div(rhotemp, rhobar)
        sbar_n = _safe_div(theta_new, rhobar)
        zeta = cbar_n * zetabar          # NEW rotation applies to zetabar
        zetabar_n = -sbar_n * zetabar

        hbar = h - _safe_div(thetabar * rho, rho_old * rhobar_old) * hbar
        x = x + _safe_div(zeta, rho * rhobar) * hbar
        h = v_n - _safe_div(theta_new, rho) * h
        return (x, h, hbar, u_n, v_n, alpha_n, alphabar_n,
                cbar_n, sbar_n, zetabar_n, rho, rhobar), None

    (x, *_, zetabar, _, _), _ = jax.lax.scan(body, state, None,
                                             length=iters)
    return x, zetabar**2
