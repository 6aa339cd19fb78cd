"""Chained device timing helpers used by ``bench.py``.

Each helper chains executions through a data dependency (each call
consumes the previous call's output) so the device must serialize them,
and ends by fetching a scalar reduction of the final output, which cannot
complete until the whole chain has. The trace-based measurement that is
to replace them is listed in ROADMAP.md.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bench_chained", "bench_fori", "bench_slope"]


def bench_slope(step: Callable[[Any], Any], init: Any, *, u_lo: int = 2,
                u_hi: int = 8, iters: int = 10, reps: int = 3) -> float:
    """Per-op time via the unroll-slope method — immune to fixed overhead.

    Chaining ``u`` copies of ``step`` inside each loop body gives total
    time ``iters * (fixed + u * t_op)``; the difference between two unroll
    factors cancels the fixed per-iteration term:
    ``t_op = (T(u_hi) - T(u_lo)) / (iters * (u_hi - u_lo))``.
    """
    import jax.lax as lax

    def chain(u):
        def body(_, y):
            for _ in range(u):
                y = step(y)
            return y

        @jax.jit
        def run(y0):
            return lax.fori_loop(0, iters, body, y0)
        return run

    run_lo, run_hi = chain(u_lo), chain(u_hi)
    _force(run_lo(init))
    _force(run_hi(init))

    # Median the lo and hi times separately across reps, then difference
    # the medians — robust to host-side latency spikes landing on either
    # side of a pair.
    t_los, t_his = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(run_lo(init))
        t_los.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _force(run_hi(init))
        t_his.append(time.perf_counter() - t0)
    slope = (float(np.median(t_his)) - float(np.median(t_los))) \
        / (iters * (u_hi - u_lo))
    return max(slope, 1e-9)


def bench_fori(step: Callable[[Any], Any], init: Any, *, iters: int = 20,
               reps: int = 3) -> float:
    """Per-iteration time with the whole chain inside ONE jitted program.

    ``lax.fori_loop`` chains ``iters`` applications of ``step`` on device,
    so per-dispatch overhead is paid once per measurement instead of once
    per iteration. ``step`` must be shape/dtype-preserving; XLA cannot
    elide iterations because of the loop-carried dependency.
    """
    import jax.lax as lax

    @jax.jit
    def chain(y0):
        return lax.fori_loop(0, iters, lambda _, y: step(y), y0)

    y = chain(init)       # compile + warm
    _force(y)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        y = chain(init)
        _force(y)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / iters


def _force(y) -> float:
    """Fetch a scalar that depends on every element of y (pytree ok)."""
    leaves = jax.tree_util.tree_leaves(y)
    tot = 0.0
    for leaf in leaves:
        tot += float(jnp.sum(jnp.asarray(leaf).astype(jnp.float32)))
    return tot


def bench_chained(step: Callable[[Any], Any], init: Any, *, iters: int = 10,
                  warmup: int = 2, reps: int = 3) -> float:
    """Median per-iteration wall time of ``y = step(y)`` chains.

    ``step`` must map its output type to its input type (shape/dtype
    preserved) so calls chain through a true data dependency.
    """
    y = init
    for _ in range(warmup):
        y = step(y)
    _force(y)

    times = []
    for _ in range(reps):
        y = init
        t0 = time.perf_counter()
        for _ in range(iters):
            y = step(y)
        _force(y)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))
