"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE config 2): SpMV throughput (nnz/s) on a synthetic
banded matrix (11 nnz/row, 1M rows on a GPU; scaled down on CPU) through
``best_spmv`` on the DIA layout, timed with the unroll-slope method
(``utils.benchtime.bench_slope``). Bytes model: ``4 B/nnz`` of diagonal
data plus ``8 B/row`` of x and y. ``vs_baseline`` is achieved throughput
over 70% of that roofline at the device's published bandwidth
(``utils.roofline.PEAKS``); on a device without published peaks (the
CPU) it and ``pct_of_roofline`` are ``None``.

``--all`` additionally reports every BASELINE.md config (1-5) as JSON
lines on stderr, each with its own stated bytes model and
``pct_of_roofline`` where a roofline is meaningful. The trace-based
measurement that is to replace the slope method is listed in ROADMAP.md.

Run: ``python bench.py`` — the last stdout line is always the single
headline JSON.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from spsparse_tpu.utils.compilecache import enable_persistent_cache

enable_persistent_cache()


def peak_bandwidth():
    """``(device_kind, peak bytes/s or None)`` — None on a device without
    published peaks (the CPU), where no roofline share is reported."""
    from spsparse_tpu.utils.roofline import device_hbm_bandwidth
    kind = jax.devices()[0].device_kind
    try:
        return device_hbm_bandwidth(kind)
    except KeyError:
        return kind, None


def _pct(achieved: float, sol):
    return None if sol is None else 100.0 * achieved / sol


def build_banded_dia(n: int, band: int, dtype=np.float32):
    from spsparse_tpu.core.dia import SparseDIA

    rng = np.random.default_rng(0)
    offs = np.arange(-band, band + 1)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    vals = np.where(valid, rng.uniform(-1, 1, (n, 2 * band + 1)), 0).astype(dtype)
    dia = SparseDIA(data=jnp.asarray(vals.T.copy()),
                    offsets=tuple(int(o) for o in offs), shape=(n, n))
    return dia, int(valid.sum())


def bench_spmv(n: int, band: int) -> dict:
    from spsparse_tpu.ops import best_spmv, prepare_dia
    from spsparse_tpu.utils.benchtime import bench_slope

    dia, nnz = build_banded_dia(n, band)
    prep = prepare_dia(dia)
    x = jnp.asarray(np.random.default_rng(1).uniform(-1, 1, n)
                    .astype(np.float32))
    t = bench_slope(lambda v: 0.3 * best_spmv(prep, v), x, iters=8, reps=3)
    bytes_moved = nnz * 4 + n * 8
    kind, bw = peak_bandwidth()
    sol_nnz_s = None if bw is None else bw / (bytes_moved / nnz)
    achieved = nnz / t
    return {
        "metric": "spmv_banded_nnz_per_s",
        "value": achieved,
        "unit": "nnz/s",
        "vs_baseline": (None if sol_nnz_s is None
                        else achieved / (0.7 * sol_nnz_s)),
        "detail": {
            "config": 2, "impl": "best_spmv/dia_fused", "n": n, "nnz": nnz,
            "time_s": t, "device": kind, "bytes_moved": bytes_moved,
            "bytes_model": "4B/nnz data + 8B/row x,y",
            "pct_of_roofline": _pct(achieved, sol_nnz_s),
            "effective_gb_s": bytes_moved / t / 1e9,
        },
    }


def wide_slope(step, init, fetch, *, u_lo: int = 16,
               u_hi: int = 144, reps: int = 7) -> float:
    """Wide-arm slope: the differenced time of ``u_hi - u_lo`` chained
    iterations, long enough to tower over host-side latency noise.
    ``fetch(state)`` must force a scalar to the host."""
    import time

    def chain(state, n):
        for _ in range(n):
            state = step(state)
        return state

    f_lo = jax.jit(lambda s: chain(s, u_lo))
    f_hi = jax.jit(lambda s: chain(s, u_hi))
    for f in (f_lo, f_hi):
        fetch(f(init))
    los, his = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fetch(f_lo(init))
        los.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        fetch(f_hi(init))
        his.append(time.perf_counter() - t0)
    return float(np.median(his) - np.median(los)) / (u_hi - u_lo)


def config1_reference_check() -> dict:
    """Config 1: the reference's own CPU-runnable correctness config —
    consolidate + diag-scaled SpGEMM on test_multiply_sparse-style 5x5
    operands vs the dense oracle. Roofline is meaningless at this size;
    the metric is the oracle match."""
    import time

    from spsparse_tpu import CooBuilder
    from spsparse_tpu.ops import multiply

    t0 = time.perf_counter()
    As, Bs, Ads, Bds = [], [], [], []
    for seed in range(1, 33):
        r = np.random.default_rng(seed)
        na = int(r.uniform(0, 1) * 25)
        nb = int(r.uniform(0, 1) * 25)
        ba = CooBuilder((5, 5), dtype=np.float64)
        for _ in range(na):
            ba.add((int(r.integers(5)), int(r.integers(5))),
                   float(r.uniform(-1, 1)))
        bb = CooBuilder((5, 5), dtype=np.float64)
        for _ in range(nb):
            bb.add((int(r.integers(5)), int(r.integers(5))),
                   float(r.uniform(-1, 1)))
        A, B = ba.build(cap=32), bb.build(cap=32)
        As.append(A)
        Bs.append(B)
        Ads.append(np.asarray(A.to_dense()))
        Bds.append(np.asarray(B.to_dense()))

    # All seeds share one compiled program (fixed caps + vmap) instead of
    # one eager dispatch chain per seed.
    stackA = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *As)
    stackB = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *Bs)

    @jax.jit
    @jax.vmap
    def f(a, b):
        return multiply(1.0, a, b, expand_cap=1024, cap=64).to_dense()

    dense = np.asarray(jax.block_until_ready(f(stackA, stackB)))
    expect = np.einsum("sij,sjk->sik", np.stack(Ads), np.stack(Bds))
    max_err = float(np.abs(dense - expect).max(initial=0))
    checked = len(As)
    # f64 oracles need jax x64 (the test suite enables it); without it the
    # values silently run in f32, so calibrate the tolerance to the dtype.
    tol = 1e-12 if jax.config.jax_enable_x64 else 1e-5
    return {"config": 1, "name": "reference_oracle_spgemm",
            "seeds_checked": checked, "max_abs_err": max_err,
            "tolerance": tol,
            "oracle_match": bool(max_err < tol),
            "time_s": time.perf_counter() - t0,
            "pct_of_roofline": None,
            "note": "correctness config (5x5); roofline not meaningful"}


def config2b_multirhs(on_cpu: bool) -> dict | None:
    """Config 2b: multi-RHS banded SpMM — 8 RHS amortize the diagonal
    stream (``best_spmm`` on the DIA layout). Bytes model: 4B/nnz data +
    8 RHS x/y streamed per pass."""
    if on_cpu:
        return None
    from spsparse_tpu.ops import best_spmm, prepare_dia
    from spsparse_tpu.utils.benchtime import bench_slope

    rng = np.random.default_rng(0)
    n = 1 << 20
    dia, nnz = build_banded_dia(n, 5)
    prep = prepare_dia(dia)
    X = jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32))
    t = bench_slope(lambda Xv: 0.3 * best_spmm(prep, Xv), X,
                    iters=8, reps=7, u_lo=16, u_hi=96)
    kind, bw = peak_bandwidth()
    bytes_moved = nnz * 4 + 8 * 2 * n * 4
    agg = 8 * nnz / t
    sol = None if bw is None else bw / (bytes_moved / (8 * nnz))
    return {"config": "2b", "name": "spmv_banded_8rhs", "nnz": nnz,
            "time_s": t, "nnz_per_s_aggregate": agg,
            "bytes_model": "4B/nnz data + 8 RHS x,y",
            "pct_of_roofline": _pct(agg, sol)}


def config2c_unstructured(on_cpu: bool) -> dict:
    """Config 2c: unstructured SpMV — 1M x 1M uniform-random columns,
    10 nnz/row — through ``prepare_general`` (a row-gather layout) +
    ``best_spmv``. Gather-bound: one random x element per entry, so no
    streaming roofline is reported."""
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.ops import best_spmv, prepare_general
    from spsparse_tpu.utils.benchtime import bench_slope

    rng = np.random.default_rng(0)
    n = 1 << 13 if on_cpu else 1 << 20
    k = 10
    nnz = n * k
    b = CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([np.repeat(np.arange(n), k),
                         rng.integers(0, n, nnz)], 1),
               rng.uniform(-1, 1, nnz).astype(np.float32))
    pg = prepare_general(b.build())
    x = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))

    def step(st):
        p, xv = st
        y = best_spmv(p, xv)
        return (p, xv.at[0].add(y[0] * jnp.float32(1e-30)))

    t = bench_slope(step, (pg, x), iters=4 if on_cpu else 8,
                    reps=3 if on_cpu else 5, u_lo=2,
                    u_hi=6 if on_cpu else 10)
    return {"config": "2c", "name": "spmv_unstructured",
            "impl": f"prepare_general/{pg.kernel}",
            "rows": n, "nnz": nnz, "time_s": t, "nnz_per_s": nnz / t,
            "pct_of_roofline": None,
            "note": "gather-bound op; streaming roofline not meaningful"}


def _regrid_matrix(m: int, k: int, rng, spread: int = 128):
    """Column-local 'regridding-style' matrix: row r's k entries cluster
    around column 2r (conservative-interpolation structure — each output
    cell touches a compact source neighbourhood). This is the library's
    target domain; fully random columns are config 3b's case."""
    from spsparse_tpu import CooBuilder
    ncols = 2 * m
    rr = np.repeat(np.arange(m), k)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size),
                 0, ncols - 1)
    b = CooBuilder((m, ncols), dtype=np.float32)
    b.add_many(np.stack([rr, cc], 1),
               rng.uniform(-1, 1, rr.size).astype(np.float32))
    return b.build()


def config3_spmm(on_cpu: bool) -> dict:
    """Config 3: general sparse (50 nnz/row) x dense 128-col block through
    ``prepare_general`` (dense-block layout; fill far above
    ``dense_fill_threshold``) + ``best_spmm``, in the mixed bf16/f32 mode
    (bf16 A blocks and X stream, f32 accumulation; the Hopper block
    kernel on a GPU). The iteration dependency rides the A blocks; X is
    loop-invariant f32. Bytes model: dense A blocks once + each occupied
    X tile once + Y written once (f32)."""
    import dataclasses
    from spsparse_tpu.core.tiled import to_tiled, TILE
    from spsparse_tpu.ops import best_spmm, prepare_general
    from spsparse_tpu.utils.benchtime import bench_slope

    rng = np.random.default_rng(0)
    # 2^18 rows: a ~0.5 GB working set, past the GPU's 50 MB L2
    m = 1 << 12 if on_cpu else 1 << 18
    K, N = 50, 128
    A = _regrid_matrix(m, K, rng)
    tl = to_tiled(A)
    X = jnp.asarray(rng.uniform(-1, 1, (A.shape[1], N)).astype(np.float32))
    pg = prepare_general(A, dtype=jnp.bfloat16)

    def step(state):
        p, Xc = state
        Y = best_spmm(p, Xc)
        pr = p.prep
        eps = (Y[0, 0] * jnp.float32(1e-30)).astype(pr.blocks.dtype)
        pr = dataclasses.replace(pr, blocks=pr.blocks.at[0, 0, 0, 0].add(eps))
        return (dataclasses.replace(p, prep=pr), Xc)

    init = (pg, X)
    if on_cpu:
        t = bench_slope(step, init, iters=8, reps=5, u_lo=2, u_hi=10)
    else:
        t = wide_slope(step, init, lambda st: float(
            jnp.sum(st[0].prep.blocks.astype(jnp.float32))))
    nnz = m * K
    n_tiles = int(tl.n_tiles)
    kind, bw = peak_bandwidth()
    occ_cb = int(np.unique(np.asarray(tl.tile_col)[: n_tiles]).size)
    esize = 2
    bytes_moved = (int(np.prod(pg.prep.blocks.shape)) * esize
                   + occ_cb * TILE * N * esize          # X once/occupied cb
                   + -(-m // TILE) * TILE * N * 4)      # Y (f32)
    sol_nnz = None if bw is None else bw / (bytes_moved / nnz)
    achieved = nnz / t
    return {"config": 3, "name": "spmm_tiled_50nnz_128block",
            "impl": f"prepare_general/{pg.kernel} bf16",
            "rows": m, "nnz": nnz, "n_tiles": n_tiles,
            "tile_fill": nnz / max(n_tiles, 1), "time_s": t,
            "nnz_per_s": achieved,
            "bytes_model": "dense A blocks once + X once per occupied "
                           "column block (bf16) + Y once (f32)",
            "pct_of_roofline": _pct(achieved, sol_nnz),
            "matrix": "column-local regridding-style (spread 128)"}


def config3b_packed_general(on_cpu: bool) -> dict:
    """Config 3b: the *scattered*-column companion to config 3 — random
    columns (no locality), routed through ``ops.prepare_general``:
    pack_columns raises tile fill, then the fill-chosen kernel runs. The
    reported ``n_tiles_packed`` vs ``n_tiles_raw`` is the traffic
    reduction the packing buys; the bytes model prices the *packed*
    layout (X tiles fetched once per occupied tile)."""
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.core.tiled import to_tiled, TILE
    from spsparse_tpu.ops import prepare_general
    from spsparse_tpu.ops.general import spmm_general
    from spsparse_tpu.ops.general import PreparedGather, PreparedGatherEll
    from spsparse_tpu.utils.benchtime import bench_slope

    rng = np.random.default_rng(0)
    m = 1 << 11 if on_cpu else 1 << 14
    # Sparse-wide regime (ncols >> nnz per row block): each column is
    # touched by ~1 row block, so a permutation CAN concentrate tiles.
    # (In the tall config-3 regime every column is shared by ~20 row
    # blocks and all tiles are occupied regardless — packing is a no-op
    # there by construction, which config 3 already covers.)
    K, N = 8, 128
    ncols = 8 * m
    rr = np.repeat(np.arange(m), K)
    cc = rng.integers(0, ncols, rr.size)
    b = CooBuilder((m, ncols), dtype=np.float32)
    b.add_many(np.stack([rr, cc], 1),
               rng.uniform(-1, 1, rr.size).astype(np.float32))
    A = b.build()
    n_tiles_raw = int(to_tiled(A).n_tiles)
    pg = prepare_general(A)
    X = jnp.asarray(rng.uniform(-1, 1, (ncols, N)).astype(np.float32))

    # Same harness shape as config 3: the dependency rides the prepared
    # operand's values; X is loop-invariant.
    import dataclasses as _dc

    def _perturb(p, eps):
        pr = p.prep
        if isinstance(pr, PreparedGatherEll):
            pr2 = _dc.replace(pr, vals=pr.vals.at[0, 0].add(
                eps.astype(pr.vals.dtype)))
        elif isinstance(pr, PreparedGather):
            pr2 = _dc.replace(pr, vals=pr.vals.at[0].add(eps))
        else:
            pr2 = _dc.replace(pr, blocks=pr.blocks.at[0, 0, 0, 0].add(
                eps.astype(pr.blocks.dtype)))
        return _dc.replace(p, prep=pr2)

    def step(state):
        p, Xc = state
        Y = spmm_general(p, Xc)
        return (_perturb(p, Y[0, 0] * jnp.float32(1e-30)), Xc)

    t = bench_slope(step, (pg, X), iters=4 if on_cpu else 8,
                    reps=3 if on_cpu else 5, u_lo=2, u_hi=6 if on_cpu else 10)
    # bf16-X arm: the ELL reduce's dominant stream is the gathered X rows;
    # a bf16 RHS (pre-converted once, loop-invariant) halves it.
    t_bf16x = None
    if not on_cpu and pg.kernel == "gather_ell":
        Xb = X.astype(jnp.bfloat16)
        t_bf16x = bench_slope(step, (pg, Xb), iters=8, reps=5,
                              u_lo=2, u_hi=10)
    nnz = rr.size
    kind, bw = peak_bandwidth()
    if isinstance(pg.prep, PreparedGatherEll):
        # ELL reduce: per slot one X row (incl. padding slots, which
        # gather row 0) + cols/vals payload + Y
        n_tiles = 0
        p = pg.prep
        slots = p.cols.size
        esize = np.dtype(p.vals.dtype).itemsize
        bytes_moved = (slots * (4 + esize) + slots * N * 4
                       + m * N * 4)
    elif isinstance(pg.prep, PreparedGather):
        # row-gather layout: one 512B X row per entry + entry payload + Y
        n_tiles = 0
        bytes_moved = (nnz * (4 + 4 + 4) + nnz * N * 4
                       + -(-m // TILE) * TILE * N * 4)
    else:
        n_tiles = int(np.sum(np.asarray(pg.prep.tcols) < pg.prep.nbc))
        esize = np.dtype(pg.prep.blocks.dtype).itemsize
        bytes_moved = (n_tiles * TILE * TILE * esize
                       + n_tiles * TILE * N * esize
                       + -(-m // TILE) * TILE * N * 4)
    sol_nnz = None if bw is None else bw / (bytes_moved / nnz)
    achieved = nnz / t
    return {"config": "3b", "name": "spmm_packed_general_scattered",
            "impl": f"prepare_general/{pg.kernel}",
            "rows": m, "nnz": nnz,
            "n_tiles_raw": n_tiles_raw, "n_tiles_packed": n_tiles,
            # tile reduction is meaningless for non-tiled layouts (the
            # gather layouts have no tiles)
            "pack_tile_reduction": (n_tiles_raw / n_tiles if n_tiles
                                    else None),
            "time_s": t, "nnz_per_s": achieved,
            "bytes_model": ("ELL: one X row per slot + payload + Y (f32)"
                            if pg.kernel == "gather_ell" else
                            "packed layout: A payload + X tiles once + Y "
                            "(f32)"),
            "pct_of_roofline": _pct(achieved, sol_nnz),
            "bf16x_time_s": t_bf16x,
            "bf16x_nnz_per_s": (nnz / t_bf16x) if t_bf16x else None,
            "matrix": "uniform random columns (worst-case locality)"}


def config3c_large(on_cpu: bool) -> dict | None:
    """Config 3c: config 3 at the BASELINE-stated scale — 5M rows x 50
    nnz/row x 128-col block — through the dense-block layout (bf16 blocks
    + bf16 RHS, f32 out). Gated behind ``SPSPARSE_BENCH_LARGE=1``: the
    host prepare of the ~10 GB working set dominates the run."""
    import os
    if on_cpu or os.environ.get("SPSPARSE_BENCH_LARGE") != "1":
        return None
    import gc
    import time
    import dataclasses

    from spsparse_tpu import CooBuilder
    from spsparse_tpu.core.tiled import to_tiled, TILE
    from spsparse_tpu.ops import best_spmm
    from spsparse_tpu.ops.block_spmm import prepare_tiled_dense

    rng = np.random.default_rng(0)
    m, K, N, spread = 5 << 20, 50, 128, 128
    ncols = 2 * m
    t0 = time.perf_counter()
    rr = np.repeat(np.arange(m, dtype=np.int64), K)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size),
                 0, ncols - 1)
    b = CooBuilder((m, ncols), dtype=np.float32)
    b.add_many(np.stack([rr, cc], 1),
               rng.uniform(-1, 1, rr.size).astype(np.float32))
    A = b.build()
    del rr, cc
    gc.collect()
    tl = to_tiled(A)
    prep = prepare_tiled_dense(tl, dtype=jnp.bfloat16,
                               host_limit_bytes=24 << 30)
    t_prep = time.perf_counter() - t0
    n_tiles = int(tl.n_tiles)
    X = jax.device_put(jnp.asarray(
        rng.uniform(-1, 1, (ncols, N)).astype(np.float32)
        .astype(jnp.bfloat16)))
    prep = jax.device_put(prep)
    jax.block_until_ready((X, prep.blocks))
    t_xfer = time.perf_counter() - t0 - t_prep

    def step(state):
        p, Xc = state
        Y = best_spmm(p, Xc)
        eps = (Y[0, 0] * jnp.float32(1e-30)).astype(p.blocks.dtype)
        return (dataclasses.replace(
            p, blocks=p.blocks.at[0, 0, 0, 0].add(eps)), Xc)

    t = wide_slope(step, (prep, X),
                   lambda st: float(st[0].blocks[0, 0, 0, 0]),
                   u_lo=1, u_hi=5, reps=5)
    nnz = m * K
    occ_cb = int(np.unique(np.asarray(tl.tile_col)[: n_tiles]).size)
    bytes_moved = (int(np.prod(prep.blocks.shape)) * 2
                   + occ_cb * TILE * N * 2
                   + -(-m // TILE) * TILE * N * 4)
    kind, bw = peak_bandwidth()
    sol_nnz = None if bw is None else bw / (bytes_moved / nnz)
    achieved = nnz / t
    return {"config": "3c", "name": "spmm_tiled_5M_rows_baseline_scale",
            "rows": m, "nnz": nnz, "n_tiles": n_tiles,
            "impl": "best_spmm/dense_block bf16 (bf16 RHS)",
            "prepare_s": t_prep, "transfer_s": t_xfer,
            "time_s": t, "nnz_per_s": achieved,
            "bytes_model": "dense A blocks once (bf16) + X once per "
                           "occupied column block (bf16) + Y once (f32)",
            "pct_of_roofline": _pct(achieved, sol_nnz),
            "matrix": "column-local regridding-style (spread 128), "
                      "BASELINE-stated 5M-row scale"}


def config4_spgemm(on_cpu: bool) -> dict:
    """Config 4: SpGEMM A Aᵀ on the regridding-style matrix with irregular
    row lengths (capped-zipf mixture) at 2^17 rows.

    Primary path: the tiled pair product in bf16 (the Hopper pair kernel
    where ``core.backend.runs_gpu_kernel`` picks it, else its plain XLA
    form); an f32 arm and the general ESC paths are reported alongside.
    Roofline: the larger of the operand/output traffic over the peak
    bandwidth and the pair products' FLOPs over the dtype's peak rate."""
    import dataclasses

    from spsparse_tpu.core.backend import runs_gpu_kernel
    from spsparse_tpu.core.tiled import to_tiled, TILE
    from spsparse_tpu.ops.spgemm import spgemm_aat, plan_spgemm_caps
    from spsparse_tpu.ops.spgemm_tiled import (
        densify_tiled, plan_pstart, plan_tiled_spgemm, spgemm_pairs_pallas,
        spgemm_tiled_xla)
    from spsparse_tpu.utils.benchtime import bench_slope
    from spsparse_tpu.utils.roofline import device_peaks, spgemm_esc_stats

    rng = np.random.default_rng(0)
    n_dst = 1 << 12 if on_cpu else 1 << 17
    # Irregular row lengths: capped zipf(2.0) — most rows 1-3 entries,
    # a heavy tail to 24; column locality stays regridding-style.
    k = np.minimum(rng.zipf(2.0, n_dst), 24).astype(np.int64)
    r = np.repeat(np.arange(n_dst), k)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), n_dst * 2 - 1)
    from spsparse_tpu import CooBuilder
    b = CooBuilder((n_dst, n_dst * 2), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), rng.uniform(0, 1, r.size))
    A = b.build()
    expand_cap, out_cap = plan_spgemm_caps(A, A, transpose_b=True)
    tl = to_tiled(A)
    kind, bw = peak_bandwidth()
    try:
        peaks = device_peaks(kind)
    except KeyError:
        peaks = None
    tile_b = TILE * TILE

    def pair_arm(dtype):
        use_kernel = runs_gpu_kernel(dtype)
        ta = densify_tiled(tl, dtype=dtype)
        plan = plan_tiled_spgemm(ta, ta, transpose_b=True)
        ps = jnp.asarray(plan_pstart(plan))
        pa, pb = jnp.asarray(plan.pa), jnp.asarray(plan.pb)

        def step(blocks):
            if use_kernel:
                out = spgemm_pairs_pallas(blocks, blocks, ps, pa, pb,
                                          transpose_b=True,
                                          n_out=plan.n_out_tiles)
            else:
                out = spgemm_tiled_xla(dataclasses.replace(ta, blocks=blocks),
                                       dataclasses.replace(ta, blocks=blocks),
                                       plan).blocks
            eps = (out[0, 0, 0] * jnp.float32(1e-30)).astype(blocks.dtype)
            return blocks.at[0, 0, 0].add(eps)

        if on_cpu:
            t = bench_slope(step, ta.blocks, iters=4, reps=3, u_lo=1,
                            u_hi=3)
        else:
            t = wide_slope(step, ta.blocks, lambda bl: float(
                jnp.sum(bl.astype(jnp.float32))))
        esize = np.dtype(dtype).itemsize
        read_b = 2 * plan.n_pairs * tile_b * esize
        write_b = plan.n_out_tiles * tile_b * 4
        flops = 2 * plan.n_pairs * TILE ** 3
        sol_t = None
        if bw is not None and peaks is not None:
            rate = (peaks.bf16_flops if dtype == jnp.bfloat16
                    else peaks.f32_flops)
            sol_t = max((read_b + write_b) / bw, flops / rate)
        return t, plan, read_b, write_b, sol_t

    t, plan, read_b, write_b, sol_t = pair_arm(jnp.bfloat16)
    t_f32, _, _, _, sol_f32 = pair_arm(jnp.float32)

    # --- ESC path (general-purpose; the only option without block
    # structure) ---
    def step_esc(a):
        res = spgemm_aat(a, cap=out_cap, expand_cap=expand_cap)
        eps = jnp.sum(res.vals) * jnp.float32(1e-38)
        return dataclasses.replace(a, vals=a.vals + eps)

    t_esc = bench_slope(step_esc, A, iters=4, reps=3, u_lo=1, u_hi=3)
    stats = spgemm_esc_stats(r.size, r.size, expand_cap, out_cap)
    sol_esc = None if bw is None else stats.sol_nnz_per_s(bw)

    # --- planned ESC: pattern-static plan sorts at prepare time; the
    # per-call product is 2 gathers + one sorted segment_sum — the
    # repeated-product case every solver hits.
    from spsparse_tpu.ops.spgemm_planned import (plan_esc,
                                                 spgemm_planned_vals)
    eplan, eacon, ebcon = plan_esc(A, A, transpose_b=True)

    def step_pe(va):
        out = spgemm_planned_vals(eplan, va, ebcon.vals)
        return va + jnp.sum(out) * jnp.float32(1e-38)

    t_esc_planned = bench_slope(step_pe, eacon.vals, iters=4, reps=3,
                                u_lo=2, u_hi=6)

    return {"config": 4, "name": "spgemm_aat_regrid_irregular",
            "rows": n_dst, "nnz_a": int(r.size),
            "row_lengths": "zipf(2.0) capped 24 "
                           f"(mean {r.size / n_dst:.2f}, max {int(k.max())})",
            "products": expand_cap,
            "impl": ("tiled pairs bf16 (Hopper pair kernel)"
                     if runs_gpu_kernel(jnp.bfloat16)
                     else "tiled pairs bf16 (plain XLA form)"),
            "tile_pairs": plan.n_pairs, "out_tiles": plan.n_out_tiles,
            "time_s": t, "products_per_s": expand_cap / t,
            "bytes_model": "2 operand tiles per pair (read) + each output "
                           "tile once (f32 write); sol = max(bytes, flops)",
            "read_bytes": read_b, "write_bytes": write_b,
            "pct_of_roofline": None if sol_t is None else 100.0 * sol_t / t,
            "f32_time_s": t_f32,
            "f32_pct_of_roofline": (None if sol_f32 is None
                                    else 100.0 * sol_f32 / t_f32),
            "esc_time_s": t_esc,
            "esc_products_per_s": expand_cap / t_esc,
            "esc_pct_of_roofline": _pct(expand_cap / t_esc, sol_esc),
            "esc_planned_time_s": t_esc_planned,
            "esc_planned_products_per_s": eplan.n_products
            / max(t_esc_planned, 1e-12),
            "esc_planned_speedup": t_esc / max(t_esc_planned, 1e-12)}


def config5_distributed(on_cpu: bool) -> dict:
    """Config 5: row-partitioned SpMV/SpGEMM across devices. The scaling
    figures come from the auditable analytical model in
    spsparse_tpu/dist/model.py (H200 published bandwidths); on CPU a real
    8-virtual-device mesh also executes the collective graph. The measured
    four-card path is ``python chip_smoke.py --four-cards``."""
    from spsparse_tpu.dist import (a2a_footprint_for_target,
                                   a2a_weak_scaling_efficiency,
                                   halo_weak_scaling_efficiency,
                                   ring_weak_scaling_efficiency,
                                   uniform_footprint)

    out = {"config": 5, "name": "distributed_row_partitioned",
           "per_chip_workload": "1M rows, 11 nnz/row (config-2 family)",
           "model": "dist/model.py (overlapped ring / halo exchange / "
                    "footprint a2a, H200 HBM + NVLink peak bandwidths)",
           "pct_of_roofline": None}
    nnz_l, rows_l = 11 * (1 << 20), 1 << 20
    # footprint-bounded scattered matrix: comm = the device's column
    # footprint, independent of P (dist_spmv_a2a); the bound
    # shown is the largest footprint that still meets the 80% target.
    f80 = a2a_footprint_for_target(nnz_l, rows_l, target=0.8)
    out["a2a_footprint_80pct_bound"] = f80
    for p in (2, 8, 64):
        out[f"halo_weak_scaling_eff_p{p}"] = halo_weak_scaling_efficiency(
            nnz_local=nnz_l, rows_local=rows_l, halo=8, n_devices=p)
        out[f"ring_weak_scaling_eff_p{p}"] = ring_weak_scaling_efficiency(
            nnz_local=nnz_l, rows_local=rows_l, n_devices=p)
        out[f"a2a_bounded_weak_scaling_eff_p{p}"] = \
            a2a_weak_scaling_efficiency(nnz_l, rows_l, f80, p)
        # uniform-scatter worst case: footprint ~ min(nnz, ncols_global)
        f_uni = uniform_footprint(nnz_l, p * rows_l)
        out[f"a2a_uniform_weak_scaling_eff_p{p}"] = \
            a2a_weak_scaling_efficiency(nnz_l, rows_l, f_uni, p)
    out["meets_baseline_80pct"] = bool(
        out["halo_weak_scaling_eff_p8"] >= 0.8
        and out["a2a_bounded_weak_scaling_eff_p8"] >= 0.8)
    out["honest_gap"] = (
        "uniform-random matrices have footprint ~min(nnz_local, ncols) "
        "per device; a2a still beats the ring ~5x at P=64 "
        f"({out['a2a_uniform_weak_scaling_eff_p64']:.2f} vs "
        f"{out['ring_weak_scaling_eff_p64']:.2f}) but cannot meet 80% — "
        "no exchange can: the values genuinely needed exceed the link "
        "budget (dist/model.py a2a_weak_scaling_efficiency docstring)")

    if on_cpu and len(jax.devices()) >= 8:
        import time

        from jax.sharding import Mesh
        from spsparse_tpu.dist import (dist_spmv_halo, partition_rows,
                                       partition_vector)
        from spsparse_tpu import CooBuilder
        n = 1 << 12
        rng = np.random.default_rng(0)
        bld = CooBuilder((n, n), dtype=np.float32)
        rows = np.repeat(np.arange(n), 3)
        cols = np.clip(rows + rng.integers(-2, 3, rows.size), 0, n - 1)
        bld.add_many(np.stack([rows, cols], 1),
                     rng.uniform(-1, 1, rows.size).astype(np.float32))
        A = bld.build()
        mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))
        part = partition_rows(A, 8)
        xp = partition_vector(np.ones(n, np.float32), 8)
        t0 = time.perf_counter()
        jax.block_until_ready(dist_spmv_halo(part, xp, mesh, halo=8))
        out["virtual_mesh_exec"] = {
            "devices": 8, "halo_spmv_wall_s": time.perf_counter() - t0,
            "note": "virtual CPU mesh: validates the collective graph, "
                    "not link timing"}
    return out


def extra_configs(on_cpu: bool):
    """Yield each BASELINE config as it completes (generator — callers
    persist incrementally so a wedged config cannot lose earlier ones)."""
    import traceback

    # config 1 LAST: its 32-way-vmapped ESC chain is the largest compile
    # in the suite — the perf configs must not wait on it.
    for name, fn in [("config2b", lambda: config2b_multirhs(on_cpu)),
                     ("config2c", lambda: config2c_unstructured(on_cpu)),
                     ("config3", lambda: config3_spmm(on_cpu)),
                     ("config3b", lambda: config3b_packed_general(on_cpu)),
                     ("config3c", lambda: config3c_large(on_cpu)),
                     ("config4", lambda: config4_spgemm(on_cpu)),
                     ("config5", lambda: config5_distributed(on_cpu)),
                     ("config1", config1_reference_check)]:
        # One config failing must not take down the remaining configs or
        # the headline line.
        try:
            cfg = fn()
        except Exception as e:  # pragma: no cover - defensive
            traceback.print_exc(file=sys.stderr)
            cfg = {"config": name, "error": f"{type(e).__name__}: {e}"}
        if cfg:
            yield cfg


def flag_over_roofline(cfg: dict) -> dict:
    """Mark readings above 105% of the roofline: faster than the speed of
    light means the measurement (not the kernel) is wrong, and consumers
    must not trust the entry."""
    for key in ("pct_of_roofline", "f32_pct_of_roofline",
                "esc_pct_of_roofline"):
        v = cfg.get(key)
        if v is not None and v > 105.0:
            cfg["over_roofline"] = True
            cfg["over_roofline_note"] = (
                f"{key}={v:.1f} exceeds the speed of light; re-measure")
    return cfg


def measure_headline(n: int, band: int, max_retries: int = 2) -> dict:
    """Self-policing headline measurement: a ``pct_of_roofline`` above
    ~105 is over the speed of light — a measurement artifact, not a
    kernel result — so re-measure (bounded retries) and publish the first
    physically possible reading; if every attempt is impossible, keep the
    lowest reading and carry ``over_roofline`` into the headline JSON so
    the artifact is explicitly marked rather than silently wrong."""
    attempts = []
    for _ in range(1 + max_retries):
        res = bench_spmv(n, band)
        attempts.append(res)
        pct = res["detail"]["pct_of_roofline"]
        if pct is None or pct <= 105.0:
            if len(attempts) > 1:
                res["detail"]["headline_retries"] = len(attempts) - 1
            return res
    res = min(attempts, key=lambda r: r["detail"]["pct_of_roofline"])
    res["over_roofline"] = True
    res["detail"]["over_roofline"] = True
    res["detail"]["over_roofline_note"] = (
        f"all {len(attempts)} headline measurements exceeded 105% of the "
        "roofline (speed of light); measurement artifact")
    res["detail"]["headline_retries"] = len(attempts) - 1
    return res


def write_detail(configs: list[dict], path: str = "bench_detail.json", *,
                 headline_only: bool = False) -> None:
    """Persist the full bench matrix: every computed config with its bytes
    model and ``pct_of_roofline``, plus platform metadata. The stdout
    contract (exactly one headline JSON line) is untouched — this goes to
    a file (``$SPSPARSE_BENCH_DETAIL``, default ``bench_detail.json``,
    listed in ``.gitignore``).

    Only a *headline-only* run defers to a richer existing artifact; an
    ``--all`` rerun always overwrites incrementally, so a failed rerun
    leaves a partial-but-fresh artifact instead of silently retaining a
    stale one."""
    import datetime
    import os

    target = os.environ.get("SPSPARSE_BENCH_DETAIL", path)
    if target.lower() in ("0", "none", "off"):
        return
    doc = {
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "written_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "configs": configs,
    }
    # bench.py may be exec'd without __file__ (the contract test does) —
    # fall back to the cwd
    fp = globals().get("__file__")
    base = os.path.dirname(os.path.abspath(fp)) if fp else os.getcwd()
    out = target if os.path.isabs(target) else os.path.join(base, target)
    # a headline-only run must not clobber a richer --all artifact
    if headline_only:
        try:
            with open(out) as f:
                existing = json.load(f)
            if len(existing.get("configs", [])) > len(configs):
                return
        except Exception:
            pass
    try:
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    except OSError as e:  # pragma: no cover - read-only checkouts
        print(f"bench_detail write failed: {e}", file=sys.stderr)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()

    on_cpu = jax.devices()[0].platform == "cpu"
    n = args.n or (1 << 16 if on_cpu else 1 << 20)
    res = measure_headline(n, band=5)

    detail = [res]
    write_detail(detail, headline_only=not args.all)
    if args.all:
        print(json.dumps(res, indent=1), file=sys.stderr)
        for cfg in extra_configs(on_cpu):
            cfg = flag_over_roofline(cfg)
            print(json.dumps(cfg, indent=1), file=sys.stderr)
            detail.append(cfg)
            # incremental: a failing later config must not lose the
            # configs already measured
            write_detail(detail)

    headline = {
        "metric": res["metric"],
        "value": res["value"],
        "unit": res["unit"],
        "vs_baseline": res["vs_baseline"],
    }
    if res.get("over_roofline"):
        headline["over_roofline"] = True
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
