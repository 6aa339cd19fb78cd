#!/usr/bin/env python3
"""Smoke test of the library's main path on one NVIDIA GPU.

Run from the repository root::

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the row-partitioned dist/ path only

Each phase builds a seeded operand, runs it through the public API
(``prepare_general``/``best_spmv``/``best_spmm``, ``best_spgemm``/
``spgemm_tiled``/``multiply``, ``SparseCOO.consolidate``, ``cg_solve``),
compares the result with a plain float64 reference computed on the host
with numpy/scipy, and prints one line: the phase, its shapes, its error
against the tolerance, compile and wall seconds, and the device's
``peak_bytes_in_use``. Phases with a hand-written GPU kernel also time the
kernel against its plain XLA form on the same operands.

The last stdout line is one JSON object, ``{"ok": ..., "device":
{"platform", "kind", "count"}}``. Without a GPU (or outside the
repository) the script prints no result and exits 2; a failed phase or a
missed tolerance prints ``"ok": false`` and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np


def card_line() -> str:
    """The card's name and power limit, read by ``nvidia-smi`` in a child
    process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# --- seeded operands (numpy) -----------------------------------------------


def banded_dia_data(n: int, band: int, seed: int = 0):
    """Config-2 family: ``2*band+1`` diagonals, uniform(-1, 1) values,
    zero outside the matrix. Returns ``(data (K, n) f32, offsets)``."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    data = rng.uniform(-1, 1, (offs.size, n)).astype(np.float32)
    rows = np.arange(n)
    for k, off in enumerate(offs):
        data[k, (rows + off < 0) | (rows + off >= n)] = 0
    return data, tuple(int(o) for o in offs)


def regrid_entries(m: int, k: int, seed: int = 0, spread: int = 128):
    """Config-3 regridding matrix ``(m, 2m)``: row r's k entries cluster
    around column 2r."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(m), k)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size),
                 0, 2 * m - 1)
    return rr, cc, rng.uniform(-1, 1, rr.size).astype(np.float32), (m, 2 * m)


def scattered_entries(m: int, k: int, seed: int = 0):
    """Config-3b matrix ``(m, 8m)``: k uniform-random columns per row."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(m), k)
    cc = rng.integers(0, 8 * m, rr.size)
    return rr, cc, rng.uniform(-1, 1, rr.size).astype(np.float32), (m, 8 * m)


def zipf_entries(n_dst: int, seed: int = 0):
    """Config-4 matrix ``(n_dst, 2 n_dst)``: capped-zipf(2.0) row lengths
    (1..24), columns 2r + [0, 3)."""
    rng = np.random.default_rng(seed)
    k = np.minimum(rng.zipf(2.0, n_dst), 24).astype(np.int64)
    r = np.repeat(np.arange(n_dst), k)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), n_dst * 2 - 1)
    return r, c, rng.uniform(0, 1, r.size).astype(np.float32), \
        (n_dst, 2 * n_dst)


def poisson_dia_data(g: int):
    """5-point Poisson on a ``g x g`` grid, float64 DIA."""
    n = g * g
    offs = (-g, -1, 0, 1, g)
    data = np.zeros((5, n))
    i = np.arange(n)
    data[0] = np.where(i - g >= 0, -1.0, 0.0)
    data[1] = np.where(i % g != 0, -1.0, 0.0)
    data[2] = 4.0
    data[3] = np.where(i % g != g - 1, -1.0, 0.0)
    data[4] = np.where(i + g < n, -1.0, 0.0)
    return data, offs


# --- host references --------------------------------------------------------


def dia_apply_ref(data, offsets, x):
    """float64 ``A @ x`` for square DIA data; ``x`` is ``(n,)`` or
    ``(n, R)``."""
    n = data.shape[1]
    x = np.asarray(x, np.float64)
    y = np.zeros(x.shape)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        d = data[k, lo:hi].astype(np.float64)
        y[lo:hi] += d.reshape((-1,) + (1,) * (x.ndim - 1)) \
            * x[lo + off:hi + off]
    return y


def csr_ref(rows, cols, vals, shape):
    import scipy.sparse as sps
    return sps.csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                          shape=shape)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-300)
    return float(np.abs(got - ref).max(initial=0.0)) / scale


def coo_to_scipy(c):
    import scipy.sparse as sps
    nnz = int(c.nnz)
    idx = np.asarray(c.indices)[:nnz]
    vals = np.asarray(c.vals, np.float64)[:nnz]
    return sps.csr_matrix((vals, (idx[:, 0], idx[:, 1])), shape=c.shape)


def sparse_rel_err(c, ref) -> float:
    diff = coo_to_scipy(c) - ref
    scale = max(float(abs(ref).max()), 1e-300)
    return float(abs(diff).max()) / scale if diff.nnz else 0.0


# --- timing -----------------------------------------------------------------


def timed(f, *args, reps: int = 3):
    """``(out, first_s, wall_s)``: the first call (compile + run) and the
    median of ``reps`` steady calls, each ended by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        walls.append(time.perf_counter() - t0)
    return out, first, float(np.median(walls))


def in_turns(fa, fb, args, reps: int = 5, calls: int = 10):
    """Median seconds per call of ``fa`` and ``fb`` (both compiled
    first): batches of ``calls`` back-to-back calls (so dispatch overlaps
    device work), measured in the order a, b, b, a, a, b, ..."""
    import jax

    jax.block_until_ready(fa(*args))
    jax.block_until_ready(fb(*args))
    ta, tb = [], []
    for i in range(reps):
        order = ((fa, ta), (fb, tb)) if i % 2 == 0 else ((fb, tb), (fa, ta))
        for f, acc in order:
            t0 = time.perf_counter()
            for _ in range(calls):
                out = f(*args)
            jax.block_until_ready(out)
            acc.append((time.perf_counter() - t0) / calls)
    return float(np.median(ta)), float(np.median(tb))


# --- phases -----------------------------------------------------------------
# Each returns a dict with at least: phase, shapes, err, tol, compile_s,
# wall_s. Tolerances are max-norm errors relative to the reference's max
# norm. float32 tolerances (1e-5) are below what TF32 products (about 10
# mantissa bits, ~1e-3) would give, so they also check that every f32
# contraction on the path runs at full precision.


def phase_consolidate(n_entries: int = 1 << 23, seed: int = 0) -> dict:
    """2^23 COO entries, ~25% duplicates of other entries, f32, ADD."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu import SparseCOO

    rng = np.random.default_rng(seed)
    side = max(int(np.sqrt(n_entries)) * 4, 16)
    n_uni = n_entries - n_entries // 4
    keys = rng.integers(0, side * side, n_uni)
    keys = np.concatenate([keys, keys[rng.integers(0, n_uni,
                                                   n_entries - n_uni)]])
    rng.shuffle(keys)
    idx = np.stack([keys // side, keys % side], 1).astype(np.int32)
    vals = rng.uniform(-1, 1, n_entries).astype(np.float32)
    A = SparseCOO.from_arrays(idx, vals, (side, side), check=False)
    f = jax.jit(lambda a: a.consolidate((0, 1)))
    C, first, wall = timed(f, A)
    # reference: sort by (row, col) and sum duplicates in float64
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(uk.size)
    np.add.at(sums, inv, vals.astype(np.float64))
    keep = sums != 0
    uk, sums = uk[keep], sums[keep]
    nnz = int(C.nnz)
    got_idx = np.asarray(C.indices)[:nnz].astype(np.int64)
    exact = (nnz == uk.size and np.array_equal(
        got_idx[:, 0] * side + got_idx[:, 1], uk))
    err = rel_err(np.asarray(C.vals)[:nnz], sums) if exact else float("inf")
    return dict(phase="consolidate", shapes=f"{n_entries} entries, "
                f"{side}x{side}, {uk.size} unique", err=err, tol=1e-6,
                indices_exact=bool(exact), compile_s=first - wall,
                wall_s=wall)


def phase_banded_spmv(n: int = 1 << 23, band: int = 5, seed: int = 0) -> dict:
    """Config-2 operator through ``best_spmv`` on ``SparseDIA`` and on the
    prepared (``prepare_dia``) form."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu.core.dia import SparseDIA
    from spsparse_tpu.ops import best_spmv, prepare_dia

    data, offs = banded_dia_data(n, band, seed)
    x = np.random.default_rng(seed + 1).uniform(-1, 1, n).astype(np.float32)
    dia = SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))
    prep = prepare_dia(dia)
    xd = jnp.asarray(x)
    f = jax.jit(best_spmv)
    y, first, wall = timed(f, dia, xd)
    y2 = f(prep, xd)
    ref = dia_apply_ref(data, offs, x)
    err = max(rel_err(y, ref), rel_err(y2, ref))
    return dict(phase="banded_spmv", shapes=f"n={n} K={len(offs)}",
                err=err, tol=1e-5, compile_s=first - wall, wall_s=wall,
                gbytes_per_s=(data.nbytes + 2 * 4 * n) / wall / 1e9)


def phase_banded_spmm(n: int = 1 << 23, band: int = 5, nrhs: int = 8,
                      seed: int = 0) -> dict:
    """The config-2 operator against ``nrhs`` right-hand sides through
    ``best_spmm`` (each diagonal read once for all columns)."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu.core.dia import SparseDIA
    from spsparse_tpu.ops import best_spmm

    data, offs = banded_dia_data(n, band, seed)
    X = np.random.default_rng(seed + 1).uniform(
        -1, 1, (n, nrhs)).astype(np.float32)
    dia = SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))
    Y, first, wall = timed(jax.jit(best_spmm), dia, jnp.asarray(X))
    err = rel_err(Y, dia_apply_ref(data, offs, X))
    return dict(phase="banded_spmm", shapes=f"n={n} K={len(offs)} "
                f"R={nrhs}", err=err, tol=1e-5, compile_s=first - wall,
                wall_s=wall,
                gbytes_per_s=(data.nbytes + 2 * 4 * n * nrhs) / wall / 1e9)


def _kernel_vs_plain(prep, Xp, interpret: bool):
    """Times and results of the Hopper block SpMM and its plain XLA form
    on the same padded operands (``interpret`` only for CPU rehearsals)."""
    import functools

    import jax
    from spsparse_tpu.ops.block_spmm import block_spmm_pallas, block_spmm_xla

    fk = jax.jit(functools.partial(block_spmm_pallas, interpret=interpret))
    fp = jax.jit(block_spmm_xla)
    args = (prep.tcols, prep.blocks, Xp.astype(prep.blocks.dtype))
    tk, tp = in_turns(fk, fp, args)
    return tk, tp, fk(*args), fp(*args)


def phase_block_spmm(m: int = 1 << 18, k: int = 50, nrhs: int = 128,
                     dtype: str = "float32", seed: int = 0,
                     compare_kernel: bool = True,
                     interpret: bool = False) -> dict:
    """Config-3 regridding matrix through ``prepare_general`` (dense-block
    layout) + ``best_spmm``. bf16 tolerance 2e-2: operands rounded to 8
    mantissa bits, products accumulated in f32."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu import SparseCOO
    from spsparse_tpu.core.tiled import TILE
    from spsparse_tpu.ops import best_spmm, prepare_general, spmm_route

    rr, cc, vv, shape = regrid_entries(m, k, seed)
    A = SparseCOO.from_arrays(np.stack([rr, cc], 1), vv, shape, check=False)
    t0 = time.perf_counter()
    pg = prepare_general(A, dtype=jnp.dtype(dtype))
    jax.block_until_ready(pg)
    prep_s = time.perf_counter() - t0
    X = np.random.default_rng(seed + 1).uniform(
        -1, 1, (shape[1], nrhs)).astype(np.float32)
    Xd = jnp.asarray(X)
    Y, first, wall = timed(jax.jit(best_spmm), pg, Xd)
    ref = csr_ref(rr, cc, vv, shape) @ X.astype(np.float64)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    out = dict(phase=f"block_spmm_{dtype}",
               shapes=f"{shape[0]}x{shape[1]} nnz={rr.size} N={nrhs} "
               f"layout={pg.kernel}", route=spmm_route(pg),
               err=rel_err(Y, ref), tol=tol, compile_s=first - wall,
               wall_s=wall, prepare_s=prep_s)
    if compare_kernel and pg.kernel == "dense_block":
        nbc = pg.prep.nbc
        Xo = Xd if pg.order is None else Xd[pg.order]
        Np = -(-nrhs // 64) * 64
        Xp = jnp.pad(Xo, ((0, nbc * TILE - shape[1]), (0, Np - nrhs)))
        tk, tp, yk, yp = _kernel_vs_plain(pg.prep, Xp, interpret)
        n_live = int(jnp.sum(pg.prep.tcols < nbc))
        out.update(kernel_s=tk, plain_s=tp, plain_over_kernel=tp / tk,
                   live_blocks=n_live,
                   err_plain=rel_err(np.asarray(yp)[:shape[0], :nrhs], ref),
                   err_kernel=rel_err(np.asarray(yk)[:shape[0], :nrhs], ref))
        out["err"] = max(out["err"], out["err_plain"], out["err_kernel"])
    return out


def phase_scattered_spmm(m: int = 1 << 14, k: int = 8, nrhs: int = 128,
                         seed: int = 0) -> dict:
    """Config-3b scattered matrix through ``prepare_general`` (gather-ELL
    layout) + ``best_spmm``."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu import SparseCOO
    from spsparse_tpu.ops import best_spmm, prepare_general, spmm_route

    rr, cc, vv, shape = scattered_entries(m, k, seed)
    A = SparseCOO.from_arrays(np.stack([rr, cc], 1), vv, shape, check=False)
    pg = prepare_general(A)
    X = np.random.default_rng(seed + 1).uniform(
        -1, 1, (shape[1], nrhs)).astype(np.float32)
    Y, first, wall = timed(jax.jit(best_spmm), pg, jnp.asarray(X))
    ref = csr_ref(rr, cc, vv, shape) @ X.astype(np.float64)
    return dict(phase="scattered_spmm",
                shapes=f"{shape[0]}x{shape[1]} nnz={rr.size} N={nrhs} "
                f"layout={pg.kernel}", route=spmm_route(pg),
                err=rel_err(Y, ref), tol=1e-5, compile_s=first - wall,
                wall_s=wall, ns_per_entry=wall / rr.size * 1e9)


def phase_spgemm(n_dst: int = 1 << 17, seed: int = 0,
                 compare_kernel: bool = True,
                 interpret: bool = False) -> dict:
    """Config-4 zipf matrix: ``A Aᵀ`` by ``best_spgemm`` (tiled) and by
    ESC ``spgemm_aat``, a bf16 tiled product (tolerance 2e-2), and the
    full scaled chain ``multiply(2, A, Aᵀ, scalei, scalej, scalek)``."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sps
    from spsparse_tpu import SparseCOO
    from spsparse_tpu.core.tiled import to_tiled
    from spsparse_tpu.ops import best_spgemm, multiply, spgemm_aat
    from spsparse_tpu.ops.spgemm_tiled import (
        _spgemm_tiled_xla, densify_tiled, plan_pstart, plan_tiled_spgemm,
        spgemm_pairs_pallas, spgemm_tiled)

    r, c, v, shape = zipf_entries(n_dst, seed)
    A = SparseCOO.from_arrays(np.stack([r, c], 1), v, shape, check=False)
    Ar = csr_ref(r, c, v, shape)
    ref = (Ar @ Ar.T).tocsr()
    t0 = time.perf_counter()
    C = best_spgemm(A, A, transpose_b=True)
    jax.block_until_ready(C.vals)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    C = best_spgemm(A, A, transpose_b=True)
    jax.block_until_ready(C.vals)
    wall = time.perf_counter() - t0
    err_tiled = sparse_rel_err(C, ref)
    err_esc = sparse_rel_err(spgemm_aat(A), ref)
    err_bf16 = sparse_rel_err(
        spgemm_tiled(A, A, transpose_b=True, dtype=jnp.bfloat16), ref)
    # scaled chain: 2 diag(si) A diag(sj) Aᵀ diag(sk)
    rng = np.random.default_rng(seed + 2)
    si, sj, sk = (rng.uniform(0.5, 1.5, n).astype(np.float32)
                  for n in (shape[0], shape[1], shape[0]))

    def vec(s):
        return SparseCOO.from_arrays(np.arange(s.size)[:, None], s,
                                     (s.size,))
    chain = multiply(2.0, A, A, transpose_b=True, scalei=vec(si),
                     scalej=vec(sj), scalek=vec(sk))
    ref_chain = 2.0 * (sps.diags(si.astype(np.float64)) @ Ar
                       @ sps.diags(sj.astype(np.float64)) @ Ar.T
                       @ sps.diags(sk.astype(np.float64))).tocsr()
    err_chain = sparse_rel_err(chain, ref_chain)
    out = dict(phase="spgemm", shapes=f"{shape[0]}x{shape[1]} nnz={r.size} "
               f"out_nnz={ref.nnz}", err=max(err_tiled, err_esc, err_chain),
               tol=1e-5, err_tiled=err_tiled, err_esc=err_esc,
               err_chain=err_chain, err_bf16=err_bf16, tol_bf16=2e-2,
               compile_s=first - wall, wall_s=wall)
    if compare_kernel:
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            ta = densify_tiled(to_tiled(A), dtype=dt)
            plan = plan_tiled_spgemm(ta, ta, transpose_b=True)
            ps = jnp.asarray(plan_pstart(plan))
            pa, pb, oid = (jnp.asarray(plan.pa), jnp.asarray(plan.pb),
                           jnp.asarray(plan.oid))
            n_out = plan.n_out_tiles

            def fk(blocks):
                return spgemm_pairs_pallas(blocks, blocks, ps, pa, pb,
                                           transpose_b=True, n_out=n_out,
                                           interpret=interpret)

            def fp(blocks):
                return _spgemm_tiled_xla(blocks, blocks, pa, pb, oid,
                                         transpose_b=True, n_out=n_out)
            fk, fp = jax.jit(fk), jax.jit(fp)
            tk, tp = in_turns(fk, fp, (ta.blocks,))
            diff = rel_err(fk(ta.blocks), fp(ta.blocks))
            out.update({f"kernel_s_{name}": tk, f"plain_s_{name}": tp,
                        f"plain_over_kernel_{name}": tp / tk,
                        f"kernel_vs_plain_{name}": diff,
                        "pairs": plan.n_pairs, "out_tiles": n_out})
            if name == "f32":
                out["err"] = max(out["err"], diff)
    out["err_bf16_ok"] = bool(err_bf16 <= 2e-2)
    return out


def phase_cg(grid: int = 2048, iters: int = 200, seed: int = 0) -> dict:
    """float64 5-point Poisson, ``cg_solve`` over ``best_spmv``, against a
    numpy float64 CG of the same iterations (same update formulas)."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu.core.dia import SparseDIA
    from spsparse_tpu.ops import best_spmv
    from spsparse_tpu.solvers import cg_solve

    data, offs = poisson_dia_data(grid)
    n = grid * grid
    b = np.random.default_rng(seed).uniform(-1, 1, n)
    dia = SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))

    def solve(d, rhs):
        return cg_solve(lambda v: best_spmv(d, v), rhs, iters=iters)
    (x, _), first, wall = timed(jax.jit(solve), dia, jnp.asarray(b),
                                reps=1)
    # host reference: the cg_step formulas in numpy float64
    xr = np.zeros(n)
    r = b - dia_apply_ref(data, offs, xr)
    p = r.copy()
    rs = r @ r
    for _ in range(iters):
        Ap = dia_apply_ref(data, offs, p)
        den = p @ Ap
        alpha = rs / (den if den != 0 else 1.0)
        xr = xr + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = r + rs_new / (rs if rs != 0 else 1.0) * p
        rs = rs_new
    return dict(phase="cg_f64", shapes=f"{grid}x{grid} grid, n={n}, "
                f"{iters} iters", err=rel_err(x, xr), tol=1e-8,
                compile_s=first - wall, wall_s=wall)


def phase_gradient(m: int = 1 << 14, k: int = 50, nrhs: int = 128,
                   seed: int = 0) -> dict:
    """``jax.grad`` of ``sum(W * best_spmm(prep, X))`` w.r.t. X and the
    blocks (the custom VJP) against ``jax.grad`` of the plain XLA form."""
    import jax
    import jax.numpy as jnp
    from spsparse_tpu import SparseCOO
    from spsparse_tpu.core.tiled import TILE
    from spsparse_tpu.ops import best_spmm, prepare_general
    from spsparse_tpu.ops.block_spmm import block_spmm_xla

    rr, cc, vv, shape = regrid_entries(m, k, seed)
    A = SparseCOO.from_arrays(np.stack([rr, cc], 1), vv, shape, check=False)
    pg = prepare_general(A, pack=False)
    rng = np.random.default_rng(seed + 1)
    X = jnp.asarray(rng.uniform(-1, 1, (shape[1], nrhs)).astype(np.float32))
    W = jnp.asarray(rng.uniform(-1, 1, (shape[0], nrhs)).astype(np.float32))
    prep = pg.prep

    def loss(blocks, Xc):
        p = dataclasses.replace(pg, prep=dataclasses.replace(prep,
                                                             blocks=blocks))
        return jnp.sum(W * best_spmm(p, Xc))

    def loss_plain(blocks, Xc):
        Xp = jnp.pad(Xc, ((0, prep.nbc * TILE - shape[1]), (0, 0)))
        y = block_spmm_xla(prep.tcols, blocks, Xp)[:shape[0]]
        return jnp.sum(W * y)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))
    (gb, gx), first, wall = timed(g, prep.blocks, X)
    rb, rx = jax.jit(jax.grad(loss_plain, argnums=(0, 1)))(prep.blocks, X)
    err = max(rel_err(gb, rb), rel_err(gx, rx))
    return dict(phase="gradient", shapes=f"{shape[0]}x{shape[1]} "
                f"N={nrhs} layout={pg.kernel}", err=err, tol=1e-5,
                compile_s=first - wall, wall_s=wall)


PHASES = [
    ("consolidate", phase_consolidate, {}),
    ("banded_spmv", phase_banded_spmv, {}),
    ("banded_spmm", phase_banded_spmm, {}),
    ("block_spmm_bfloat16", phase_block_spmm, {"dtype": "bfloat16"}),
    ("block_spmm_float32", phase_block_spmm, {"dtype": "float32"}),
    ("scattered_spmm", phase_scattered_spmm, {}),
    ("spgemm", phase_spgemm, {}),
    ("cg_f64", phase_cg, {}),
    ("gradient", phase_gradient, {}),
]


# --- four cards -------------------------------------------------------------


def host_csr(rows, cols, vals, shape):
    """A ``SparseCSR`` of host arrays from row-sorted entries (no device
    consolidate: the partitioners read host arrays anyway)."""
    from spsparse_tpu.core.structure import SparseCSR
    counts = np.bincount(rows, minlength=shape[0])
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return SparseCSR(row_ptr=row_ptr, cols=np.asarray(cols, np.int32),
                     vals=np.asarray(vals), nnz=np.int32(len(vals)),
                     shape=shape)


def banded_csr_entries(data, offsets):
    """Row-major (rows, cols, vals) of square DIA data, in-range only."""
    n = data.shape[1]
    offs = np.asarray(offsets)
    rows = np.repeat(np.arange(n), offs.size)
    cols = rows + np.tile(offs, n)
    vals = data.T.reshape(-1)
    keep = (cols >= 0) & (cols < n)
    return rows[keep], cols[keep], vals[keep]


def phase_four_cards(rows_per_card: int = 1 << 22, band: int = 5,
                     scattered_rows_per_card: int = 1 << 20,
                     seed: int = 0, n_devices: int = 4) -> dict:
    """The row-partitioned ``dist/`` path over a 1-D mesh of
    ``n_devices`` devices: the config-2 operator through
    ``dist_spmv_halo`` and ``dist_spmv(method="ring")``, a scattered
    operator through ``dist_spmv_a2a``, and one distributed ``cg_step``
    (float64, on the operator shifted by 12 I, whose symmetric part is
    positive definite: float32 dot products over millions of entries
    would round past the tolerance), each compared with single-device
    ``best_spmv`` and the float64 host reference."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from spsparse_tpu.core.dia import SparseDIA
    from spsparse_tpu.dist import (dist_spmv, dist_spmv_a2a, dist_spmv_halo,
                                   partition_footprint, partition_rows,
                                   partition_vector)
    from spsparse_tpu.ops import best_spmv
    from spsparse_tpu.solvers import CGState, cg_step

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, found "
                           f"{len(jax.devices())}")
    mesh = Mesh(np.asarray(devs), ("x",))
    shard = NamedSharding(mesh, P("x"))
    nparts = n_devices
    n = nparts * rows_per_card
    data, offs = banded_dia_data(n, band, seed)
    x = np.random.default_rng(seed + 1).uniform(-1, 1, n).astype(np.float32)
    ref = dia_apply_ref(data, offs, x)
    dia = SparseDIA(data=jnp.asarray(data, device=devs[0]), offsets=offs,
                    shape=(n, n))
    spmv_one = jax.jit(best_spmv)
    y_one = spmv_one(dia, jnp.asarray(x, device=devs[0]))
    t0 = time.perf_counter()
    part = jax.device_put(
        partition_rows(host_csr(*banded_csr_entries(data, offs), (n, n)),
                       nparts), shard)
    prep_s = time.perf_counter() - t0
    xp = jax.device_put(partition_vector(x, nparts), shard)
    out = {"phase": "four_cards", "shapes": f"n={n} K={len(offs)} over "
           f"{nparts} devices", "tol": 1e-5, "partition_s": prep_s}
    errs = {}
    placed = set()
    for name, f in (("halo", jax.jit(lambda p, v: dist_spmv_halo(
                        p, v, mesh, halo=band))),
                     ("ring", jax.jit(lambda p, v: dist_spmv(
                         p, v, mesh, method="ring")))):
        y, first, wall = timed(f, part, xp)
        placed |= {d.id for d in y.sharding.device_set}
        yv = np.asarray(y).reshape(-1)[:n]
        errs[name] = max(rel_err(yv, ref), rel_err(yv, np.asarray(y_one)))
        out[f"{name}_wall_s"] = wall
        out[f"{name}_compile_s"] = first - wall
    # scattered operator through the footprint all-to-all
    ns = nparts * scattered_rows_per_card
    rr, cc, vv, _ = scattered_entries(ns, 8, seed)
    cc = cc % ns
    S = host_csr(rr, cc, vv, (ns, ns))
    fpart = jax.device_put(partition_footprint(S, nparts), shard)
    xs = np.random.default_rng(seed + 3).uniform(-1, 1, ns).astype(
        np.float32)
    xsp = jax.device_put(partition_vector(xs, nparts), shard)
    ys, first, wall = timed(jax.jit(lambda p, v: dist_spmv_a2a(p, v, mesh)),
                            fpart, xsp)
    placed |= {d.id for d in ys.sharding.device_set}
    ref_s = csr_ref(rr, cc, vv, (ns, ns)) @ xs.astype(np.float64)
    S_one = jax.device_put(S, devs[0])
    y_one_s = spmv_one(S_one, jnp.asarray(xs, device=devs[0]))
    ysv = np.asarray(ys).reshape(-1)[:ns]
    errs["a2a"] = max(rel_err(ysv, ref_s), rel_err(ysv, np.asarray(y_one_s)))
    out["a2a_wall_s"] = wall
    # one distributed float64 CG step on A + 12 I vs one local step and
    # the host step
    shift = 12.0
    data64, x64 = data.astype(np.float64), x.astype(np.float64)
    part64 = jax.device_put(partition_rows(
        host_csr(*banded_csr_entries(data64, offs), (n, n)), nparts), shard)
    xp64 = jax.device_put(partition_vector(x64, nparts), shard)

    def first_step(matvec, v):
        # one CG step from x = 0 with b = v
        return cg_step(lambda u: matvec(u) + shift * u,
                       CGState(x=jnp.zeros_like(v), r=v, p=v,
                               rs=jnp.vdot(v, v)))
    st1 = jax.jit(lambda p, v: first_step(
        lambda u: dist_spmv_halo(p, u, mesh, halo=band), v))(part64, xp64)
    placed |= {d.id for d in st1.x.sharding.device_set}
    dia64 = SparseDIA(data=jnp.asarray(data64, device=devs[0]),
                      offsets=offs, shape=(n, n))
    loc = jax.jit(lambda d, v: first_step(lambda u: best_spmv(d, u), v))(
        dia64, jnp.asarray(x64, device=devs[0]))
    ap = dia_apply_ref(data64, offs, x64) + shift * x64
    alpha = (x64 @ x64) / (x64 @ ap)
    xs1 = np.asarray(st1.x).reshape(-1)[:n]
    rs1 = np.asarray(st1.r).reshape(-1)[:n]
    errs["cg_step"] = max(
        rel_err(xs1, np.asarray(loc.x)), rel_err(rs1, np.asarray(loc.r)),
        rel_err(xs1, alpha * x64), rel_err(rs1, x64 - alpha * ap))
    out.update({f"err_{k}": v for k, v in errs.items()})
    out["err"] = max(errs.values())
    out["devices_used"] = sorted(placed)
    out["placed_on_all"] = len(placed) == n_devices
    if not out["placed_on_all"]:
        out["err"] = float("inf")
    out["compile_s"] = out["halo_compile_s"]
    out["wall_s"] = out["halo_wall_s"]
    return out


# --- driver -----------------------------------------------------------------


def run_phase(name, fn, kwargs) -> bool:
    import jax

    try:
        res = fn(**kwargs)
    except Exception:
        traceback.print_exc()
        print(f"phase {name}: FAILED (exception above)", flush=True)
        return False
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    ok = bool(res["err"] <= res["tol"]) and res.get("err_bf16_ok", True)
    res["ok"] = ok
    print("phase " + json.dumps(res, default=float), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-partitioned path over 4 GPUs")
    args = ap.parse_args(argv)
    try:
        import jax
        devs = jax.devices()
    except Exception as e:
        print(f"chip_smoke: JAX found no usable backend: {e}",
              file=sys.stderr)
        return 2
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (default platform "
              f"{devs[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    try:
        import spsparse_tpu  # noqa: F401
        from spsparse_tpu.utils.compilecache import enable_persistent_cache
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    enable_persistent_cache()
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, devices: "
          f"{[d.device_kind for d in devs]}", flush=True)
    if args.four_cards:
        phases = [("four_cards", phase_four_cards, {})]
    else:
        phases = PHASES
    ok = True
    t0 = time.perf_counter()
    for name, fn, kw in phases:
        ok = run_phase(name, fn, kw) and ok
    print(f"total_s {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": ok, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
