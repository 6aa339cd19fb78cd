"""ctypes bindings for the native host runtime (csrc/spsparse_host.cpp).

The C++ library accelerates the *host-side* phases of the pipeline — bulk
COO ingest, consolidate (stable sort + duplicate merge), CSR/row-pointer
construction — which run before data ships to device memory. It is
built from ``csrc/*.cpp`` on first use with ``make`` (g++), or ahead of
time with ``make -C csrc``; when the toolchain or binary is unavailable
every entry point falls back to the equivalent numpy implementation, so
the framework never hard-requires the native tier.

Semantics match :func:`spsparse_tpu.core.consolidate.consolidate` exactly
(same reference contract, algorithm.hpp:251-319) and are cross-checked in
``tests/test_native.py``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from functools import lru_cache
from typing import Sequence

import numpy as np

from ..core.errors import DuplicatePolicy

logger = logging.getLogger("spsparse_tpu.native")

__all__ = ["available", "consolidate_host", "dim_beginnings_host",
           "csr_row_ptr_host", "check_bounds_host",
           "lu_factor_host", "trisolve_host"]

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_SO = os.path.join(_CSRC, "libspsparse_host.so")


def _find_so() -> str:
    """Installed-wheel extension first (built by setup.py as
    ``_spsparse_host*.so`` next to this file), then the csrc build."""
    import glob
    here = os.path.dirname(__file__)
    hits = sorted(glob.glob(os.path.join(here, "_spsparse_host*.so")))
    if hits:
        return hits[0]
    return _SO


@lru_cache(maxsize=1)
def _lib():
    """Load (building if needed) the native library; None if unavailable."""
    try:
        so = _find_so()
        if not os.path.exists(so):
            subprocess.run(["make", "-C", _CSRC], check=True,
                           capture_output=True)
            so = _SO
        lib = ctypes.CDLL(so)
    except Exception as e:  # pragma: no cover - toolchain-dependent
        logger.info("native host library unavailable (%s); using numpy", e)
        return None
    lib.spsparse_consolidate_f64.restype = ctypes.c_int64
    lib.spsparse_consolidate_f64.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.spsparse_dim_beginnings_i64.restype = ctypes.c_int64
    lib.spsparse_dim_beginnings_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spsparse_csr_row_ptr.restype = None
    lib.spsparse_csr_row_ptr.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spsparse_check_bounds.restype = ctypes.c_int64
    lib.spsparse_check_bounds.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _i64p, _f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(
        ctypes.c_double)
    lib.spsparse_lu_factor_f64.restype = ctypes.c_void_p
    lib.spsparse_lu_factor_f64.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _i64p, ctypes.c_double, _i64p]
    lib.spsparse_lu_factor_ex_f64.restype = ctypes.c_void_p
    lib.spsparse_lu_factor_ex_f64.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _i64p, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.spsparse_lu_nnz_l.restype = ctypes.c_int64
    lib.spsparse_lu_nnz_l.argtypes = [ctypes.c_void_p]
    lib.spsparse_lu_nnz_u.restype = ctypes.c_int64
    lib.spsparse_lu_nnz_u.argtypes = [ctypes.c_void_p]
    lib.spsparse_lu_get.restype = None
    lib.spsparse_lu_get.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64p]
    lib.spsparse_lu_free.restype = None
    lib.spsparse_lu_free.argtypes = [ctypes.c_void_p]
    lib.spsparse_trisolve_csc_f64.restype = ctypes.c_int64
    lib.spsparse_trisolve_csc_f64.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, ctypes.c_int32, ctypes.c_int32,
        _f64p, ctypes.c_int64, ctypes.c_int64]
    return lib


def available() -> bool:
    return _lib() is not None


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _numpy_consolidate(indices, vals, shape, sort_order, policy, zero_nan):
    """Pure-numpy reference fallback (same contract)."""
    keep = vals != 0
    if zero_nan:
        keep &= ~np.isnan(vals)
    idx = indices[keep]
    v = vals[keep]
    if idx.shape[0] == 0:
        return idx.reshape(0, indices.shape[1]), v
    order = np.lexsort(tuple(idx[:, d] for d in reversed(sort_order)))
    idx, v = idx[order], v[order]
    same = np.all(idx[1:] == idx[:-1], axis=1)
    starts = np.concatenate([[True], ~same])
    seg = np.cumsum(starts) - 1
    out_idx = idx[starts]
    if policy == DuplicatePolicy.ADD:
        out_v = np.zeros(out_idx.shape[0], v.dtype)
        np.add.at(out_v, seg, v)
    elif policy == DuplicatePolicy.LEAVE_ALONE:
        out_v = v[starts]
    else:  # REPLACE: last of each run
        ends = np.concatenate([starts[1:], [True]])
        out_v = v[ends]
    return out_idx, out_v


def consolidate_host(
    indices, vals, shape: Sequence[int],
    sort_order: Sequence[int] | None = None,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False, n_threads: int | None = None,
):
    """Host consolidate: returns compact ``(indices (m, rank), vals (m,))``
    numpy arrays, sorted by ``sort_order`` with duplicates merged."""
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    if indices.ndim == 1:
        indices = indices[:, None]
    vals = np.ascontiguousarray(np.asarray(vals, np.float64))
    n, rank = indices.shape
    sort_order = tuple(sort_order or range(rank))
    lib = _lib()
    if lib is not None and n:
        out_idx = np.empty_like(indices)
        out_vals = np.empty_like(vals)
        shape_a = np.asarray(shape, np.int64)
        so_a = np.asarray(sort_order, np.int32)
        nt = n_threads if n_threads is not None else (os.cpu_count() or 1)
        m = lib.spsparse_consolidate_f64(
            _p64(indices), _pf64(vals), n, rank, _p64(shape_a), _p32(so_a),
            int(duplicate_policy.value), int(bool(zero_nan)), int(nt),
            _p64(out_idx), _pf64(out_vals))
        if m >= 0:
            return out_idx[:m].copy(), out_vals[:m].copy()
        logger.info("native consolidate declined input; numpy fallback")
    return _numpy_consolidate(indices, vals, shape, sort_order,
                              duplicate_policy, zero_nan)


def dim_beginnings_host(lead):
    """Present-rows begins (+sentinel) and row ids from sorted lead column."""
    lead = np.ascontiguousarray(np.asarray(lead, np.int64))
    n = lead.shape[0]
    lib = _lib()
    if lib is not None:
        begins = np.empty(n + 1, np.int64)
        rows = np.empty(max(n, 1), np.int64)
        r = lib.spsparse_dim_beginnings_i64(_p64(lead), n, _p64(begins),
                                            _p64(rows))
        return begins[: r + 1].copy(), rows[:r].copy()
    if n == 0:
        return np.zeros(1, np.int64), np.zeros(0, np.int64)
    starts = np.concatenate([[True], lead[1:] != lead[:-1]])
    begins = np.concatenate([np.nonzero(starts)[0], [n]]).astype(np.int64)
    return begins, lead[starts]


def csr_row_ptr_host(rows, nrows: int):
    rows = np.ascontiguousarray(np.asarray(rows, np.int64))
    lib = _lib()
    if lib is not None:
        out = np.empty(nrows + 1, np.int64)
        lib.spsparse_csr_row_ptr(_p64(rows), rows.shape[0], nrows, _p64(out))
        return out
    return np.searchsorted(rows, np.arange(nrows + 1)).astype(np.int64)


def check_bounds_host(indices, shape) -> int:
    """Index of first out-of-bounds entry, or -1."""
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    if indices.ndim == 1:
        indices = indices[:, None]
    lib = _lib()
    shape_a = np.asarray(shape, np.int64)
    if lib is not None:
        return int(lib.spsparse_check_bounds(
            _p64(indices), indices.shape[0], indices.shape[1], _p64(shape_a)))
    bad = (indices < 0) | (indices >= shape_a)
    rows = np.nonzero(bad.any(axis=1))[0]
    return int(rows[0]) if rows.size else -1


def _numpy_lu(n, colptr, rowind, val, perm_c, pivot_threshold):
    """Dense partial-pivot LU fallback (O(n^3)); same output contract as
    the native Gilbert-Peierls factor. Only sensible for small n."""
    A = np.zeros((n, n))
    for j in range(n):
        for p in range(colptr[j], colptr[j + 1]):
            A[rowind[p], j] += val[p]
    A = A[:, perm_c]
    piv = np.arange(n)
    for k in range(n):
        col = np.abs(A[k:, k])
        if col.max() == 0:
            return None, k
        m = k + int(np.argmax(col))
        if np.abs(A[k, k]) >= pivot_threshold * col.max() and A[k, k] != 0:
            m = k
        if m != k:
            A[[k, m]] = A[[m, k]]
            piv[[k, m]] = piv[[m, k]]
        A[k + 1:, k] /= A[k, k]
        A[k + 1:, k + 1:] -= np.outer(A[k + 1:, k], A[k, k + 1:])
    L = np.tril(A, -1)
    U = np.triu(A)
    def to_csc(M):
        cp = [0]; ri = []; v = []
        for j in range(n):
            nz = np.nonzero(M[:, j])[0]
            ri.extend(nz.tolist()); v.extend(M[nz, j].tolist())
            cp.append(len(ri))
        return (np.asarray(cp, np.int64), np.asarray(ri, np.int64),
                np.asarray(v, np.float64))
    return (to_csc(L), to_csc(U), piv.astype(np.int64)), -1


def lu_factor_host(n: int, colptr, rowind, val, perm_c=None,
                   pivot_threshold: float = 1.0, drop_tol: float = 0.0,
                   max_keep_l: int = -1, max_keep_u: int = -1):
    """Sparse LU of CSC input: ``A[:, perm_c] = P^T L U`` (native
    Gilbert-Peierls left-looking with threshold partial pivoting; dense
    numpy fallback). Returns ``((l_colptr, l_rowind, l_val),
    (u_colptr, u_rowind, u_val), perm_r)`` — L unit-diagonal (diagonal
    not stored), U includes the diagonal, both CSC in pivoted row
    coordinates. Raises ``ValueError`` naming the failing column when
    singular.

    ``drop_tol``/``max_keep_l``/``max_keep_u`` enable incomplete (ILUT)
    factorization — see csrc/spsparse_lu.cpp. The numpy fallback
    applies the drop rules post-hoc to the exact factors (a coarser
    approximation than the native incremental drops; ILU factors are
    approximate by definition either way)."""
    colptr = np.ascontiguousarray(colptr, np.int64)
    rowind = np.ascontiguousarray(rowind, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    pc = np.ascontiguousarray(
        perm_c if perm_c is not None else np.arange(n), np.int64)
    lib = _lib()
    if lib is not None:
        info = np.empty(1, np.int64)
        h = lib.spsparse_lu_factor_ex_f64(n, _p64(colptr), _p64(rowind),
                                          _pf64(val), _p64(pc),
                                          float(pivot_threshold),
                                          float(drop_tol),
                                          int(max_keep_l), int(max_keep_u),
                                          _p64(info))
        if not h:
            raise ValueError(f"matrix is singular at column {int(info[0])}")
        try:
            nl = lib.spsparse_lu_nnz_l(h)
            nu = lib.spsparse_lu_nnz_u(h)
            lcp = np.empty(n + 1, np.int64)
            lri = np.empty(max(nl, 1), np.int64)
            lv = np.empty(max(nl, 1), np.float64)
            ucp = np.empty(n + 1, np.int64)
            uri = np.empty(max(nu, 1), np.int64)
            uv = np.empty(max(nu, 1), np.float64)
            pr = np.empty(n, np.int64)
            lib.spsparse_lu_get(h, _p64(lcp), _p64(lri), _pf64(lv),
                                _p64(ucp), _p64(uri), _pf64(uv), _p64(pr))
        finally:
            lib.spsparse_lu_free(h)
        return ((lcp, lri[:nl], lv[:nl]), (ucp, uri[:nu], uv[:nu]), pr)
    out, bad = _numpy_lu(n, colptr, rowind, val, pc, pivot_threshold)
    if out is None:
        raise ValueError(f"matrix is singular at column {bad}")
    if drop_tol > 0.0 or max_keep_l >= 0 or max_keep_u >= 0:
        (lcp, lri, lv), (ucp, uri, uv), pr = out
        colnorm = np.zeros(n)
        np.add.at(colnorm,
                  np.repeat(np.arange(n), np.diff(colptr)), val ** 2)
        colnorm = np.sqrt(colnorm)[pc]

        def drop(cp, ri, v, tol_per_col, keep, protect_diag):
            ncp = [0]; nri = []; nv = []
            for j in range(n):
                lo, hi = cp[j], cp[j + 1]
                r, x = ri[lo:hi], v[lo:hi]
                is_diag = (r == j) if protect_diag else np.zeros(r.size,
                                                                 bool)
                ok = is_diag | (np.abs(x) >= tol_per_col[j])
                if keep >= 0 and ok.sum() > keep + is_diag.sum():
                    mag = np.where(is_diag, np.inf, np.abs(x))
                    thresh = np.sort(mag[ok])[::-1][keep + is_diag.sum()
                                                    - 1]
                    ok &= mag >= thresh
                nri.extend(r[ok].tolist()); nv.extend(x[ok].tolist())
                ncp.append(len(nri))
            return (np.asarray(ncp, np.int64), np.asarray(nri, np.int64),
                    np.asarray(nv, np.float64))

        ltol = np.full(n, drop_tol)
        utol = drop_tol * colnorm
        out = (drop(lcp, lri, lv, ltol, max_keep_l, False),
               drop(ucp, uri, uv, utol, max_keep_u, True), pr)
    return out


def trisolve_host(n: int, colptr, rowind, val, b, *, lower: bool,
                  unit_diagonal: bool = False):
    """Sequential CSC triangular solve on the host (fallback path for
    deep-level factors — solvers/direct.py). ``b``: (n,) or (n, k);
    returns the solution with b's trailing shape. Raises ``ValueError``
    on a zero/missing diagonal."""
    colptr = np.ascontiguousarray(colptr, np.int64)
    rowind = np.ascontiguousarray(rowind, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    # always copy: the C kernel solves in place and must never alias the
    # caller's buffer (a 1-D b reshaped/transposed is a contiguous VIEW)
    B = np.array(b.reshape(n, -1).T, np.float64, order="C", copy=True)
    lib = _lib()
    if lib is not None:
        r = lib.spsparse_trisolve_csc_f64(
            n, _p64(colptr), _p64(rowind), _pf64(val),
            int(bool(lower)), int(bool(unit_diagonal)),
            _pf64(B), B.shape[0], n)
        if r >= 0:
            raise ValueError(f"zero diagonal at column {int(r)}")
    else:
        for x in B:                                   # numpy fallback
            cols = range(n) if lower else range(n - 1, -1, -1)
            for j in cols:
                lo, hi = colptr[j], colptr[j + 1]
                rs, vs = rowind[lo:hi], val[lo:hi]
                if not unit_diagonal:
                    dm = rs == j
                    if not dm.any() or vs[dm][0] == 0:
                        raise ValueError(f"zero diagonal at column {j}")
                    x[j] /= vs[dm][0]
                off = rs > j if lower else rs < j
                x[rs[off]] -= vs[off] * x[j]
    out = B.T
    return out[:, 0] if squeeze else out.reshape(b.shape)
