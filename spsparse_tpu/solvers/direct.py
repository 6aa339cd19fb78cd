"""Direct sparse solvers: ``splu`` / ``spsolve`` / ``factorized`` /
``spsolve_triangular`` (the scipy.sparse.linalg surface; SuperLU
contract).

Host/device split
-----------------
*Factorization* is sequential pointer-chasing (symbolic DFS + sparse
column solves) and runs on the **host** in the native C++ runtime
(csrc/spsparse_lu.cpp, Gilbert-Peierls left-looking with threshold
partial pivoting; numpy fallback). *Solves* run on **device**: a
triangular factor with ``nlev`` dependency levels satisfies
``(D^-1 N)^nlev = 0`` (N = strict part), so

    x_{k+1} = D^-1 (b - N x_k)

reaches the exact solution after ``nlev - 1`` fully-vectorized SpMV
sweeps — no sequential substitution, no scatter ordering. Each sweep is
one gather + segment-add at full HBM bandwidth, and the whole solve is
jit-compatible (static trip count from the host-computed level depth).
This is the standard many-level trade: sweep work is ``nnz * nlev``, so
for *deep* factors (levels comparable to n — e.g. dense-ish bands) the
host's sequential O(nnz) substitution wins and ``method='auto'``
routes there (native ``spsparse_trisolve_csc_f64``).

No reference counterpart (SURVEY.md §2 — citibeth/spsparse has no
solver tier); scipy.sparse.linalg defines the API contract. Divergences
(documented, pinned in tests/test_direct.py):

* entries outside the stated triangle are *ignored* by
  ``spsolve_triangular`` (scipy reads them blindly and returns garbage
  for invalid input);
* singular/zero-diagonal inputs raise :class:`SpSparseError` (scipy
  raises ``LinAlgError``/``RuntimeError``);
* ``permc_spec`` supports ``'NATURAL'`` and ``'RCM'`` (bandwidth-
  reducing reverse Cuthill-McKee on the symmetrized pattern — the
  fill-reducing ordering this framework already ships) instead of
  SuperLU's COLAMD family.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from ..core.structure import to_csr  # noqa: F401  (re-export convenience)
from .. import native

__all__ = ["SparseLU", "splu", "spilu", "spsolve", "factorized",
           "spsolve_triangular"]


# ----------------------------------------------------------------------
# Host-side plumbing
# ----------------------------------------------------------------------

def _coo_to_csc_host(a: SparseCOO):
    """Host CSC triplets (colptr, rowind, val) of the live entries,
    duplicates summed (factorization needs canonical input)."""
    live = np.asarray(a.valid_mask())
    r = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    c = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    v = np.asarray(a.vals)[live].astype(np.float64)
    n, m = int(a.shape[0]), int(a.shape[1])
    order = np.lexsort((r, c))
    r, c, v = r[order], c[order], v[order]
    if r.size:
        same = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
        starts = np.concatenate([[True], ~same])
        seg = np.cumsum(starts) - 1
        vv = np.zeros(int(seg[-1]) + 1, np.float64)
        np.add.at(vv, seg, v)
        r, c, v = r[starts], c[starts], vv
    colptr = np.searchsorted(c, np.arange(m + 1)).astype(np.int64)
    return colptr, r, v


def _levels_from_csc(n, colptr, rowind, *, lower: bool):
    """Dependency level of each row of a triangular CSC factor: the
    longest chain of strict-part dependencies feeding it. Column sweep
    in elimination order — O(nnz) host prep, same eager-plan convention
    as graph.prepare_relax."""
    lev = np.zeros(n, np.int64)
    cols = range(n) if lower else range(n - 1, -1, -1)
    for j in cols:
        lj = lev[j] + 1
        sl = rowind[colptr[j]:colptr[j + 1]]
        dep = sl[sl > j] if lower else sl[sl < j]
        np.maximum.at(lev, dep, lj)
    return lev


#: widest ELL row accepted before the sweep plan falls back to the
#: COO-scatter formulation (keeps the (n, K) gather table bounded).
_ELL_MAX_WIDTH = 128

#: most distinct diagonals accepted for the DIA sweep layout (banded
#: factors — the shape RCM ordering produces).
_DIA_MAX_OFFSETS = 256


def _strict_parts(n, colptr, rowind, val, *, lower: bool):
    """Strict triangle of a CSC factor split out for the device sweep,
    plus the diagonal vector (1.0 where absent — callers validate
    separately). Returns ``(kind, payload, diag)``:

    * ``kind='ell'`` — scatter-free layout (same trick as
      graph.prepare_relax's ELL-by-head): ``payload = (C (n, K) int32
      column table, W (n, K) weights)``, padding slots read x[0] with
      weight 0. Each sweep is a dense gather + row sum — no scatter.
    * ``kind='dia'`` — banded factors (what RCM ordering produces):
      ``payload`` is a :class:`~spsparse_tpu.core.dia.SparseDIA` of the
      strict part, so each sweep rides the fused DIA SpMV (no gathers).
    * ``kind='coo'`` — ``payload = (rows, cols, w)`` padded COO with a
      sentinel row; used only when a skewed row would blow the ELL
      table past ``_ELL_MAX_WIDTH`` columns.
    """
    m = rowind.size
    c = np.repeat(np.arange(n, dtype=np.int64),
                  np.diff(colptr).astype(np.int64)) if m else \
        np.zeros(0, np.int64)
    r = rowind
    diag = np.ones(n, np.float64)
    on_diag = r == c
    diag[c[on_diag]] = val[on_diag]
    strict = (r > c) if lower else (r < c)
    rs, cs, vs = r[strict], c[strict], val[strict]
    counts = np.bincount(rs, minlength=n) if rs.size else \
        np.zeros(n, np.int64)
    K = int(counts.max()) if rs.size else 0
    if rs.size:
        offs = np.unique(cs - rs)
        # accept the DIA table when its padding blowup is bounded (4x
        # the strict nnz) or the table is small in absolute terms
        if offs.size <= _DIA_MAX_OFFSETS and \
                offs.size * n <= max(4 * rs.size, 1 << 20):
            from ..core.dia import SparseDIA
            pos = {int(o): d for d, o in enumerate(offs)}
            data = np.zeros((offs.size, n), np.float64)
            data[np.searchsorted(offs, cs - rs), rs] = vs
            dia = SparseDIA(data=jnp.asarray(data),
                            offsets=tuple(int(o) for o in offs),
                            shape=(n, n))
            return "dia", dia, diag
    if 0 < K <= _ELL_MAX_WIDTH:
        order = np.lexsort((cs, rs))
        rs, cs, vs = rs[order], cs[order], vs[order]
        # slot index within each row (rows are contiguous after sort)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rs.size) - starts[rs]
        C = np.zeros((n, K), np.int32)
        W = np.zeros((n, K), np.float64)
        C[rs, slot] = cs
        W[rs, slot] = vs
        return "ell", (C, W), diag
    cap = max(1, 1 << int(np.ceil(np.log2(max(1, rs.size)))))
    pad = cap - rs.size
    rs = np.concatenate([rs, np.full(pad, n, np.int64)])      # sentinel
    cs = np.concatenate([cs, np.zeros(pad, np.int64)])
    vs = np.concatenate([vs, np.zeros(pad, np.float64)])
    return "coo", (rs, cs, vs), diag


def _sweep_solve_ell(C, W, dinv, b, nsweeps: int):
    """Scatter-free device fixed-point triangular solve (exact after
    ``nsweeps`` sweeps — nilpotency of D^-1 N). ``b``: (n,) or (n, k)."""
    C = jnp.asarray(C)
    W = jnp.asarray(W, b.dtype)
    dinv = jnp.asarray(dinv, b.dtype)
    di = dinv if b.ndim == 1 else dinv[:, None]
    x0 = di * b

    def body(_, x):
        g = x[C]                                   # (n, K[, k]) gather
        nx = (jnp.einsum("ik,ik->i", W, g) if b.ndim == 1
              else jnp.einsum("ik,ikj->ij", W, g))
        return di * (b - nx)

    return lax.fori_loop(0, nsweeps, body, x0)


def _sweep_solve_dia(dia, dinv, b, nsweeps: int):
    """Banded-factor sweep: N @ x through the fused DIA path
    (``best_spmv``)."""
    from ..ops.spmv_kernels import best_spmv
    dinv = jnp.asarray(dinv, b.dtype)
    di = dinv if b.ndim == 1 else dinv[:, None]
    x0 = di * b
    mv = (lambda x: best_spmv(dia, x)) if b.ndim == 1 else \
        jax.vmap(lambda x: best_spmv(dia, x), in_axes=1, out_axes=1)

    def body(_, x):
        return di * (b - mv(x).astype(b.dtype))

    return lax.fori_loop(0, nsweeps, body, x0)


def _sweep_solve(rows, cols, w, dinv, b, nsweeps: int):
    """COO-scatter variant of the sweep (skewed-row fallback)."""
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    w = jnp.asarray(w, b.dtype)
    dinv = jnp.asarray(dinv, b.dtype)
    di = dinv if b.ndim == 1 else dinv[:, None]
    x0 = di * b

    def body(_, x):
        upd = w * x[cols] if b.ndim == 1 else w[:, None] * x[cols]
        nx = jnp.zeros_like(b).at[rows].add(upd, mode="drop")
        return di * (b - nx)

    return lax.fori_loop(0, nsweeps, body, x0)


class _TriPlan:
    """One triangular factor, prepped for both execution tiers."""

    def __init__(self, n, colptr, rowind, val, *, lower, unit_diag=False):
        self.n, self.lower, self.unit_diag = n, lower, unit_diag
        self.colptr, self.rowind, self.val = colptr, rowind, val
        lev = _levels_from_csc(n, colptr, rowind, lower=lower)
        self.nlev = int(lev.max()) + 1 if n else 0
        self.kind, self.payload, diag = _strict_parts(
            n, colptr, rowind, val, lower=lower)
        if unit_diag:
            diag = np.ones(n, np.float64)
        elif np.any(diag == 0.0):
            j = int(np.nonzero(diag == 0.0)[0][0])
            raise SpSparseError(f"singular triangular factor: zero "
                                f"diagonal at column {j}")
        self.dinv = 1.0 / diag

    def solve(self, b, method: str = "auto"):
        """``auto`` routing by level count: the device path runs one
        sweep per level (``nlev - 1`` sweeps), host substitution one pass.
        The sweep path therefore wins exactly for *shallow* factors
        (ILUT drops, block-structured systems); a contiguous band has
        ``nlev = n`` and always routes to the host, no matter how fast
        one sweep is."""
        if method == "auto":
            method = "device" if self.nlev <= max(64, self.n // 64) \
                else "host"
        if method == "device":
            ns = max(self.nlev - 1, 0)
            if self.kind == "dia":
                return _sweep_solve_dia(self.payload, self.dinv,
                                        jnp.asarray(b), ns)
            if self.kind == "ell":
                return _sweep_solve_ell(*self.payload, self.dinv,
                                        jnp.asarray(b), ns)
            return _sweep_solve(*self.payload, self.dinv,
                                jnp.asarray(b), ns)

        def host(bb):
            return np.asarray(
                native.trisolve_host(self.n, self.colptr, self.rowind,
                                     self.val, bb, lower=self.lower,
                                     unit_diagonal=self.unit_diag),
                np.asarray(bb).dtype)

        b = jnp.asarray(b)
        if isinstance(b, jax.core.Tracer):
            # jit-traced caller: the sequential host solve runs as a
            # shape-stable callback (same escape hatch jax uses for any
            # host-tier stage; vmap/grad of the deep-level host path is
            # not supported — use method='device' there)
            return jax.pure_callback(
                host, jax.ShapeDtypeStruct(b.shape, b.dtype), b,
                vmap_method="sequential")
        return jnp.asarray(host(np.asarray(b)))


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------

class SparseLU:
    """LU factorization of a square sparse matrix
    (scipy.sparse.linalg.SuperLU contract): ``Pr @ A @ Pc = L @ U``
    with ``Pr[perm_r, arange(n)] = 1`` and ``Pc[arange(n), perm_c] = 1``
    (the identity scipy documents; pinned in tests). ``L`` is unit lower
    triangular, ``U`` upper triangular, both :class:`SparseCOO`."""

    def __init__(self, a: SparseCOO, permc_spec: str = "NATURAL",
                 pivot_threshold: float = 1.0, solve_method: str = "auto",
                 drop_tol: float = 0.0, fill_factor: float | None = None):
        if a.rank != 2 or a.shape[0] != a.shape[1]:
            raise SpSparseError(f"splu needs a square rank-2 matrix, "
                                f"got {a.shape}")
        n = int(a.shape[0])
        self.shape = (n, n)
        colptr, rowind, val = _coo_to_csc_host(a)
        if permc_spec == "NATURAL":
            pc = np.arange(n, dtype=np.int64)
        elif permc_spec == "RCM":
            from ..core.reorder import rcm_permutation
            pc = np.asarray(rcm_permutation(a), np.int64)
        else:
            raise SpSparseError(
                f"permc_spec must be 'NATURAL' or 'RCM', got {permc_spec!r}")
        max_keep = -1
        if fill_factor is not None:
            # per-column budget: fill_factor x the average column fill
            # of A, split between L and U (SuperLU-spilu semantics)
            max_keep = max(1, int(np.ceil(
                fill_factor * max(1, rowind.size) / max(1, n))))
        try:
            (lcp, lri, lv), (ucp, uri, uv), pr = native.lu_factor_host(
                n, colptr, rowind, val, pc, pivot_threshold,
                drop_tol=drop_tol, max_keep_l=max_keep,
                max_keep_u=max_keep)
        except ValueError as e:
            raise SpSparseError(f"splu: {e}") from None
        self._solve_method = solve_method
        self._pr_internal = pr           # LU row i <- A row pr[i]
        self._pc_internal = pc           # LU col jj <- A col pc[jj]
        # scipy-orientation permutations (Pr A Pc = L U identity with
        # Pr[perm_r, arange] = 1 and Pc[arange, perm_c] = 1): both are
        # the inverses of the internal "LU axis <- A axis" maps.
        self.perm_r = np.argsort(pr).astype(np.int64)
        self.perm_c = np.argsort(pc).astype(np.int64)
        self._lplan = _TriPlan(n, lcp, lri, lv, lower=True, unit_diag=True)
        self._uplan = _TriPlan(n, ucp, uri, uv, lower=False)
        # transpose-solve plans built lazily (they re-level the factors)
        self._lt = self._ut = None
        self.nnz = int(lri.size + n + uri.size)

    # -- factor views ---------------------------------------------------
    def _factor_coo(self, colptr, rowind, val, *, with_unit_diag):
        n = self.shape[0]
        c = np.repeat(np.arange(n, dtype=np.int64),
                      np.diff(colptr).astype(np.int64))
        r, v = rowind, val
        if with_unit_diag:
            d = np.arange(n, dtype=np.int64)
            r = np.concatenate([r, d])
            c = np.concatenate([c, d])
            v = np.concatenate([v, np.ones(n)])
        idx = np.stack([r, c], axis=1)
        return SparseCOO.from_arrays(idx, v, self.shape).consolidate()

    @property
    def L(self) -> SparseCOO:
        return self._factor_coo(self._lplan.colptr, self._lplan.rowind,
                                self._lplan.val, with_unit_diag=True)

    @property
    def U(self) -> SparseCOO:
        return self._factor_coo(self._uplan.colptr, self._uplan.rowind,
                                self._uplan.val, with_unit_diag=False)

    # -- solves ----------------------------------------------------------
    def _transpose_plans(self):
        if self._lt is None:
            n = self.shape[0]
            def transpose_csc(colptr, rowind, val):
                c = np.repeat(np.arange(n, dtype=np.int64),
                              np.diff(colptr).astype(np.int64))
                order = np.lexsort((c, rowind))
                nr, nc, nv = c[order], rowind[order], val[order]
                ncp = np.searchsorted(nc, np.arange(n + 1)).astype(np.int64)
                return ncp, nr, nv
            lt = transpose_csc(self._lplan.colptr, self._lplan.rowind,
                               self._lplan.val)
            ut = transpose_csc(self._uplan.colptr, self._uplan.rowind,
                               self._uplan.val)
            self._lt = _TriPlan(n, *lt, lower=False, unit_diag=True)
            self._ut = _TriPlan(n, *ut, lower=True)
        return self._lt, self._ut

    def solve(self, b, trans: str = "N"):
        """Solve ``A x = b`` (``trans='N'``) or ``A^T x = b``
        (``'T'``/``'H'``); b: (n,) or (n, k). Device-resident result."""
        b = jnp.asarray(b)
        if b.shape[0] != self.shape[0]:
            raise SpSparseError(f"solve: b has leading dim {b.shape[0]}, "
                                f"matrix is {self.shape}")
        m = self._solve_method
        if trans == "N":
            # A = Pr^T L U Pc^T  =>  L U z = b[pr], x[pc] = z
            y = self._lplan.solve(b[jnp.asarray(self._pr_internal)], m)
            z = self._uplan.solve(y, m)
            return jnp.zeros_like(z).at[jnp.asarray(self._pc_internal)
                                        ].set(z)
        if trans in ("T", "H"):
            lt, ut = self._transpose_plans()
            w = ut.solve(b[jnp.asarray(self._pc_internal)], m)
            v = lt.solve(w, m)
            return jnp.zeros_like(v).at[jnp.asarray(self._pr_internal)
                                        ].set(v)
        raise SpSparseError(f"trans must be 'N', 'T' or 'H', got {trans!r}")

    def __call__(self, b):
        return self.solve(b)


def splu(a: SparseCOO, *, permc_spec: str = "NATURAL",
         pivot_threshold: float = 1.0,
         solve_method: str = "auto") -> SparseLU:
    """LU-factor a square sparse matrix (scipy.sparse.linalg.splu).
    Factorization runs on the host (native Gilbert-Peierls); the
    returned object's :meth:`SparseLU.solve` runs on device via
    level-sweep substitution (module docstring)."""
    return SparseLU(a, permc_spec=permc_spec,
                    pivot_threshold=pivot_threshold,
                    solve_method=solve_method)


def spilu(a: SparseCOO, *, drop_tol: float = 1e-4,
          fill_factor: float = 10.0, permc_spec: str = "NATURAL",
          pivot_threshold: float = 1.0,
          solve_method: str = "auto") -> SparseLU:
    """Incomplete LU (scipy.sparse.linalg.spilu; SuperLU ILUTP
    contract): dual-threshold ILUT — U entries below ``drop_tol *
    ||A[:, j]||`` and L multipliers below ``drop_tol`` are dropped, and
    each factor column keeps at most ``fill_factor * nnz(A)/n``
    entries. The returned object's approximate :meth:`SparseLU.solve`
    is the preconditioner ``M^-1`` to hand to the Krylov solvers
    (``pcg_solve``/``bicgstab_solve`` ``minv=ilu.solve``) — this is the
    triangular-solve preconditioner class solvers/precond.py originally
    excluded, made viable by the device level-sweep substitution
    (module docstring; shallow ILU factors have few levels)."""
    return SparseLU(a, permc_spec=permc_spec,
                    pivot_threshold=pivot_threshold,
                    solve_method=solve_method, drop_tol=drop_tol,
                    fill_factor=fill_factor)


def factorized(a: SparseCOO, **kw):
    """Pre-factorized solver callable (scipy.sparse.linalg.factorized):
    ``solve = factorized(A); x = solve(b)``."""
    return splu(a, **kw).solve


def spsolve(a: SparseCOO, b, **kw):
    """Direct solve ``A x = b`` (scipy.sparse.linalg.spsolve). ``b``
    dense (n,)/(n, k) returns a dense array; ``b`` a :class:`SparseCOO`
    returns a :class:`SparseCOO` (scipy's sparse-rhs convention)."""
    lu = splu(a, **kw)
    if isinstance(b, SparseCOO):
        x = lu.solve(b.to_dense())
        return SparseCOO.from_dense(x)
    return lu.solve(jnp.asarray(b))


def spsolve_triangular(a: SparseCOO, b, *, lower: bool = True,
                       unit_diagonal: bool = False,
                       method: str = "auto"):
    """Solve a triangular system (scipy.sparse.linalg.
    spsolve_triangular). Only the stated triangle is read (scipy does
    not mask and returns undefined results for non-triangular input —
    divergence documented in the module docstring). ``method``:
    ``'device'`` forces the level-sweep path, ``'host'`` the native
    sequential path, ``'auto'`` picks by level depth."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"spsolve_triangular needs a square matrix, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    colptr, rowind, val = _coo_to_csc_host(a)
    # mask to the stated triangle (incl. diagonal)
    c = np.repeat(np.arange(n, dtype=np.int64),
                  np.diff(colptr).astype(np.int64))
    keep = (rowind >= c) if lower else (rowind <= c)
    rowind, val, c = rowind[keep], val[keep], c[keep]
    colptr = np.searchsorted(c, np.arange(n + 1)).astype(np.int64)
    plan = _TriPlan(n, colptr, rowind, val, lower=lower,
                    unit_diag=unit_diagonal)
    if not unit_diagonal:
        # every diagonal entry must be *stored* (scipy contract)
        present = np.zeros(n, bool)
        present[c[rowind == c]] = True
        if not present.all():
            j = int(np.nonzero(~present)[0][0])
            raise SpSparseError(
                f"spsolve_triangular: missing diagonal at column {j}")
    return plan.solve(jnp.asarray(b), method)
