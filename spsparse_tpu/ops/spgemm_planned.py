"""Static-pattern ("planned") ESC SpGEMM: sorts at prepare time, none at
run time.

The general ESC path re-derives everything per call: consolidate the
operands, join-expand the products, stable-sort the product stream by
output cell, merge, compact — 5-6 device sorts plus scans per product.
But for repeated products over a FIXED sparsity pattern (the framework's
core use case — regridding operators applied every step, Gram matrices
in solvers), every one of those sorts depends only on the PATTERN:

* which (A entry, B entry) pairs multiply          -> two static gather
  maps, pre-sorted by output cell;
* where each product accumulates                   -> a static sorted
  segment id vector;
* which output cells exist                         -> a static index
  array.

``plan_esc`` runs the expansion + sort ONCE host-side (numpy); the
jitted ``spgemm_planned_vals`` is then

    out[c] = sum over s in segment c of  va[ea[s]] * vb[eb[s]]

— two gathers, one multiply, one sorted ``segment_sum``. No sort, no
consolidate, no compaction on device.

Semantic note (documented divergence): the output PATTERN is static, so
cells whose value sums to exact zero remain present with value 0 (like
scipy's explicit zeros), unlike :func:`spsparse_tpu.ops.spgemm.spgemm`
which drops them per the reference contract
(``multiply_sparse.hpp:238-243``). Call ``.consolidate()``/
``filter_compact`` on the result if exact-zero dropping matters.
Accumulation order within a cell is ascending (i, k) — the same
ascending-k term order as the ESC path's stable sort.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError, spsparse_error

Array = Any

__all__ = ["EscPlan", "plan_esc", "spgemm_planned_vals", "spgemm_planned"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EscPlan:
    """Static product plan over consolidated operand patterns.

    ``ea/eb (P,)`` index the CONSOLIDATED operands' value vectors (pairs
    pre-sorted by output cell, ascending (i,k) within a cell);
    ``seg (P,)`` sorted output-cell ids; ``out_indices (n_out, 2)``.
    ``acon/bcon`` hold the consolidated patterns the value vectors must
    correspond to (``plan_esc`` returns them; pass
    ``acon.vals``/``bcon.vals``-shaped arrays to the apply)."""

    ea: Array = dataclasses.field(metadata=dict(static=False))
    eb: Array = dataclasses.field(metadata=dict(static=False))
    seg: Array = dataclasses.field(metadata=dict(static=False))
    out_indices: Array = dataclasses.field(metadata=dict(static=False))
    n_out: int = dataclasses.field(metadata=dict(static=True))
    out_shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_products(self) -> int:
        return self.ea.shape[0]


def _consolidate_host_coo(M: SparseCOO) -> SparseCOO:
    """Row-major host consolidate (native C++ / numpy — no device
    compiles); returns an exact-size device :class:`SparseCOO` with the
    same pattern/value contract as ``M.consolidate((0, 1))``."""
    from .. import native

    n = int(M.nnz)
    idx = np.asarray(M.indices)[:n]
    vals = np.asarray(M.vals)[:n]
    out_idx, out_vals = native.consolidate_host(idx, vals, M.shape, (0, 1))
    m = out_idx.shape[0]
    return SparseCOO(indices=jnp.asarray(out_idx, M.index_dtype),
                     vals=jnp.asarray(out_vals, M.dtype),
                     nnz=jnp.asarray(m, jnp.int32),
                     shape=M.shape, sort_order=(0, 1))


def plan_esc(A: SparseCOO, B: SparseCOO, *, transpose_a: bool = False,
             transpose_b: bool = False, host: bool = False):
    """Host-side (eager) plan build. Returns ``(plan, acon, bcon)`` where
    ``acon``/``bcon`` are the consolidated operands whose ``.vals`` slots
    the plan's gather maps index. One plan serves any number of value
    updates with the same pattern.

    ``host=True`` consolidates the operands with the native C++ / numpy
    host path instead of the device path — no device compiles at plan
    time (the device consolidates' first-call compiles dominate a one-shot
    plan).
    The resulting pattern is identical; the one divergence is that
    ``acon``/``bcon`` come back exact-size (cap == nnz) rather than
    padded to the operand's cap."""
    if A.rank != 2 or B.rank != 2:
        spsparse_error(-1, "plan_esc requires rank-2 operands")
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    if Aw.shape[1] != Bw.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and B (%d) must match!",
            Aw.shape[1], Bw.shape[0])
    if host:
        acon = _consolidate_host_coo(Aw)
        bcon = _consolidate_host_coo(Bw)
    else:
        # these consolidates run on the default device (first call pays
        # their compiles — amortized over every value update that reuses
        # the plan); the expansion/sort below is vectorized numpy.
        acon = Aw.consolidate((0, 1))
        bcon = Bw.consolidate((0, 1))
    na, nb = int(acon.nnz), int(bcon.nnz)
    ai = np.asarray(acon.indices[:na, 0], np.int64)
    ak = np.asarray(acon.indices[:na, 1], np.int64)
    bk = np.asarray(bcon.indices[:nb, 0], np.int64)
    bj = np.asarray(bcon.indices[:nb, 1], np.int64)

    # expansion: A entries x matching B rows (numpy, prepare-time)
    b_start = np.searchsorted(bk, np.arange(Bw.shape[0] + 1))
    cnt = b_start[np.minimum(ak + 1, Bw.shape[0])] - \
        b_start[np.minimum(ak, Bw.shape[0])]
    ea = np.repeat(np.arange(na), cnt)
    if ea.size:
        run0 = np.cumsum(cnt) - cnt
        within = np.arange(ea.size) - np.repeat(run0, cnt)
        eb = b_start[ak[ea]] + within
    else:
        eb = np.zeros(0, np.int64)

    i_p = ai[ea]
    j_p = bj[eb]
    # sort products by output cell; ascending (i, k) within a cell
    # matches the ESC stable sort's accumulation order
    order = np.lexsort((ea, j_p, i_p))
    ea, eb, i_p, j_p = ea[order], eb[order], i_p[order], j_p[order]
    cell = i_p * Bw.shape[1] + j_p
    first = np.concatenate([[True], cell[1:] != cell[:-1]]) \
        if cell.size else np.zeros(0, bool)
    seg = np.cumsum(first) - 1 if cell.size else np.zeros(0, np.int64)
    n_out = int(seg[-1]) + 1 if cell.size else 0
    out_idx = np.stack([i_p[first], j_p[first]], axis=1) \
        if cell.size else np.zeros((0, 2), np.int64)
    plan = EscPlan(ea=jnp.asarray(ea, jnp.int32),
                   eb=jnp.asarray(eb, jnp.int32),
                   seg=jnp.asarray(seg, jnp.int32),
                   out_indices=jnp.asarray(out_idx, acon.index_dtype),
                   n_out=n_out,
                   out_shape=(Aw.shape[0], Bw.shape[1]))
    return plan, acon, bcon


@jax.jit
def spgemm_planned_vals(plan: EscPlan, va: Array, vb: Array) -> Array:
    """Jitted apply: output values for the plan's static cells.
    ``va``/``vb`` are the consolidated operands' padded value vectors."""
    prod = jnp.take(va, plan.ea) * jnp.take(vb, plan.eb)
    return jax.ops.segment_sum(prod, plan.seg,
                               num_segments=max(plan.n_out, 1),
                               indices_are_sorted=True)


def spgemm_planned(plan: EscPlan, va: Array, vb: Array) -> SparseCOO:
    """Apply + wrap as a sorted :class:`SparseCOO` (static pattern;
    exact-zero sums retained — see module docstring)."""
    vals = spgemm_planned_vals(plan, va, vb)
    if plan.n_out == 0:
        return SparseCOO.empty(plan.out_shape, 1)
    return SparseCOO(indices=plan.out_indices, vals=vals,
                     nnz=jnp.asarray(plan.n_out, jnp.int32),
                     shape=plan.out_shape, sort_order=(0, 1))
