"""Semiring SpMV — the vectorized primitive under every graph algorithm.

Classic graph algorithms (BFS, Bellman-Ford shortest paths, reachability,
label propagation / connected components, Boruvka MST rounds) are all
iterated sparse matrix-vector products over a *semiring* other than
(+, x): min-plus for shortest paths, or-and for reachability, min-min
for label propagation.  On an accelerator this is the idiomatic formulation — each
relaxation round is one gather + one segmented reduction over the edge
list, fully vectorized, jit/vmap/while_loop-compatible — instead of the
pointer-chasing worklist loops a CPU library would use.

No reference counterpart: citibeth/spsparse has no graph layer at all
(SURVEY.md §2); the scipy counterpart is ``scipy.sparse.csgraph``, whose
algorithms :mod:`spsparse_tpu.graph.csgraph` rebuilds on top of this
primitive.

Frontier shape convention: ``x`` is ``(n,)`` for a single source or
``(n, k)`` for ``k`` simultaneous sources/labels (the batched axis rides
the vector width for free — multi-source shortest paths cost one extra
gather axis, not k passes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError

__all__ = [
    "Semiring", "MIN_PLUS", "MAX_PLUS", "MIN_MIN", "MAX_MIN", "OR_AND",
    "PLUS_TIMES", "spmv_semiring", "edge_arrays",
    "RelaxPlan", "prepare_relax", "relax",
]

Array = Any


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (combine, extend) pair with the combine identity.

    ``extend(w, x)`` maps an edge weight and the tail node's value to the
    edge's contribution; ``combine`` reduces contributions arriving at
    each head node (one of ``'min' | 'max' | 'sum'``, the three segmented
    reductions XLA lowers natively); ``identity`` is ``combine``'s
    identity, also used for padding and out-of-frontier nodes.
    """

    name: str
    combine: str                      # 'min' | 'max' | 'sum'
    extend: Callable[[Array, Array], Array]
    identity: float

    def segment(self, data: Array, segment_ids: Array, num: int) -> Array:
        if self.combine == "min":
            return jax.ops.segment_min(data, segment_ids, num_segments=num)
        if self.combine == "max":
            return jax.ops.segment_max(data, segment_ids, num_segments=num)
        if self.combine == "sum":
            return jax.ops.segment_sum(data, segment_ids, num_segments=num)
        raise SpSparseError(f"unknown combine {self.combine!r}")


MIN_PLUS = Semiring("min_plus", "min", lambda w, x: w + x, np.inf)
MAX_PLUS = Semiring("max_plus", "max", lambda w, x: w + x, -np.inf)
#: label propagation: carry the smaller of (incoming label, edge ignored)
MIN_MIN = Semiring("min_min", "min", lambda w, x: x, np.inf)
#: bottleneck / maximum-capacity paths
MAX_MIN = Semiring("max_min", "max", lambda w, x: jnp.minimum(w, x), -np.inf)
#: boolean reachability on 0/1 floats (max = or, * = and)
OR_AND = Semiring("or_and", "max", lambda w, x: x * (w != 0), 0.0)
PLUS_TIMES = Semiring("plus_times", "sum", lambda w, x: w * x, 0.0)


def edge_arrays(a: SparseCOO, *, directed: bool = True,
                unweighted: bool = False):
    """Edge list ``(tails, heads, weights, live)`` of a rank-2 graph.

    With ``directed=False`` every stored edge is emitted in both
    orientations (scipy.sparse.csgraph's undirected convention: the
    algorithm may travel ``csgraph[i, j]`` or ``csgraph[j, i]``), so the
    arrays have static length ``2*cap``. Padding slots come back with
    ``live=False`` and in-range node ids (0), so callers can mask
    contributions to the semiring identity without bounds issues.
    """
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"graph algorithms need a square rank-2 array, got {a.shape}")
    live = a.valid_mask()
    t = jnp.where(live, a.indices[:, 0], 0)
    h = jnp.where(live, a.indices[:, 1], 0)
    w = jnp.where(live, a.vals, 0)
    if unweighted:
        w = jnp.where(live, jnp.ones_like(a.vals), 0)
    if not directed:
        t, h = jnp.concatenate([t, h]), jnp.concatenate([h, t])
        w = jnp.concatenate([w, w])
        live = jnp.concatenate([live, live])
    return t, h, w, live


@dataclasses.dataclass(frozen=True)
class RelaxPlan:
    """Scatter-free relaxation layout: incoming edges grouped by head
    into ELL rows — ``tails (n, K)`` and ``weights (n, K)`` padded with
    a self-pointing tail and ``+/-inf``/0 weight mask. One relaxation
    round becomes a dense gather + a lane-axis reduction: no
    ``segment_*`` scatter at all, which matters twice — the round itself
    is a vectorized min instead of a serialized scatter, and the
    *compile* cost stays flat. Build once per graph (host-side, like
    ``to_dia``/``prepare_general``), relax many times under jit.
    """

    tails: Array      # (n, K) int32, padded entries point at row itself
    weights: Array    # (n, K) float, padded entries = NaN-free mask value
    pad: Array        # (n, K) bool, True where padded
    n: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def k(self) -> int:
        return int(self.tails.shape[1])


jax.tree_util.register_dataclass(
    RelaxPlan, data_fields=["tails", "weights", "pad"],
    meta_fields=["n"])


def prepare_relax(a: SparseCOO, *, directed: bool = True,
                  unweighted: bool = False) -> RelaxPlan:
    """Host-side grouping of edges by head node into the ELL-by-head
    layout (one-time planning cost, eager). ``K`` = max in-degree
    (after symmetrization when ``directed=False``); suitable when the
    in-degree is bounded — the usual case for mesh/coupling graphs. For
    power-law in-degrees prefer :func:`spmv_semiring` (the segment
    path), which is fill-insensitive."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"graph algorithms need a square rank-2 array, got {a.shape}")
    n = int(a.shape[0])
    live = np.asarray(a.valid_mask())
    t = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    h = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    w = np.asarray(a.vals)[live].astype(np.float64)
    if unweighted:
        w = np.ones_like(w)
    if not directed:
        t, h = np.concatenate([t, h]), np.concatenate([h, t])
        w = np.concatenate([w, w])
    order = np.argsort(h, kind="stable")
    t, h, w = t[order], h[order], w[order]
    ptr = np.searchsorted(h, np.arange(n + 1))
    deg = ptr[1:] - ptr[:-1]
    K = max(int(deg.max()) if n else 0, 1)
    tails = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    weights = np.zeros((n, K))
    pad = np.ones((n, K), bool)
    slot = np.arange(len(h)) - ptr[h]           # position within its row
    tails[h, slot] = t
    weights[h, slot] = w
    pad[h, slot] = False
    return RelaxPlan(tails=jnp.asarray(tails, jnp.int32),
                     weights=jnp.asarray(weights),
                     pad=jnp.asarray(pad), n=n)


def relax(plan: RelaxPlan, x: Array, semiring: Semiring) -> Array:
    """One scatter-free relaxation round over the prepared layout:
    ``y[j] = combine_k extend(weights[j, k], x[tails[j, k]])`` — a dense
    gather plus a lane-axis min/max/sum. jit/vmap-compatible; same
    result as :func:`spmv_semiring` on the same graph. ``x`` may be
    ``(n,)`` or ``(n, k)``."""
    x = jnp.asarray(x)
    ident = jnp.asarray(semiring.identity, x.dtype)
    extra = (...,) + (None,) * (x.ndim - 1)
    gathered = jnp.take(x, plan.tails, axis=0)       # (n, K[, k])
    contrib = semiring.extend(plan.weights.astype(x.dtype)[extra], gathered)
    contrib = jnp.where(plan.pad[extra], ident, contrib)
    if semiring.combine == "min":
        return jnp.min(contrib, axis=1)
    if semiring.combine == "max":
        return jnp.max(contrib, axis=1)
    return jnp.sum(contrib, axis=1)


def spmv_semiring(a: SparseCOO, x: Array, semiring: Semiring, *,
                  transpose: bool = False, directed: bool = True,
                  unweighted: bool = False) -> Array:
    """One relaxation round: ``y[j] = combine over edges (i, j) of
    extend(w_ij, x[i])``.

    ``x`` may be ``(n,)`` or ``(n, k)``; the result matches. Nodes with
    no incoming edge get ``semiring.identity`` — NOT ``x``'s old value;
    compose with ``jnp.minimum(x, y)`` etc. for monotone fixpoints.
    jit-compatible; works on unsorted, duplicate-bearing COO directly
    (the segmented reduction absorbs duplicates the same way the
    semiring would).
    """
    t, h, w, live = edge_arrays(a, directed=directed, unweighted=unweighted)
    if transpose:
        t, h = h, t
    x = jnp.asarray(x)
    ident = jnp.asarray(semiring.identity, x.dtype)
    contrib = semiring.extend(w.astype(x.dtype)[(...,) + (None,) * (x.ndim - 1)],
                              jnp.take(x, t, axis=0))
    contrib = jnp.where(live[(...,) + (None,) * (x.ndim - 1)], contrib, ident)
    return semiring.segment(contrib, h, int(a.shape[0]))
