"""Graph algorithms over sparse adjacency matrices — the
``scipy.sparse.csgraph`` tier, rebuilt data-parallel.

Every algorithm here is an iterated :func:`~spsparse_tpu.graph.semiring.
spmv_semiring` relaxation (gather + segmented reduction over the edge
list) inside a ``lax.while_loop`` — the data-parallel formulation that
maps onto wide vector hardware — instead of the priority-queue / worklist loops a CPU
library uses.  Consequences worth knowing:

* ``shortest_path`` runs Bellman-Ford (all sources in one batched pass),
  not Dijkstra: on an accelerator the O(E) fully-vectorized relaxation round beats a
  sequential heap by orders of magnitude, and for non-negative weights
  the results are identical.  ``method='D'`` therefore routes to the same
  relaxation (scipy-compatible results, different algorithm).
* Structures with data-dependent sizes (BFS orders, strongly-connected
  components via Tarjan) follow the framework's host/device split
  (core/reorder.py convention): sequential pointer-chasing runs on the
  host in numpy; everything fixed-shape runs on device and is
  jit/vmap-compatible.

Edge semantics match scipy's sparse-input convention: explicitly stored
zeros ARE zero-weight edges (padding slots are masked out separately);
``directed=False`` lets the algorithm travel both ``G[i, j]`` and
``G[j, i]``.

No reference counterpart: citibeth/spsparse has no graph layer
(SURVEY.md §2); this tier exists because its regridding-matrix domain
(mesh couplings) is exactly where bandwidth/RCM/partitioning graph
machinery pays off, and `core.reorder` already opened that door.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.algebra import coo_add, coo_scale
from ..core.consolidate import filter_compact
from ..core.construct import coo_filter
from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from .semiring import MIN_PLUS, RelaxPlan, edge_arrays, relax

__all__ = [
    "bellman_ford", "dijkstra", "johnson", "shortest_path",
    "floyd_warshall", "bfs_levels", "breadth_first_order",
    "depth_first_order", "breadth_first_tree", "depth_first_tree",
    "connected_components", "minimum_spanning_tree",
    "laplacian", "maximum_bipartite_matching",
    "min_weight_full_bipartite_matching", "structural_rank",
    "maximum_flow", "MaximumFlowResult", "NEG_SENTINEL",
    "NegativeCycleError", "yen", "reconstruct_path", "construct_dist_matrix",
    "csgraph_from_dense", "csgraph_to_dense", "csgraph_from_masked",
    "csgraph_to_masked",
]

Array = Any

#: scipy.sparse.csgraph's "no predecessor" marker.
NEG_SENTINEL = -9999


class NegativeCycleError(SpSparseError):
    """A negative-weight cycle is reachable from a requested source
    (scipy.sparse.csgraph.NegativeCycleError). Subclasses
    :class:`SpSparseError` so framework-level handlers keep working."""


def _float_dtype(a: SparseCOO):
    return a.dtype if jnp.issubdtype(a.dtype, jnp.floating) else jnp.float64


# ----------------------------------------------------------------------
# Shortest paths
# ----------------------------------------------------------------------

def _relax_rounds(t, h, w, live, n, d0, maxiter):
    """Iterate ``d[j] = min(d[j], min over edges (i,j) of d[i]+w)`` until
    fixpoint (or ``maxiter`` rounds); returns (dist, still_improving)."""
    inf = jnp.asarray(jnp.inf, d0.dtype)
    wl = jnp.where(live, w, jnp.inf).astype(d0.dtype)

    def relax(d):
        c = jnp.take(d, t, axis=0) + wl[:, None]       # (E, k)
        y = jax.ops.segment_min(c, h, num_segments=n)  # (n, k)
        return jnp.minimum(d, jnp.minimum(y, inf))

    def cond(s):
        it, _, changed = s
        return jnp.logical_and(it < maxiter, changed)

    def body(s):
        it, d, _ = s
        nd = relax(d)
        return it + 1, nd, jnp.any(nd < d)

    _, d, _ = lax.while_loop(cond, body, (0, relax(d0), jnp.array(True)))
    improving = jnp.any(relax(d) < d)
    return d, improving


def _predecessors(t, h, w, live, n, d):
    """Shortest-path tree from converged distances ``d (n, k)``:
    ``pred[j]`` is the tail of a minimizing incoming edge, i.e. an
    argmin over edges ``(i, j)`` of ``d[i] + w`` (ties to the smallest
    tail). At an exact relaxation fixpoint that minimum equals ``d[j]``;
    formulating it as an argmin (both sides of the tie test read the
    same contribution array) keeps the tree valid even when ``d`` came
    from a different summation order (Floyd-Warshall pivots round
    differently than edge relaxations). Self-loops never belong to a
    shortest-path tree and are excluded."""
    ok = live & (t != h)
    wl = jnp.where(ok, w, jnp.inf).astype(d.dtype)
    c = jnp.take(d, t, axis=0) + wl[:, None]
    m = jax.ops.segment_min(c, h, num_segments=n)
    best = (c == jnp.take(m, h, axis=0)) & jnp.isfinite(c)
    cand = jnp.where(best, t[:, None], n).astype(jnp.int32)
    pred = jax.ops.segment_min(cand, h, num_segments=n)
    # >= n covers both "no finite incoming contribution" (n) and "no
    # incoming edge at all" (segment_min's int32-max identity).
    return jnp.where(pred >= n, NEG_SENTINEL, pred)


def bellman_ford(a: SparseCOO, sources, *, directed: bool = True,
                 unweighted: bool = False, return_predecessors: bool = False,
                 maxiter: int | None = None):
    """Multi-source Bellman-Ford shortest paths
    (scipy.sparse.csgraph.bellman_ford).

    ``sources`` is a length-``k`` array of source nodes; returns ``dist``
    of shape ``(k, n)`` (``inf`` where unreachable) and, with
    ``return_predecessors``, the ``(k, n)`` int32 predecessor matrix with
    ``-9999`` at sources/unreachable nodes (scipy's convention — any
    valid shortest-path tree; ties broken to the smallest tail node).

    Negative edge weights are supported. A reachable negative cycle
    raises :class:`SpSparseError` when running eagerly; under ``jit``
    (where raising is impossible) the affected distances are left
    partially relaxed and callers can pre-check with ``n`` extra rounds.
    jit/vmap-compatible (static ``k``).

    ``a`` may also be a pre-built :class:`~spsparse_tpu.graph.semiring.
    RelaxPlan` (in which case ``directed``/``unweighted`` are already
    baked in and must be left at their defaults) — the scatter-free
    fast path for iterated solves on the same graph: the ELL-by-head
    plan is a dense gather + min with flat compile cost, where the
    scatter-based ``segment_min`` round serializes on its scatter.
    """
    if isinstance(a, RelaxPlan):
        if not directed or unweighted:
            raise SpSparseError(
                "bellman_ford(plan): direction/weights are baked into "
                "the RelaxPlan at prepare_relax time; leave the flags "
                "at their defaults")
        return _bellman_ford_plan(a, sources, return_predecessors,
                                  maxiter)
    t, h, w, live = edge_arrays(a, directed=directed, unweighted=unweighted)
    n = int(a.shape[0])
    sources = jnp.atleast_1d(jnp.asarray(sources)).astype(jnp.int32)
    k = sources.shape[0]
    dt = _float_dtype(a)
    d0 = jnp.full((n, k), jnp.inf, dt)
    d0 = d0.at[sources, jnp.arange(k)].set(0)
    d, improving = _relax_rounds(t, h, w, live, n, d0, maxiter or n)
    if maxiter is None and not isinstance(improving, jax.core.Tracer):
        if bool(improving):
            raise NegativeCycleError(
                "bellman_ford: negative-weight cycle reachable from a source")
    dist = d.T
    if not return_predecessors:
        return dist
    pred = _predecessors(t, h, w, live, n, d).T
    pred = pred.at[jnp.arange(k), sources].set(NEG_SENTINEL)
    return dist, pred


def _bellman_ford_plan(plan: RelaxPlan, sources, return_predecessors,
                       maxiter):
    """Bellman-Ford over the scatter-free ELL-by-head layout."""
    n = plan.n
    sources = jnp.atleast_1d(jnp.asarray(sources)).astype(jnp.int32)
    k = sources.shape[0]
    dt = plan.weights.dtype if jnp.issubdtype(plan.weights.dtype,
                                              jnp.floating) else jnp.float64
    d0 = jnp.full((n, k), jnp.inf, dt)
    d0 = d0.at[sources, jnp.arange(k)].set(0)
    rounds = n if maxiter is None else int(maxiter)

    def step(d):
        return jnp.minimum(d, relax(plan, d, MIN_PLUS))

    def cond(s):
        it, _, changed = s
        return jnp.logical_and(it < rounds, changed)

    def body(s):
        it, d, _ = s
        nd = step(d)
        return it + 1, nd, jnp.any(nd < d)

    _, d, _ = lax.while_loop(cond, body, (0, step(d0), jnp.array(True)))
    improving = jnp.any(step(d) < d)
    if maxiter is None and not isinstance(improving, jax.core.Tracer):
        if bool(improving):
            raise NegativeCycleError(
                "bellman_ford: negative-weight cycle reachable from a "
                "source")
    dist = d.T
    if not return_predecessors:
        return dist
    # argmin incoming edge per node, straight off the ELL layout
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    ok = (~plan.pad) & (plan.tails != rows)         # no pads, no self-loops
    wl = jnp.where(ok, plan.weights.astype(dt), jnp.inf)
    c = jnp.take(d, plan.tails, axis=0) + wl[:, :, None]   # (n, K, k)
    m = jnp.min(c, axis=1)                                  # (n, k)
    best = (c == m[:, None, :]) & jnp.isfinite(c)
    cand = jnp.where(best, plan.tails[:, :, None], n).astype(jnp.int32)
    pred = jnp.min(cand, axis=1)
    pred = jnp.where(pred >= n, NEG_SENTINEL, pred).T
    pred = pred.at[jnp.arange(k), sources].set(NEG_SENTINEL)
    return dist, pred


def shortest_path(a: SparseCOO, *, method: str = "auto",
                  directed: bool = True, indices=None,
                  unweighted: bool = False,
                  return_predecessors: bool = False):
    """All-pairs / multi-source shortest paths
    (scipy.sparse.csgraph.shortest_path).

    ``method``: ``'BF'``/``'D'``/``'auto'`` run the batched Bellman-Ford
    relaxation (identical results to Dijkstra for non-negative weights —
    see module docstring); ``'FW'`` runs the dense Floyd-Warshall. With
    ``indices=None`` all ``n`` sources are solved in one batch.
    """
    n = int(a.shape[0])
    if method == "FW":
        if indices is not None:
            raise SpSparseError("method='FW' computes all pairs; "
                                "indices is not supported (scipy parity)")
        return floyd_warshall(a, directed=directed, unweighted=unweighted,
                              return_predecessors=return_predecessors)
    if method not in ("auto", "BF", "D"):
        raise SpSparseError(f"unknown shortest_path method {method!r}")
    sources = jnp.arange(n) if indices is None else indices
    return bellman_ford(a, sources, directed=directed, unweighted=unweighted,
                        return_predecessors=return_predecessors)


def dijkstra(a: SparseCOO, *, directed: bool = True, indices=None,
             unweighted: bool = False, return_predecessors: bool = False,
             limit: float = np.inf, min_only: bool = False):
    """Shortest paths for non-negative weights
    (scipy.sparse.csgraph.dijkstra).

    Data-parallel divergence (documented, results identical): there is no
    priority queue — the batched Bellman-Ford relaxation computes the
    same distances (module docstring), and for negative inputs this
    implementation therefore returns *correct* shortest paths where
    scipy's heap-based dijkstra silently returns wrong ones (it only
    warns; scipy _shortest_path.pyx behavior). We emit the same
    ``UserWarning`` for scipy parity and keep the correct answer.

    ``limit``: distances strictly greater than ``limit`` are reported as
    ``inf`` (and their predecessors cleared) — equivalent to scipy's
    bounded exploration, post-hoc.

    ``min_only`` (requires ``indices``): collapse the source axis —
    returns ``(dist (n,), predecessors (n,), sources (n,))`` when
    ``return_predecessors`` else just ``dist``; ``sources[j]`` is the
    source achieving the min (ties to the first listed), ``-9999`` where
    unreachable.
    """
    n = int(a.shape[0])
    w_live = np.asarray(a.vals)[np.asarray(a.valid_mask())]
    if not unweighted and w_live.size and w_live.min() < 0:
        import warnings
        warnings.warn("Graph has negative weights: results remain exact "
                      "here (relaxation engine), unlike scipy's dijkstra.",
                      UserWarning, stacklevel=2)
    if min_only and indices is None:
        raise SpSparseError("dijkstra: min_only requires indices")
    sources = jnp.arange(n) if indices is None else \
        jnp.atleast_1d(jnp.asarray(indices))
    out = bellman_ford(a, sources, directed=directed, unweighted=unweighted,
                       return_predecessors=return_predecessors)
    dist, pred = out if return_predecessors else (out, None)
    lim = jnp.asarray(limit, dist.dtype)
    over = dist > lim
    dist = jnp.where(over, jnp.inf, dist)
    if pred is not None:
        pred = jnp.where(over, NEG_SENTINEL, pred)
    if min_only:
        kbest = jnp.argmin(dist, axis=0)                  # (n,) first-min
        take = lambda m: jnp.take_along_axis(m, kbest[None, :], 0)[0]
        dmin = take(dist)
        src = jnp.where(jnp.isfinite(dmin), sources[kbest], NEG_SENTINEL)
        if not return_predecessors:
            return dmin
        return dmin, take(pred), src.astype(jnp.int32)
    if return_predecessors:
        return dist, pred
    return dist


def johnson(a: SparseCOO, *, directed: bool = True, indices=None,
            return_predecessors: bool = False):
    """All-pairs shortest paths with negative weights allowed
    (scipy.sparse.csgraph.johnson).

    scipy's Johnson reweights with a Bellman-Ford potential pass so its
    Dijkstra core can run; our relaxation engine handles negative
    weights natively, so the potential pass would be a no-op — this is
    the same batched computation as :func:`bellman_ford`, kept as a
    separate entry point for API parity. Raises
    :class:`NegativeCycleError` on any negative cycle (scipy raises on
    cycles anywhere in the graph; we raise when one is reachable from a
    requested source, which is the observable subset)."""
    n = int(a.shape[0])
    sources = jnp.arange(n) if indices is None else \
        jnp.atleast_1d(jnp.asarray(indices))
    return bellman_ford(a, sources, directed=directed,
                        return_predecessors=return_predecessors)


def floyd_warshall(a: SparseCOO, *, directed: bool = True,
                   unweighted: bool = False,
                   return_predecessors: bool = False):
    """Dense all-pairs shortest paths (scipy.sparse.csgraph.
    floyd_warshall): ``lax.fori_loop`` over pivots, each round a fully
    vectorized ``(n, n)`` min-plus rank-1 update. O(n^3) work, O(n^2)
    memory — the right tool up to a few thousand nodes; beyond that use
    the edge-list Bellman-Ford."""
    t, h, w, live = edge_arrays(a, unweighted=unweighted)
    n = int(a.shape[0])
    dt = _float_dtype(a)
    D = jnp.full((n, n), jnp.inf, dt)
    D = D.at[t, h].min(jnp.where(live, w, jnp.inf).astype(dt))
    if not directed:
        D = jnp.minimum(D, D.T)
    D = jnp.where(jnp.eye(n, dtype=bool), 0, D)

    def body(k, D):
        col = lax.dynamic_slice_in_dim(D, k, 1, axis=1)   # (n, 1)
        row = lax.dynamic_slice_in_dim(D, k, 1, axis=0)   # (1, n)
        return jnp.minimum(D, col + row)

    D = lax.fori_loop(0, n, body, D)
    neg = jnp.any(jnp.diagonal(D) < 0)
    if not isinstance(neg, jax.core.Tracer) and bool(neg):
        raise NegativeCycleError("floyd_warshall: negative-weight cycle")
    if not return_predecessors:
        return D
    if not directed:
        # undirected: edges usable both ways in the tree reconstruction
        t, h = jnp.concatenate([t, h]), jnp.concatenate([h, t])
        w = jnp.concatenate([w, w])
        live = jnp.concatenate([live, live])
    pred = _predecessors(t, h, w, live, n, D.T).T
    pred = pred.at[jnp.arange(n), jnp.arange(n)].set(NEG_SENTINEL)
    return D, pred


# ----------------------------------------------------------------------
# BFS
# ----------------------------------------------------------------------

def bfs_levels(a: SparseCOO, source: int | Array, *,
               directed: bool = True) -> Array:
    """Hop counts from ``source`` (``inf`` where unreachable) — the
    level-synchronous BFS, i.e. unweighted Bellman-Ford. jit-compatible;
    device-resident output ``(n,)``."""
    return bellman_ford(a, jnp.atleast_1d(source), directed=directed,
                        unweighted=True, maxiter=int(a.shape[0]))[0]


def breadth_first_order(a: SparseCOO, i_start: int, *,
                        directed: bool = True,
                        return_predecessors: bool = True):
    """BFS visit order from ``i_start``
    (scipy.sparse.csgraph.breadth_first_order).

    Returns ``node_array`` (the reachable nodes in scipy's queue-BFS
    discovery order — neighbors explored in ascending node id, which
    matches scipy exactly for canonical sorted-indices CSR input) and,
    optionally, the ``(n,)`` predecessor array (``-9999`` at the source
    and unreachable nodes, parent = first discoverer). Host-returning
    (variable-length output), like ``rcm_permutation`` — run eagerly.
    Device-side BFS levels live in :func:`bfs_levels`.
    """
    from collections import deque
    n = int(a.shape[0])
    ptr, h, _ = _host_adjacency(a, directed, scipy_order=True)
    seen = np.zeros(n, bool)
    pred = np.full(n, NEG_SENTINEL, np.int32)
    order = []
    q = deque([int(i_start)])
    seen[int(i_start)] = True
    while q:
        v = q.popleft()
        order.append(v)
        for u in h[ptr[v]:ptr[v + 1]]:
            if not seen[u]:
                seen[u] = True
                pred[u] = v
                q.append(int(u))
    node_array = np.asarray(order, np.int32)
    if not return_predecessors:
        return node_array
    return node_array, pred


def _host_adjacency(a: SparseCOO, directed: bool, *,
                    scipy_order: bool = False):
    """Host CSR view ``(ptr, heads, weights)`` — the adjacency layout
    every sequential host-tier traversal shares (same host/device split
    as Tarjan/RCM). Default: heads sorted ascending within each row
    (binary-searchable). With ``scipy_order=True`` and
    ``directed=False``, each row lists the node's out-neighbors (CSR
    order) before its in-neighbors (transpose order) — scipy's
    undirected traversal order (csgraph row first, then csgraph.T row);
    for directed graphs the two orders coincide on canonical input."""
    live = np.asarray(a.valid_mask())
    t = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    h = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    w = np.asarray(a.vals)[live]
    if directed:
        order = np.lexsort((h, t))
    else:
        m = t.size
        t, h = np.concatenate([t, h]), np.concatenate([h, t])
        w = np.concatenate([w, w])
        if scipy_order:
            flag = np.repeat(np.array([0, 1], np.int8), m)
            order = np.lexsort((h, flag, t))
        else:
            order = np.lexsort((h, t))
    n = int(a.shape[0])
    t, h, w = t[order], h[order], w[order]
    ptr = np.searchsorted(t, np.arange(n + 1))
    return ptr, h, w


def depth_first_order(a: SparseCOO, i_start: int, *,
                      directed: bool = True,
                      return_predecessors: bool = True):
    """DFS preorder from ``i_start``
    (scipy.sparse.csgraph.depth_first_order): neighbors explored in
    ascending node id, which reproduces scipy's order exactly for
    canonical (sorted-indices) CSR input. Host-returning
    (variable-length output) like :func:`breadth_first_order`."""
    n = int(a.shape[0])
    ptr, h, _ = _host_adjacency(a, directed, scipy_order=True)
    seen = np.zeros(n, bool)
    pred = np.full(n, NEG_SENTINEL, np.int32)
    order = []
    stack = [(int(i_start), NEG_SENTINEL)]
    while stack:
        v, p = stack.pop()
        if seen[v]:
            continue
        seen[v] = True
        if p != NEG_SENTINEL:
            pred[v] = p
        order.append(v)
        nbrs = h[ptr[v]:ptr[v + 1]]
        for u in nbrs[::-1]:
            if not seen[u]:
                stack.append((int(u), v))
    node_array = np.asarray(order, np.int32)
    if not return_predecessors:
        return node_array
    return node_array, pred


def _tree_from_pred(a: SparseCOO, pred, *, directed: bool) -> SparseCOO:
    """Tree edges ``(pred[v], v)`` as a SparseCOO with the traversed
    edge's stored weight (scipy's *_tree output contract). Parallel
    edges take the minimum weight (consistent with the min-plus
    traversal semantics of this module); with ``directed=False`` the
    minimum of the two stored orientations is used (scipy's
    ``reconstruct_path`` convention)."""
    n = int(a.shape[0])
    pred = np.asarray(pred)
    child = np.nonzero(pred != NEG_SENTINEL)[0]
    parent = pred[child]
    ptr, h, w = _host_adjacency(a, directed)

    def lookup(p, v):
        lo, hi = ptr[p], ptr[p + 1]
        k = lo + np.searchsorted(h[lo:hi], v)
        best = np.inf
        while k < hi and h[k] == v:
            best = min(best, w[k])
            k += 1
        return best

    vals = np.array([lookup(p, v) for p, v in zip(parent, child)])
    idx = np.stack([parent, child], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(idx, vals, (n, n))


def breadth_first_tree(a: SparseCOO, i_start: int, *,
                       directed: bool = True) -> SparseCOO:
    """The BFS spanning tree rooted at ``i_start`` as a sparse matrix
    (scipy.sparse.csgraph.breadth_first_tree); matches scipy exactly
    for canonical CSR input (see :func:`breadth_first_order`)."""
    _, pred = breadth_first_order(a, i_start, directed=directed,
                                  return_predecessors=True)
    return _tree_from_pred(a, pred, directed=directed)


def depth_first_tree(a: SparseCOO, i_start: int, *,
                     directed: bool = True) -> SparseCOO:
    """The DFS spanning tree rooted at ``i_start``
    (scipy.sparse.csgraph.depth_first_tree); matches scipy exactly for
    canonical CSR input (see :func:`depth_first_order`)."""
    _, pred = depth_first_order(a, i_start, directed=directed,
                                return_predecessors=True)
    return _tree_from_pred(a, pred, directed=directed)


# ----------------------------------------------------------------------
# Connected components
# ----------------------------------------------------------------------

def _min_label_components(t, h, live, n):
    """Min-label propagation + pointer jumping: converged ``lab[i]`` is
    the smallest node id in i's component. O(log n)-ish rounds, each a
    segmented min + two gathers."""
    lab0 = jnp.arange(n, dtype=jnp.int32)
    t = jnp.where(live, t, 0).astype(jnp.int32)
    h = jnp.where(live, h, 0).astype(jnp.int32)

    def step(lab):
        inc = jax.ops.segment_min(
            jnp.where(live, lab[t], n).astype(jnp.int32), h, num_segments=n)
        lab = jnp.minimum(lab, inc)
        lab = jnp.minimum(lab, lab[lab])        # pointer jumping
        return jnp.minimum(lab, lab[lab])

    def cond(s):
        it, lab, changed = s
        return jnp.logical_and(it < n, changed)

    def body(s):
        it, lab, _ = s
        nl = step(lab)
        return it + 1, nl, jnp.any(nl != lab)

    _, lab, _ = lax.while_loop(cond, body, (0, step(lab0), jnp.array(True)))
    return lab


def _host_tarjan(t, h, n):
    """Iterative Tarjan SCC on the host (numpy) — sequential by nature,
    same host/device split as `core.reorder`. Returns labels relabeled
    in order of first node occurrence."""
    order = np.lexsort((h, t))
    t, h = t[order], h[order]
    ptr = np.searchsorted(t, np.arange(n + 1))
    index = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    on_stack = np.zeros(n, bool)
    stack: list[int] = []
    labels = np.full(n, -1, np.int64)
    counter = 0
    n_comp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        # (node, next-edge-offset) explicit DFS stack
        work = [(root, ptr[root])]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < ptr[v + 1]:
                work[-1] = (v, ei + 1)
                u = h[ei]
                if index[u] == -1:
                    index[u] = low[u] = counter
                    counter += 1
                    stack.append(u)
                    on_stack[u] = True
                    work.append((u, ptr[u]))
                elif on_stack[u]:
                    low[v] = min(low[v], index[u])
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    while True:
                        u = stack.pop()
                        on_stack[u] = False
                        labels[u] = n_comp
                        if u == v:
                            break
                    n_comp += 1
    # relabel by first occurrence (scipy-friendly canonical order)
    remap = np.full(n_comp, -1, np.int64)
    nxt = 0
    for lbl in labels:
        if remap[lbl] == -1:
            remap[lbl] = nxt
            nxt += 1
    return n_comp, remap[labels]


def connected_components(a: SparseCOO, *, directed: bool = True,
                         connection: str = "weak",
                         return_labels: bool = True):
    """Connected components (scipy.sparse.csgraph.connected_components).

    Weak (or undirected) components run on device: min-label propagation
    with pointer jumping under ``lax.while_loop`` — labels are numbered
    in order of first node occurrence, matching scipy. Strong components
    of a directed graph are inherently sequential (Tarjan) and run on the
    host. Returns ``(n_components, labels)`` (or just the count).
    """
    n = int(a.shape[0])
    if directed and connection == "strong":
        t, h, _, live = edge_arrays(a)
        lv = np.asarray(live)
        tn = np.asarray(t)[lv].astype(np.int64)
        hn = np.asarray(h)[lv].astype(np.int64)
        n_comp, labels = _host_tarjan(tn, hn, n)
        return (n_comp, jnp.asarray(labels, jnp.int32)) if return_labels \
            else n_comp
    if connection not in ("weak", "strong"):
        raise SpSparseError(f"unknown connection {connection!r}")
    t, h, _, live = edge_arrays(a, directed=False)
    lab = _min_label_components(t, h, live, n)
    is_root = lab == jnp.arange(n, dtype=jnp.int32)
    n_comp = jnp.sum(is_root)
    labels = (jnp.cumsum(is_root) - 1).astype(jnp.int32)[lab]
    if not isinstance(n_comp, jax.core.Tracer):
        n_comp = int(n_comp)
    return (n_comp, labels) if return_labels else n_comp


# ----------------------------------------------------------------------
# Minimum spanning tree (Boruvka)
# ----------------------------------------------------------------------

def minimum_spanning_tree(a: SparseCOO) -> SparseCOO:
    """Minimum spanning forest
    (scipy.sparse.csgraph.minimum_spanning_tree), via Boruvka rounds —
    the data-parallel MST: every round, each component picks its
    lightest outgoing edge (one segmented min over the edge list) and
    the chosen edges merge components; O(log n) rounds total, each fully
    vectorized. Ties break on (weight, edge id), which makes the chosen
    set cycle-free (standard Boruvka argument for distinct keys).

    The input is treated as undirected (either orientation of a stored
    entry defines the edge, as in scipy); the result keeps one entry per
    tree edge in ``(min(i,j), max(i,j))`` orientation, row-major sorted.
    jit-compatible.
    """
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"minimum_spanning_tree needs a square rank-2 array, "
            f"got {a.shape}")
    n = int(a.shape[0])
    live0 = a.valid_mask()
    i = jnp.where(live0, a.indices[:, 0], 0).astype(jnp.int32)
    j = jnp.where(live0, a.indices[:, 1], 0).astype(jnp.int32)
    u = jnp.minimum(i, j)
    v = jnp.maximum(i, j)
    live = live0 & (u != v)                    # self-loops never in a tree
    E = int(u.shape[0])
    w = jnp.where(live, a.vals, 0).astype(_float_dtype(a))
    eid = jnp.arange(E, dtype=jnp.int32)

    both_t = jnp.concatenate([u, v])
    both_h = jnp.concatenate([v, u])

    def round_(state):
        comp, forest, _ = state
        cu, cv = comp[u], comp[v]
        cross = live & (cu != cv)
        winf = jnp.where(cross, w, jnp.inf)
        # each endpoint's component sees the edge
        seg = jnp.concatenate([cu, cv])
        ww = jnp.concatenate([winf, winf])
        ee = jnp.concatenate([eid, eid])
        m = jax.ops.segment_min(ww, seg, num_segments=n)
        cand = jnp.isfinite(ww) & (ww == m[seg])
        ce = jax.ops.segment_min(jnp.where(cand, ee, E), seg, num_segments=n)
        chosen = jnp.zeros(E + 1, bool).at[ce].set(True)[:E] & cross
        new_forest = forest | chosen
        new_comp = _min_label_components(
            both_t, both_h, jnp.concatenate([new_forest, new_forest]), n)
        return new_comp, new_forest, jnp.any(chosen)

    init = (jnp.arange(n, dtype=jnp.int32), jnp.zeros(E, bool),
            jnp.array(True))
    _, forest, _ = lax.while_loop(lambda s: s[2], round_, init)

    und = SparseCOO(indices=jnp.stack(
        [jnp.where(live0, u, jnp.asarray(a.shape[0], jnp.int32)),
         jnp.where(live0, v, jnp.asarray(a.shape[1], jnp.int32))],
        axis=1).astype(a.index_dtype),
        vals=a.vals, nnz=a.nnz, shape=a.shape)
    tree = filter_compact(und, forest)
    return tree.consolidate((0, 1))


# ----------------------------------------------------------------------
# Bipartite matching
# ----------------------------------------------------------------------

def maximum_bipartite_matching(a: SparseCOO, *,
                               perm_type: str = "row") -> np.ndarray:
    """Maximum-cardinality matching of the bipartite graph whose
    biadjacency matrix is ``a`` (scipy.sparse.csgraph.
    maximum_bipartite_matching): Hopcroft-Karp on the host — augmenting
    paths are sequential pointer chases, the same host/device split as
    Tarjan/RCM (module docstring). ``perm_type='row'`` returns, per row,
    the matched column (``-1`` if unmatched); ``'column'`` the reverse.
    Entry *values* are ignored (explicit zeros are edges, as stored)."""
    if a.rank != 2:
        raise SpSparseError("maximum_bipartite_matching needs rank 2")
    if perm_type not in ("row", "column"):
        raise SpSparseError(f"perm_type must be 'row' or 'column', "
                            f"got {perm_type!r}")
    nr, nc = int(a.shape[0]), int(a.shape[1])
    live = np.asarray(a.valid_mask())
    r = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    c = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    ptr = np.searchsorted(r, np.arange(nr + 1))

    INF = np.iinfo(np.int64).max
    match_r = np.full(nr, -1, np.int64)        # row -> col
    match_c = np.full(nc, -1, np.int64)        # col -> row
    dist = np.empty(nr, np.int64)

    def bfs() -> bool:
        q = []
        for u in range(nr):
            if match_r[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        head = 0
        while head < len(q):
            u = q[head]
            head += 1
            for v in c[ptr[u]:ptr[u + 1]]:
                w = match_c[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(u: int) -> bool:
        for v in c[ptr[u]:ptr[u + 1]]:
            w = match_c[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                match_r[u] = v
                match_c[v] = u
                return True
        dist[u] = INF
        return False

    import sys as _sys
    old_limit = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old_limit, nr + nc + 100))
    try:
        while bfs():
            for u in range(nr):
                if match_r[u] == -1:
                    dfs(u)
    finally:
        _sys.setrecursionlimit(old_limit)
    return match_r if perm_type == "row" else match_c


def min_weight_full_bipartite_matching(a: SparseCOO, *,
                                       maximize: bool = False):
    """Minimum-weight full matching of the bipartite graph whose
    biadjacency matrix is ``a``
    (scipy.sparse.csgraph.min_weight_full_bipartite_matching).

    Only explicitly stored entries are admissible edges (stored zeros
    ARE zero-weight edges, scipy's sparse contract). Every vertex on
    the smaller side must be matched; raises :class:`SpSparseError`
    when no full matching exists (scipy raises ValueError).

    Hungarian algorithm with dual potentials, successive shortest
    augmenting paths over the sparse adjacency — sequential pointer
    chasing, so host tier (module docstring convention); O(R·C·rounds)
    worst case. Returns ``(row_ind, col_ind)`` sorted by row index.
    Parallel duplicate edges take the minimum weight (maximum under
    ``maximize``)."""
    if a.rank != 2:
        raise SpSparseError("min_weight_full_bipartite_matching needs "
                            "rank 2")
    nr, nc = int(a.shape[0]), int(a.shape[1])
    live = np.asarray(a.valid_mask())
    r = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    c = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    w = np.asarray(a.vals)[live].astype(np.float64)
    transposed = nr > nc
    if transposed:
        r, c, nr, nc = c, r, nc, nr
    if maximize:
        w = -w
    # columns shifted +1: column 0 is the virtual root of the
    # alternating tree (classic potentials formulation)
    order = np.lexsort((c, r))
    r, c, w = r[order], c[order] + 1, w[order]
    ptr = np.searchsorted(r, np.arange(nr + 1))
    if nr and (ptr[1:] == ptr[:-1]).any():
        raise SpSparseError("min_weight_full_bipartite_matching: a row "
                            "has no admissible edges — no full matching "
                            "exists")
    INF = np.inf
    u = np.zeros(nr + 1)              # row potentials (u[nr] = virtual)
    v = np.zeros(nc + 1)              # column potentials
    p = np.full(nc + 1, nr, np.int64)  # p[j] = row matched to column j
    way = np.zeros(nc + 1, np.int64)
    for i in range(nr):
        p[0] = i
        j0 = 0
        minv = np.full(nc + 1, INF)
        used = np.zeros(nc + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # relax only over the sparse adjacency of i0
            lo, hi = ptr[i0], ptr[i0 + 1]
            js, ws = c[lo:hi], w[lo:hi]
            cur = ws - u[i0] - v[js]
            upd = (~used[js]) & (cur < minv[js])
            minv[js] = np.where(upd, cur, minv[js])
            way[js[upd]] = j0
            minv_masked = np.where(used, INF, minv)
            j1 = int(np.argmin(minv_masked))
            delta = minv_masked[j1]
            if not np.isfinite(delta):
                raise SpSparseError(
                    "min_weight_full_bipartite_matching: no full "
                    "matching exists")
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == nr:
                break
        while j0:                      # augment along the stored path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.full(nr, -1, np.int64)
    for j in range(1, nc + 1):
        if p[j] != nr:
            col_of_row[p[j]] = j - 1
    row_ind = np.arange(nr, dtype=np.int64)
    col_ind = col_of_row
    if transposed:
        row_ind, col_ind = col_ind.copy(), row_ind
        srt = np.argsort(row_ind)
        row_ind, col_ind = row_ind[srt], col_ind[srt]
    return row_ind, col_ind


def structural_rank(a: SparseCOO) -> int:
    """Structural rank = maximum-bipartite-matching cardinality of the
    sparsity pattern (scipy.sparse.csgraph.structural_rank) — an upper
    bound on the numerical rank that depends only on structure."""
    m = maximum_bipartite_matching(a)
    return int((m >= 0).sum())


# ----------------------------------------------------------------------
# Maximum flow (host Dinic)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaximumFlowResult:
    """Result of :func:`maximum_flow` — scipy's shape: the flow value
    and the per-edge flow as a :class:`SparseCOO` over the *stored*
    edges (antisymmetric residual bookkeeping stays internal)."""

    flow_value: int
    flow: SparseCOO


def maximum_flow(a: SparseCOO, source: int, sink: int) -> MaximumFlowResult:
    """Maximum s-t flow with integer capacities
    (scipy.sparse.csgraph.maximum_flow), via Dinic's algorithm on the
    host — level-graph BFS + blocking-flow DFS are sequential pointer
    chases (host/device split, module docstring). Capacities must be
    non-negative integers (scipy's restriction); raises otherwise."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"maximum_flow needs a square rank-2 array, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    if not (0 <= source < n and 0 <= sink < n and source != sink):
        raise SpSparseError("maximum_flow: bad source/sink")
    live = np.asarray(a.valid_mask())
    t = np.asarray(a.indices[:, 0])[live].astype(np.int64)
    h = np.asarray(a.indices[:, 1])[live].astype(np.int64)
    w = np.asarray(a.vals)[live]
    if not np.all(w == np.round(w)) or np.any(w < 0):
        raise SpSparseError(
            "maximum_flow needs non-negative integer capacities "
            "(scipy parity)")
    cap0 = w.astype(np.int64)
    t0, h0 = t, h                       # stored edge list incl. self-loops
    keep = t != h
    t, h, cap0 = t[keep], h[keep], cap0[keep]
    m = len(t)
    # residual edge list: forward edges at 2i, reverse at 2i+1
    eh = np.empty(2 * m, np.int64)
    eh[0::2], eh[1::2] = h, t
    cap = np.zeros(2 * m, np.int64)
    cap[0::2] = cap0
    # CSR over residual edges by tail
    et = np.empty(2 * m, np.int64)
    et[0::2], et[1::2] = t, h
    order = np.argsort(et, kind="stable")
    ptr = np.searchsorted(et[order], np.arange(n + 1))
    adj = order  # adj[ptr[u]:ptr[u+1]] = residual edge ids out of u

    INF = np.iinfo(np.int64).max

    def bfs_levels_():
        level = np.full(n, -1, np.int64)
        level[source] = 0
        q = [source]
        head = 0
        while head < len(q):
            u = q[head]
            head += 1
            for eid in adj[ptr[u]:ptr[u + 1]]:
                v = eh[eid]
                if cap[eid] > 0 and level[v] == -1:
                    level[v] = level[u] + 1
                    q.append(v)
        return level if level[sink] != -1 else None

    total = 0
    while True:
        level = bfs_levels_()
        if level is None:
            break
        it = ptr[:-1].copy()      # per-node next-edge cursor

        # blocking flow via iterative DFS
        while True:
            # find one augmenting path
            path = []
            u = source
            while u != sink:
                advanced = False
                while it[u] < ptr[u + 1]:
                    eid = adj[it[u]]
                    v = eh[eid]
                    if cap[eid] > 0 and level[v] == level[u] + 1:
                        path.append(eid)
                        u = v
                        advanced = True
                        break
                    it[u] += 1
                if not advanced:
                    if not path:
                        u = None
                        break
                    # retreat: dead-end node; pop and advance parent
                    # cursor (eh[eid ^ 1] = the forward edge's tail)
                    level[u] = -1
                    eid = path.pop()
                    u = eh[eid ^ 1]
                    it[u] += 1
            if u is None:
                break
            aug = min(int(cap[e]) for e in path)
            for e in path:
                cap[e] -= aug
                cap[e ^ 1] += aug
            total += aug

    # per-stored-edge flow = reverse residual (what was pushed through).
    # Self-loops carry no s-t flow but ARE stored edges: re-insert them
    # with flow 0 so the output sparsity equals the input's stored edges
    # (filtering them from the residual network stays internal).
    flow_all = np.zeros(len(t0), np.int64)
    flow_all[keep] = cap[1::2]
    idx = np.stack([t0, h0], axis=1)
    flow = SparseCOO.from_arrays(idx, flow_all.astype(a.dtype),
                                 a.shape) if len(t0) else \
        SparseCOO.empty(a.shape, cap=1, dtype=a.dtype)
    return MaximumFlowResult(flow_value=int(total), flow=flow)


# ----------------------------------------------------------------------
# Laplacian
# ----------------------------------------------------------------------

def laplacian(a: SparseCOO, *, normed: bool = False,
              return_diag: bool = False):
    """Graph Laplacian of a symmetric adjacency matrix
    (scipy.sparse.csgraph.laplacian): ``L = D - A`` with
    ``D = diag(offdiag-row-sums)`` (the input diagonal is ignored, as in
    scipy). With ``normed=True``: ``L = I - D^-1/2 A D^-1/2`` with unit
    diagonal only at non-isolated nodes. Returns a consolidated
    row-major :class:`SparseCOO` (and the degree/sqrt-degree vector with
    ``return_diag``)."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"laplacian needs a square rank-2 array, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    off = coo_filter(a, lambda idx, _v: idx[:, 0] != idx[:, 1])
    lv = off.valid_mask()
    rid = jnp.where(lv, off.indices[:, 0], n)
    deg = jnp.zeros(n, off.dtype).at[rid].add(
        jnp.where(lv, off.vals, 0), mode="drop")
    if not normed:
        D = _dense_diag_coo(deg, a)
        L = coo_add(D, coo_scale(off, -1.0))
        return (L, deg) if return_diag else L
    s = jnp.sqrt(jnp.where(deg > 0, deg, 1)).astype(off.dtype)
    inv = jnp.where(deg > 0, 1 / s, 0)
    ri = jnp.where(lv, off.indices[:, 0], 0)
    ci = jnp.where(lv, off.indices[:, 1], 0)
    scaled = dataclasses.replace(off, vals=off.vals * inv[ri] * inv[ci])
    D = _dense_diag_coo((deg > 0).astype(off.dtype), a)
    L = coo_add(D, coo_scale(scaled, -1.0))
    return (L, s) if return_diag else L


def _dense_diag_coo(d: Array, like: SparseCOO) -> SparseCOO:
    """diag(d) as a SparseCOO with every diagonal slot present (static
    shape; zero diagonal entries are kept so jit tracing stays
    shape-stable — consolidate drops them downstream if asked)."""
    n = int(d.shape[0])
    r = jnp.arange(n, dtype=like.index_dtype)
    return SparseCOO(indices=jnp.stack([r, r], axis=1),
                     vals=d.astype(like.dtype),
                     nnz=jnp.asarray(n, jnp.int32),
                     shape=like.shape, sort_order=(0, 1))


# ----------------------------------------------------------------------
# Path utilities (scipy.sparse.csgraph._tools) + Yen's k-shortest paths
# ----------------------------------------------------------------------

def reconstruct_path(a: SparseCOO, predecessors, *,
                     directed: bool = True) -> SparseCOO:
    """The shortest-path tree encoded by one predecessor row as a sparse
    matrix (scipy.sparse.csgraph.reconstruct_path): entry ``(pred[v],
    v)`` carries the stored edge weight (min of the two orientations
    when ``directed=False``, scipy's convention)."""
    predecessors = np.asarray(predecessors)
    if predecessors.shape != (int(a.shape[0]),):
        raise SpSparseError(
            f"reconstruct_path: predecessors must be ({int(a.shape[0])},), "
            f"got {predecessors.shape}")
    return _tree_from_pred(a, predecessors, directed=directed)


def construct_dist_matrix(a: SparseCOO, predecessors, *,
                          directed: bool = True,
                          null_value: float = np.inf):
    """Distance matrix from a full ``(n, n)`` predecessor matrix
    (scipy.sparse.csgraph.construct_dist_matrix): walks each row's
    predecessor chains and sums the stored edge weights; unreachable
    entries get ``null_value``. Host-returning numpy ``(n, n)``."""
    n = int(a.shape[0])
    pred = np.asarray(predecessors)
    if pred.shape != (n, n):
        raise SpSparseError(f"construct_dist_matrix: predecessors must be "
                            f"({n}, {n}), got {pred.shape}")
    ptr, h, w = _host_adjacency(a, directed)

    def edge_w(p, v):
        lo, hi = ptr[p], ptr[p + 1]
        k = lo + np.searchsorted(h[lo:hi], v)
        best = np.inf
        while k < hi and h[k] == v:
            best = min(best, w[k])
            k += 1
        return best

    dist = np.full((n, n), np.inf)
    for i in range(n):
        dist[i, i] = 0.0
        # resolve chains iteratively: a node is ready once its
        # predecessor's distance is known
        state = np.zeros(n, np.int8)            # 0 unseen, 1 done
        state[i] = 1
        for j in range(n):
            chain = []
            v = j
            while state[v] == 0 and pred[i, v] != NEG_SENTINEL:
                chain.append(v)
                v = pred[i, v]
                if len(chain) > n:
                    # malformed predecessor matrix (cycle) — raise
                    # instead of walking forever
                    raise SpSparseError(
                        "construct_dist_matrix: cycle detected in "
                        f"predecessor matrix (source row {i})")
            if state[v] == 1:
                for u in reversed(chain):
                    dist[i, u] = dist[i, pred[i, u]] + edge_w(pred[i, u], u)
                    state[u] = 1
    dist[~np.isfinite(dist)] = null_value
    np.fill_diagonal(dist, 0.0)
    return dist


def _host_dijkstra_masked(ptr, h, w, n, source, sink, blocked_nodes,
                          blocked_edges, undirected):
    """Heap Dijkstra from ``source`` to ``sink`` over the host adjacency,
    skipping ``blocked_nodes`` (bool mask) and ``blocked_edges`` (set of
    (u, v) keys, canonicalized when undirected). Returns (cost, path) or
    (inf, None). Host tier — the sequential spur searches of Yen's
    algorithm (scipy _shortest_path.pyx yen) don't vectorize."""
    import heapq
    dist = np.full(n, np.inf)
    prev = np.full(n, NEG_SENTINEL, np.int64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        if v == sink:
            break
        for k in range(ptr[v], ptr[v + 1]):
            u = int(h[k])
            if blocked_nodes[u]:
                continue
            key = (min(v, u), max(v, u)) if undirected else (v, int(u))
            if key in blocked_edges:
                continue
            nd = d + w[k]
            if nd < dist[u]:
                dist[u] = nd
                prev[u] = v
                heapq.heappush(heap, (nd, u))
    if not np.isfinite(dist[sink]):
        return np.inf, None
    path = [sink]
    while path[-1] != source:
        path.append(int(prev[path[-1]]))
    return float(dist[sink]), path[::-1]


def yen(a: SparseCOO, source: int, sink: int, K: int, *,
        directed: bool = True, unweighted: bool = False,
        return_predecessors: bool = False):
    """Yen's K loopless shortest paths
    (scipy.sparse.csgraph.yen): returns the (at most K) smallest
    simple-path costs sorted ascending, and optionally a ``(k, n)``
    predecessor matrix, one row per path. Host tier: the spur-node
    searches are inherently sequential (same split as
    :func:`maximum_flow`'s Dinic)."""
    n = int(a.shape[0])
    source, sink = int(source), int(sink)
    ptr, h, w = _host_adjacency(a, directed)
    if unweighted:
        w = np.ones_like(w)
    undirected = not directed
    no_nodes = np.zeros(n, bool)

    c0, p0 = _host_dijkstra_masked(ptr, h, w, n, source, sink,
                                   no_nodes, frozenset(), undirected)
    if p0 is None:
        found: list = []
    else:
        found = [(c0, p0)]
    candidates: list = []
    seen = {tuple(p0)} if p0 is not None else set()

    while found and len(found) < K:
        _, prev_path = found[-1]
        for i in range(len(prev_path) - 1):
            spur = prev_path[i]
            root = prev_path[:i + 1]
            root_cost = 0.0
            for u, v in zip(root, root[1:]):
                lo, hi = ptr[u], ptr[u + 1]
                k = lo + np.searchsorted(h[lo:hi], v)
                best = np.inf
                while k < hi and h[k] == v:
                    best = min(best, w[k]); k += 1
                root_cost += best
            blocked_edges = set()
            for c, p in found + [c for c in candidates]:
                if len(p) > i and p[:i + 1] == root:
                    u, v = p[i], p[i + 1]
                    blocked_edges.add(
                        (min(u, v), max(u, v)) if undirected else (u, v))
            blocked_nodes = no_nodes.copy()
            blocked_nodes[root[:-1]] = True
            sc, sp = _host_dijkstra_masked(ptr, h, w, n, spur, sink,
                                           blocked_nodes,
                                           frozenset(blocked_edges),
                                           undirected)
            if sp is not None:
                cand = root[:-1] + sp
                t = tuple(cand)
                if t not in seen:
                    seen.add(t)
                    candidates.append((root_cost + sc, cand))
        if not candidates:
            break
        candidates.sort(key=lambda cp: cp[0])
        found.append(candidates.pop(0))

    dists = np.array([c for c, _ in found])
    if not return_predecessors:
        return dists
    preds = np.full((len(found), n), NEG_SENTINEL, np.int32)
    for r, (_, p) in enumerate(found):
        for u, v in zip(p, p[1:]):
            preds[r, v] = u
    return dists, preds


# ----------------------------------------------------------------------
# Graph <-> dense/masked conversions (scipy.sparse.csgraph._tools)
# ----------------------------------------------------------------------

def csgraph_from_dense(dense, *, null_value: float = 0.0) -> SparseCOO:
    """Dense adjacency -> :class:`SparseCOO` graph
    (scipy.sparse.csgraph.csgraph_from_dense): entries equal to
    ``null_value``, ``inf`` or ``nan`` are non-edges; everything else —
    including explicit zeros when ``null_value != 0`` — is a stored
    edge (this module's stored-zeros-are-edges convention)."""
    dense = np.asarray(dense, np.float64)
    if dense.ndim != 2:
        raise SpSparseError(f"csgraph_from_dense needs a 2-D array, "
                            f"got {dense.shape}")
    if np.isnan(null_value):
        edge = ~np.isnan(dense)
    else:
        edge = dense != null_value
    edge &= np.isfinite(dense)
    r, c = np.nonzero(edge)
    idx = np.stack([r, c], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(idx, dense[r, c], dense.shape)


def csgraph_to_dense(a: SparseCOO, *, null_value: float = 0.0):
    """Graph -> dense adjacency with ``null_value`` at non-edges
    (scipy.sparse.csgraph.csgraph_to_dense): stored entries keep their
    value (explicit zeros stay ``0``, distinct from ``null_value``).
    Host-returning numpy array."""
    live = np.asarray(a.valid_mask())
    r = np.asarray(a.indices[:, 0])[live]
    c = np.asarray(a.indices[:, 1])[live]
    v = np.asarray(a.vals)[live]
    out = np.full(tuple(int(s) for s in a.shape), float(null_value))
    # scipy keeps the minimum on duplicate entries
    order = np.lexsort((-v, c, r))
    out[r[order], c[order]] = v[order]
    return out


def csgraph_from_masked(masked) -> SparseCOO:
    """Masked-array adjacency -> graph
    (scipy.sparse.csgraph.csgraph_from_masked): masked entries are
    non-edges, every unmasked entry (incl. zeros) is stored."""
    masked = np.ma.asarray(masked)
    edge = ~np.ma.getmaskarray(masked)
    r, c = np.nonzero(edge)
    idx = np.stack([r, c], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(idx, np.asarray(masked.data,
                                                 np.float64)[r, c],
                                 masked.shape)


def csgraph_to_masked(a: SparseCOO):
    """Graph -> masked-array adjacency (non-edges masked)
    (scipy.sparse.csgraph.csgraph_to_masked)."""
    dense = csgraph_to_dense(a, null_value=np.inf)
    return np.ma.masked_invalid(dense)
