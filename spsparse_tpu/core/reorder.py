"""Bandwidth-reducing reorderings — the bridge from *scattered* sparse
matrices to the framework's fastest kernels.

The fused DIA path (:func:`spsparse_tpu.ops.spmv_dia`) streams the
matrix with no gathers but needs a *banded* matrix; general scattered
matrices fall back to gather layouts. Many matrices in the reference's domain
(regridding meshes, finite-element/volume couplings) are banded *up to a
relabeling of the unknowns* — reverse Cuthill-McKee recovers that
labeling from the sparsity pattern alone. ``rcm_permutation`` +
:func:`coo_permute` + ``to_dia`` is therefore a performance path, not
just a convenience (the scipy counterpart is
``scipy.sparse.csgraph.reverse_cuthill_mckee``; no reference counterpart
— citibeth/spsparse has no reordering machinery).

Design split, per the framework's host/device convention: the BFS
ordering is inherently sequential pointer-chasing, so it runs on the
HOST (numpy, O(nnz + n log n), a one-time planning cost like
``to_dia``/``plan_tiled_spgemm``); applying a permutation is pure
device-side index relabeling (two gathers), jit-compatible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

from .coo import SparseCOO
from .errors import SpSparseError

__all__ = ["rcm_permutation", "coo_permute", "bandwidth"]


def rcm_permutation(a: SparseCOO) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square rank-2 array's
    symmetrized sparsity pattern.

    Returns ``perm (n,) int64`` such that ``A[perm][:, perm]`` (i.e.
    ``coo_permute(a, perm)``) has small bandwidth — scipy's
    ``reverse_cuthill_mckee`` convention. Host-side (reads the indices
    once); each connected component is started from a minimum-degree
    node and BFS-visited with neighbors in increasing-degree order, then
    the whole order is reversed."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"rcm_permutation requires a square rank-2 array, "
            f"got shape {a.shape}")
    n = int(a.shape[0])
    idx = np.asarray(a.indices)
    live = np.asarray(a.valid_mask())
    r, c = idx[live, 0].astype(np.int64), idx[live, 1].astype(np.int64)
    # Symmetrize the pattern; drop self-loops (they don't affect BFS).
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    keep = rr != cc
    rr, cc = rr[keep], cc[keep]
    # CSR-style adjacency (duplicates are harmless for BFS).
    order = np.lexsort((cc, rr))
    rr, cc = rr[order], cc[order]
    ptr = np.searchsorted(rr, np.arange(n + 1))
    deg = ptr[1:] - ptr[:-1]

    perm = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    pos = 0
    # Component seeds in min-degree order (classic RCM heuristic).
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        perm[pos] = s
        head, pos = pos, pos + 1
        while head < pos:                      # BFS over this component
            u = perm[head]
            head += 1
            nbr = cc[ptr[u]:ptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                nbr = np.unique(nbr)           # dedup parallel edges
                nbr = nbr[np.argsort(deg[nbr], kind="stable")]
                visited[nbr] = True
                perm[pos:pos + nbr.size] = nbr
                pos += nbr.size
    return perm[::-1].copy()                   # the "reverse" in RCM


def coo_permute(a: SparseCOO, perm, col_perm=None) -> SparseCOO:
    """Symmetrically (or two-sidedly) permute a rank-2 array:
    ``B = A[perm][:, col_perm]`` with ``col_perm`` defaulting to
    ``perm`` — so ``B[i, j] = A[perm[i], col_perm[j]]`` (scipy slicing
    convention, matching :func:`rcm_permutation`'s output).

    Device-side index relabeling: two gathers through the *inverse*
    permutations; structure, duplicates and values are untouched.
    Sortedness metadata is dropped (a permutation destroys it).
    jit-compatible (perm may be a traced array of static shape)."""
    if a.rank != 2:
        raise SpSparseError("coo_permute requires a rank-2 array")
    perm = jnp.asarray(perm)
    cperm = perm if col_perm is None else jnp.asarray(col_perm)
    nr, nc = int(a.shape[0]), int(a.shape[1])
    if perm.shape != (nr,) or cperm.shape != (nc,):
        raise SpSparseError(
            f"permutation shapes {perm.shape}/{cperm.shape} do not match "
            f"array shape {a.shape}")
    dt = a.index_dtype
    inv_r = jnp.zeros(nr, dt).at[perm].set(jnp.arange(nr, dtype=dt))
    inv_c = jnp.zeros(nc, dt).at[cperm].set(jnp.arange(nc, dtype=dt))
    live = a.valid_mask()
    new_r = jnp.where(live, jnp.take(inv_r, a.indices[:, 0], mode="clip"),
                      a.indices[:, 0])        # padding keeps its sentinel
    new_c = jnp.where(live, jnp.take(inv_c, a.indices[:, 1], mode="clip"),
                      a.indices[:, 1])
    return dataclasses.replace(
        a, indices=jnp.stack([new_r, new_c], axis=1), sort_order=None)


def bandwidth(a: SparseCOO) -> int:
    """Maximum ``|row - col|`` over live entries of a rank-2 array (0 for
    empty arrays) — the quantity RCM minimizes; a banded matrix with this
    bandwidth ``b`` converts to DIA with at most ``2b + 1`` diagonals.
    Host-side (concrete result)."""
    if a.rank != 2:
        raise SpSparseError("bandwidth requires a rank-2 array")
    idx = np.asarray(a.indices)
    live = np.asarray(a.valid_mask())
    if not live.any():
        return 0
    d = idx[live, 0].astype(np.int64) - idx[live, 1].astype(np.int64)
    return int(np.abs(d).max())
