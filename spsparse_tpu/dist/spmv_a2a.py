"""Sparsity-aware distributed SpMV: all_to_all exchange of the column
FOOTPRINT of x.

The ring pipeline rotates EVERY x block past every device — per-device
comm ``(P-1) * rows_local`` values, which collapses weak scaling for
scattered matrices (model: 0.36 at P=8, 0.04 at P=64 for the config-2
workload). But a device only ever reads the x values at its local
block's actual column set. That set is STATIC (the sparsity pattern),
so the exchange can be planned host-side:

* prepare: for each (owner q, requester p) pair, the sorted unique local
  x indices ``F[p,q]`` that p's entries need from q's block; entry
  columns are remapped to footprint-relative positions
  ``q * fp_cap + rank``.
* runtime: each owner gathers its x values for all requesters (one
  ``take``), ONE ``all_to_all`` moves the footprint slabs, and the local
  SpMV gathers from the received concatenated footprint. Per-device
  comm = the device's total column footprint — independent of P for
  footprint-bounded operators, ``min(nnz_local, ncols)`` in the
  uniform-random worst case (still ~(P-1)x less than the ring at large
  P).

The same pattern as :func:`~spsparse_tpu.dist.spgemm_a2a.dist_spgemm_a2a`'s
request/reply exchange, specialized to the static-pattern SpMV case where
requests need no runtime round trip. The reference has no distributed
counterpart (SURVEY §2 explicit statement); this is a north-star
capability. Scaling model: :func:`~spsparse_tpu.dist.model.
a2a_weak_scaling_efficiency` (meets >=80% when the footprint is bounded;
the uniform-scatter worst case honestly cannot — see the model docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import SpSparseError
from ..core.joinfill import row_ids_from_row_ptr
from ..core.structure import SparseCSR, to_csr

__all__ = ["RowPartitionedFootprint", "partition_footprint",
           "dist_spmv_a2a", "dist_spmm_a2a"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowPartitionedFootprint:
    """Row-partitioned CSR with footprint-remapped columns + the static
    exchange table.

    ``cols_fp (P, cap_local)``: entry columns as ``q * fp_cap + rank``
    where ``rank`` indexes the sorted unique footprint ``F[p,q]``;
    ``req (P_owner, P_requester, fp_cap)``: local x indices each owner
    sends each requester (0-padded; ``req_n`` live counts). Sharding the
    leading axis puts on device q exactly the rows it must serve."""

    row_ptr: Array = dataclasses.field(metadata=dict(static=False))
    cols_fp: Array = dataclasses.field(metadata=dict(static=False))
    vals: Array = dataclasses.field(metadata=dict(static=False))
    nnz: Array = dataclasses.field(metadata=dict(static=False))
    req: Array = dataclasses.field(metadata=dict(static=False))
    req_n: Array = dataclasses.field(metadata=dict(static=False))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    blk_len: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_parts(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def rows_local(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def fp_cap(self) -> int:
        return self.req.shape[2]

    @property
    def footprint_per_device(self) -> np.ndarray:
        """Total live footprint values each REQUESTER receives (host)."""
        return np.asarray(self.req_n).sum(axis=0)


def partition_footprint(a: SparseCOO | SparseCSR, n_parts: int, *,
                        cap_local: int | None = None,
                        fp_cap: int | None = None) -> RowPartitionedFootprint:
    """Host-side build of the footprint-exchange row partition."""
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    nrows, ncols = csr.shape
    rows_local = -(-nrows // n_parts)
    blk_len = -(-ncols // n_parts)

    row_ptr = np.asarray(csr.row_ptr)
    cols = np.asarray(csr.cols)
    vals = np.asarray(csr.vals)
    nnz_total = int(csr.nnz)

    # per-partition entry ranges (rows are contiguous in CSR order)
    bounds = []
    for p in range(n_parts):
        r0 = min(p * rows_local, nrows)
        r1 = min((p + 1) * rows_local, nrows)
        s0 = min(int(row_ptr[r0]), nnz_total)
        s1 = min(int(row_ptr[r1]), nnz_total)
        bounds.append((r0, r1, s0, s1))
    counts = [s1 - s0 for _, _, s0, s1 in bounds]
    if cap_local is None:
        cap_local = round_up_pow2(max(max(counts), 1))
    elif max(counts) > cap_local:
        raise SpSparseError(
            f"cap_local={cap_local} < max block nnz {max(counts)}")

    # footprints F[p][q] + remapped columns
    foots: list[list[np.ndarray]] = []
    remapped: list[np.ndarray] = []
    max_fp = 1
    for p, (r0, r1, s0, s1) in enumerate(bounds):
        c = cols[s0:s1]
        q = np.minimum(c // blk_len, n_parts - 1)
        loc = c - q * blk_len
        row_f = []
        rank = np.zeros(c.shape[0], np.int64)
        for qq in range(n_parts):
            m = q == qq
            uniq, inv = (np.unique(loc[m], return_inverse=True)
                         if m.any() else (np.zeros(0, np.int64),
                                          np.zeros(0, np.int64)))
            row_f.append(uniq)
            rank[m] = inv
            max_fp = max(max_fp, uniq.size)
        foots.append(row_f)
        remapped.append((q, rank))
    if fp_cap is None:
        fp_cap = round_up_pow2(max_fp)
    elif max_fp > fp_cap:
        raise SpSparseError(f"fp_cap={fp_cap} < max footprint {max_fp}")

    Pn = n_parts
    out_ptr = np.zeros((Pn, rows_local + 1), np.int32)
    out_cols = np.full((Pn, cap_local), Pn * fp_cap, np.int32)
    out_vals = np.zeros((Pn, cap_local), vals.dtype)
    out_nnz = np.zeros((Pn,), np.int32)
    req = np.zeros((Pn, Pn, fp_cap), np.int32)       # [owner, requester]
    req_n = np.zeros((Pn, Pn), np.int32)
    for p, (r0, r1, s0, s1) in enumerate(bounds):
        n = s1 - s0
        local_ptr = row_ptr[r0:r1 + 1] - row_ptr[r0]
        out_ptr[p, : r1 - r0 + 1] = local_ptr
        out_ptr[p, r1 - r0 + 1:] = local_ptr[-1]
        q, rank = remapped[p]
        out_cols[p, :n] = (q * fp_cap + rank).astype(np.int32)
        out_vals[p, :n] = vals[s0:s1]
        out_nnz[p] = n
        for qq in range(Pn):
            f = foots[p][qq]
            req[qq, p, : f.size] = f
            req_n[qq, p] = f.size
    return RowPartitionedFootprint(
        row_ptr=jnp.asarray(out_ptr), cols_fp=jnp.asarray(out_cols),
        vals=jnp.asarray(out_vals), nnz=jnp.asarray(out_nnz),
        req=jnp.asarray(req), req_n=jnp.asarray(req_n),
        shape=(nrows, ncols), blk_len=blk_len)


def _exchange(req, xl, axis):
    """Owner-side gather + one all_to_all. ``req (P, fp_cap)`` local
    indices per requester; returns ``(P, fp_cap)`` received footprint
    slabs (row q = values from owner q)."""
    send = jnp.take(xl, req, axis=0)        # (P, fp_cap[, N])
    return jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                              tiled=False)


def dist_spmv_a2a(part: RowPartitionedFootprint, x_parts, mesh: Mesh,
                  axis: str = "x"):
    """Row-partitioned SpMV with footprint-only x exchange. ``x_parts``
    is ``(P, blk_len)`` sharded like :func:`..partition.partition_vector`.
    Returns ``(P, rows_local)`` sharded y."""
    nparts = mesh.shape[axis]
    if part.n_parts != nparts:
        raise SpSparseError(
            f"layout built for P={part.n_parts}, mesh has {nparts}")
    if x_parts.shape[1] != part.blk_len:
        raise SpSparseError(
            f"x block length {x_parts.shape[1]} != layout blk_len "
            f"{part.blk_len}")
    rows_local = part.rows_local
    fp_cap = part.fp_cap

    def local_fn(rp, cols_fp, vals, nnz, req, xl):
        rp, cols_fp, vals, nnz, req, xl = (rp[0], cols_fp[0], vals[0],
                                           nnz[0], req[0], xl[0])
        recv = _exchange(req, xl, axis)             # (P, fp_cap)
        xg = recv.reshape(nparts * fp_cap)
        cap = cols_fp.shape[0]
        live = jnp.arange(cap, dtype=jnp.int32) < nnz
        prod = jnp.where(live, vals * jnp.take(xg, cols_fp, mode="fill",
                                               fill_value=0), 0)
        rows = row_ids_from_row_ptr(rp, cap)
        rows = jnp.where(live, rows, rows_local)
        y = jnp.zeros((rows_local,), prod.dtype).at[rows].add(
            prod, mode="drop")
        return y[None]

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=P(axis))
    return fn(part.row_ptr, part.cols_fp, part.vals, part.nnz, part.req,
              x_parts)


def dist_spmm_a2a(part: RowPartitionedFootprint, x_parts, mesh: Mesh,
                  axis: str = "x"):
    """SpMM variant: ``x_parts (P, blk_len, N)``; the exchanged slabs are
    ``fp_cap x N`` blocks (the footprint saving scales with N — dense
    RHS makes the ring's O(P * blk * N) comm even more expensive)."""
    nparts = mesh.shape[axis]
    if part.n_parts != nparts:
        raise SpSparseError(
            f"layout built for P={part.n_parts}, mesh has {nparts}")
    rows_local = part.rows_local
    fp_cap = part.fp_cap

    def local_fn(rp, cols_fp, vals, nnz, req, xl):
        rp, cols_fp, vals, nnz, req, xl = (rp[0], cols_fp[0], vals[0],
                                           nnz[0], req[0], xl[0])
        recv = _exchange(req, xl, axis)             # (P, fp_cap, N)
        xg = recv.reshape(nparts * fp_cap, xl.shape[1])
        cap = cols_fp.shape[0]
        live = jnp.arange(cap, dtype=jnp.int32) < nnz
        g = jnp.take(xg, cols_fp, axis=0, mode="fill", fill_value=0)
        prod = jnp.where(live[:, None], vals[:, None] * g, 0)
        rows = row_ids_from_row_ptr(rp, cap)
        rows = jnp.where(live, rows, rows_local)
        y = jnp.zeros((rows_local, xl.shape[1]), prod.dtype).at[rows].add(
            prod, mode="drop")
        return y[None]

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=P(axis))
    return fn(part.row_ptr, part.cols_fp, part.vals, part.nnz, part.req,
              x_parts)
