"""Analytical performance model for the distributed ops (weak scaling).

Virtual-device meshes cannot measure real comm/compute overlap, so the
scaling figures reported by ``bench.py --all`` (config 5) and asserted by
``__graft_entry__.dryrun_multichip`` come from a roofline-style model. The
model is deliberately simple and stated in full here so it can be
audited:

* ring SpMV/SpMM (``dist_spmv_bucketed`` / ``dist_spmm_bucketed``): P ring
  steps; step ``s`` overlaps the compute on bucket ``s`` (streaming the
  local entries once per full rotation) with the ``ppermute`` of one x/X
  block over the card-to-card link. Per-device step time = max(compute_step, comm_step);
  single-device time = the same total compute with no comm.
* weak scaling: per-device work (nnz_local, rows_local) held constant as P
  grows, so efficiency = t(1 device) / t(P devices per-device time).

Default bandwidths are the H200's published peaks from
:data:`spsparse_tpu.utils.roofline.PEAKS` (HBM 4.8 TB/s; NVLink 450 GB/s
each way); override with measured numbers where available.
"""

from __future__ import annotations

import dataclasses

from ..utils.roofline import PEAKS

_H200 = PEAKS["NVIDIA H200"]
HBM_GBS = _H200.hbm_bytes_s / 1e9
LINK_GBS = _H200.link_bytes_s / 1e9

__all__ = ["RingModel", "ring_weak_scaling_efficiency",
           "halo_weak_scaling_efficiency", "a2a_weak_scaling_efficiency",
           "a2a_footprint_for_target", "uniform_footprint"]


@dataclasses.dataclass(frozen=True)
class RingModel:
    """Inputs: per-device workload + hardware bandwidths (GB/s)."""

    nnz_local: int            # entries per device
    rows_local: int           # rows per device (= x block length)
    n_rhs: int = 1            # dense RHS columns (1 = SpMV)
    bytes_per_entry: float = 8.0   # cols + vals streamed per entry
    dtype_bytes: float = 4.0
    hbm_gbs: float = HBM_GBS
    link_gbs: float = LINK_GBS

    def compute_time(self) -> float:
        """One full pass over the local entries + x/y traffic (seconds)."""
        bytes_local = (self.nnz_local * self.bytes_per_entry
                       + 2 * self.rows_local * self.n_rhs * self.dtype_bytes)
        return bytes_local / (self.hbm_gbs * 1e9)

    def step_comm_time(self) -> float:
        """One ppermute of an x/X block to the ring neighbour."""
        blk_bytes = self.rows_local * self.n_rhs * self.dtype_bytes
        return blk_bytes / (self.link_gbs * 1e9)

    def time(self, n_devices: int) -> float:
        """Per-device wall time for the P-step overlapped ring."""
        if n_devices <= 1:
            return self.compute_time()
        step_compute = self.compute_time() / n_devices
        step = max(step_compute, self.step_comm_time())
        # P-1 overlapped steps + the final compute-only step.
        return (n_devices - 1) * step + step_compute


def ring_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                 n_devices: int, *, n_rhs: int = 1,
                                 **kw) -> float:
    """Weak-scaling efficiency of the overlapped ring at P devices:
    ``t(1) / t(P)`` with per-device workload held constant. 1.0 = perfect;
    degrades only when a block's link transfer outruns one step's
    compute."""
    m = RingModel(nnz_local=nnz_local, rows_local=rows_local, n_rhs=n_rhs,
                  **kw)
    return m.time(1) / m.time(n_devices)


def halo_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                 halo: int, n_devices: int, *,
                                 n_rhs: int = 1, bytes_per_entry: float = 8.0,
                                 dtype_bytes: float = 4.0,
                                 hbm_gbs: float = HBM_GBS,
                                 link_gbs: float = LINK_GBS) -> float:
    """Weak-scaling efficiency of :func:`~spsparse_tpu.dist.dist_spmv_halo`.

    Comm is two ``halo``-element neighbour transfers regardless of P, so
    banded matrices stay compute-bound at any device count — this is the
    model that meets the BASELINE >=80% target for the config-2 family
    (the all-pairs ring provably cannot: its per-device comm grows as
    ``(P-1) * rows_local``). Conservatively treats halo comm as serial
    (not overlapped) with compute.
    """
    if n_devices <= 1:
        return 1.0
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    t_halo = 2 * halo * n_rhs * dtype_bytes / (link_gbs * 1e9)
    return t_compute / (t_compute + t_halo)


def a2a_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                footprint_local: int, n_devices: int, *,
                                n_rhs: int = 1,
                                bytes_per_entry: float = 8.0,
                                dtype_bytes: float = 4.0,
                                hbm_gbs: float = HBM_GBS,
                                link_gbs: float = LINK_GBS) -> float:
    """Weak-scaling efficiency of
    :func:`~spsparse_tpu.dist.spmv_a2a.dist_spmv_a2a`.

    Per-device comm is the device's column FOOTPRINT (the x values its
    entries actually read) — independent of P once the footprint is, vs
    the ring's ``(P-1) * rows_local``. Owner-side gather traffic
    (``footprint * (4 + dtype)`` through HBM, symmetric send≈receive) is
    charged to compute; the all_to_all itself is conservatively serial
    with compute. :func:`a2a_footprint_for_target` gives the largest
    footprint that still meets a target. Footprint-bounded operators
    (regridding: footprint ~ local coupling width) qualify at any P; a
    UNIFORM-random matrix's footprint is ``~min(nnz_local, ncols)``
    (:func:`uniform_footprint`), which cannot meet an 80% target, though
    it still beats the ring several-fold at large P."""
    if n_devices <= 1:
        return 1.0
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    # owner-side gather of the outgoing footprint (index + value reads)
    t_gather = footprint_local * (4.0 + dtype_bytes) * n_rhs / (hbm_gbs * 1e9)
    t_comm = footprint_local * n_rhs * dtype_bytes / (link_gbs * 1e9)
    return t_compute / (t_compute + t_gather + t_comm)


def a2a_footprint_for_target(nnz_local: int, rows_local: int, *,
                             target: float = 0.8, n_rhs: int = 1,
                             bytes_per_entry: float = 8.0,
                             dtype_bytes: float = 4.0,
                             hbm_gbs: float = HBM_GBS,
                             link_gbs: float = LINK_GBS) -> int:
    """Largest per-device footprint that still meets ``target`` weak
    scaling under :func:`a2a_weak_scaling_efficiency` (binary search on
    the closed-form denominator)."""
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    slack = t_compute * (1.0 / target - 1.0)
    per_val = (n_rhs * ((4.0 + dtype_bytes) / (hbm_gbs * 1e9)
                        + dtype_bytes / (link_gbs * 1e9)))
    return int(slack / per_val)


def uniform_footprint(nnz_local: int, ncols_global: int) -> int:
    """Expected distinct columns touched by ``nnz_local`` uniform-random
    draws over ``ncols_global`` columns (the a2a worst case)."""
    import math
    lam = nnz_local / max(ncols_global, 1)
    return int(ncols_global * (1.0 - math.exp(-lam)))
