"""Roofline accounting: bytes/FLOP models per op + the device peak table.

This module centralizes the per-op traffic models and the per-device peak
table (:data:`PEAKS`, keyed by ``device_kind``) used by ``bench.py``,
:mod:`spsparse_tpu.dist.model` and the tests. A device missing from the
table is an error, never a default.

Model conventions (all sizes in bytes):

* SpMV-DIA: diagonal data streamed once; x read once per diagonal window
  but served from cache for moderate n → counted once; y written.
* SpMV-ELL: cols+vals streamed once; x counted once; y once.
* SpMV-CSR: cols+vals+rowptr streamed; x gathered (counted once per nnz in
  the pessimistic model — CSR gathers are irregular); y once.
* SpMM-ELL: cols+vals once; each nnz gathers one N-wide X row (the dominant
  term); Y written once.
* SpGEMM-ESC: expansion read+write (sort is multi-pass: ~log passes over
  the expansion buffer — we charge ``sort_passes`` passes).
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["DevicePeaks", "PEAKS", "device_peaks", "device_hbm_bandwidth",
           "OpStats", "roofline", "spmv_dia_stats", "spmv_ell_stats",
           "spmv_csr_stats", "spmm_ell_stats", "spgemm_esc_stats"]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, no sparsity)."""

    hbm_bytes_s: float        # device memory bandwidth
    bf16_flops: float         # tensor cores, bf16 in / f32 accumulate
    tf32_flops: float         # tensor cores, TF32
    f32_flops: float          # float32 outside the tensor cores
    link_bytes_s: float       # NVLink to another card, each way
    source: str


_HOPPER = "NVIDIA data sheet and Hopper white paper, SXM part, 700 W"

PEAKS = {
    "NVIDIA H200": DevicePeaks(
        hbm_bytes_s=4.8e12, bf16_flops=989e12, tf32_flops=495e12,
        f32_flops=67e12, link_bytes_s=450e9, source=_HOPPER),
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_bytes_s=3.35e12, bf16_flops=989e12, tf32_flops=495e12,
        f32_flops=67e12, link_bytes_s=450e9, source=_HOPPER),
}


def device_peaks(device_kind: str | None = None) -> DevicePeaks:
    """Peaks of ``device_kind`` (default: the default device's). Raises
    ``KeyError`` for a device that is not in :data:`PEAKS`."""
    kind = device_kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def device_hbm_bandwidth(device_kind: str | None = None) -> tuple[str, float]:
    """``(device_kind, peak device-memory bytes/s)``; raises for an
    unknown device."""
    kind = device_kind or jax.devices()[0].device_kind
    return kind, device_peaks(kind).hbm_bytes_s


@dataclasses.dataclass(frozen=True)
class OpStats:
    """Static traffic/FLOP model of one op invocation."""

    name: str
    nnz: int
    bytes_moved: int
    flops: int

    def sol_time(self, bw: float) -> float:
        return self.bytes_moved / bw

    def sol_nnz_per_s(self, bw: float) -> float:
        return self.nnz / self.sol_time(bw)


def roofline(stats: OpStats, time_s: float,
             device_kind: str | None = None) -> dict:
    """Measured time → achieved vs speed-of-light summary dict (memory
    bound: bytes over the device's peak bandwidth)."""
    kind, bw = device_hbm_bandwidth(device_kind)
    achieved = stats.nnz / time_s
    sol = stats.sol_nnz_per_s(bw)
    return {
        "op": stats.name,
        "device": kind,
        "nnz": stats.nnz,
        "time_s": time_s,
        "nnz_per_s": achieved,
        "bytes_moved": stats.bytes_moved,
        "gbytes_per_s": stats.bytes_moved / time_s / 1e9,
        "sol_nnz_per_s": sol,
        "pct_of_roofline": 100.0 * achieved / sol,
    }


def _isize(dtype) -> int:
    import numpy as np
    return np.dtype(dtype).itemsize


def spmv_dia_stats(ndiag: int, nrows: int, dtype="float32") -> OpStats:
    s = _isize(dtype)
    nnz = ndiag * nrows
    return OpStats("spmv_dia", nnz,
                   nnz * s + nrows * 2 * s, 2 * nnz)


def spmv_ell_stats(nrows: int, k: int, dtype="float32",
                   index_size: int = 4) -> OpStats:
    nnz = nrows * k
    s = _isize(dtype)
    return OpStats("spmv_ell", nnz,
                   nnz * (index_size + s) + nrows * 2 * s, 2 * nnz)


def spmv_csr_stats(nnz: int, nrows: int, dtype="float32",
                   index_size: int = 4) -> OpStats:
    s = _isize(dtype)
    return OpStats("spmv_csr", nnz,
                   nnz * (index_size + 2 * s) + nrows * (4 + s), 2 * nnz)


def spmm_ell_stats(nrows: int, k: int, n_block: int, dtype="float32",
                   index_size: int = 4, x_dtype=None) -> OpStats:
    nnz = nrows * k
    s = _isize(dtype)
    xs = _isize(x_dtype or dtype)
    bytes_moved = (nnz * (index_size + s)        # cols + vals
                   + nnz * n_block * xs          # gathered X rows
                   + nrows * n_block * s)        # Y
    return OpStats("spmm_ell", nnz, bytes_moved, 2 * nnz * n_block)


def spgemm_esc_stats(nnz_a: int, nnz_b: int, expansion: int, nnz_out: int,
                     dtype="float32", index_size: int = 4,
                     sort_passes: int = 4) -> OpStats:
    s = _isize(dtype)
    entry = 2 * index_size + s
    bytes_moved = ((nnz_a + nnz_b) * (2 * index_size + s)  # operand reads
                   + expansion * entry * (1 + 2 * sort_passes)  # build+sort
                   + nnz_out * entry)                      # output
    return OpStats("spgemm_esc", expansion, bytes_moved, 2 * expansion)
