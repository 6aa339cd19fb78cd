"""SpGEMM conveniences: plain products, Gram products, capacity planning.

The full-generality engine is :func:`spsparse_tpu.ops.multiply.multiply`
(the diag-scaled chain); this module adds the common entry points and the
*capacity planning* helpers that make the ESC pipeline usable under ``jit``
(where the expansion/output sizes must be static).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import DuplicatePolicy
from ..core.structure import to_csr
from .multiply import multiply

__all__ = ["spgemm", "spgemm_aat", "plan_spgemm_caps", "best_spgemm",
           "coo_matrix_power", "TILED_FILL_THRESHOLD"]

Array = Any

# Average entries per occupied 128x128 tile (both operands) at or above
# which best_spgemm takes the tiled path instead of ESC. Carried over from
# the first accelerator; not yet re-measured on a GPU (ROADMAP.md).
TILED_FILL_THRESHOLD = 64


def spgemm(A: SparseCOO, B: SparseCOO, *, transpose_a: bool = False,
           transpose_b: bool = False, cap: int | None = None,
           expand_cap: int | None = None,
           duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
           zero_nan: bool = False) -> SparseCOO:
    """``C = A^(T?) @ B^(T?)`` — the chain multiply without scales.

    This is the fully general (sort-based ESC) path. For operands whose
    nonzeros cluster into dense-ish 128x128 tiles (regridding operators,
    banded products), :func:`spsparse_tpu.ops.spgemm_tiled.spgemm_tiled`
    computes the same product as dense tile products with no per-product
    sort.
    """
    return multiply(1.0, A, B, transpose_a=transpose_a,
                    transpose_b=transpose_b, cap=cap, expand_cap=expand_cap,
                    duplicate_policy=duplicate_policy, zero_nan=zero_nan)


def spgemm_aat(A: SparseCOO, *, cap: int | None = None,
               expand_cap: int | None = None) -> SparseCOO:
    """Gram product ``A @ A^T`` (the regridding/conservative-interpolation
    pattern — BASELINE config 4)."""
    return spgemm(A, A, transpose_b=True, cap=cap, expand_cap=expand_cap)


def best_spgemm(A: SparseCOO, B: SparseCOO, *, transpose_b: bool = False,
                cap: int | None = None) -> SparseCOO:
    """Eager structure-dispatched plain product ``C = A @ B^(T?)``.

    Host-side analysis picks the engine: when BOTH operands' average
    128x128 tile fill reaches the dense-block crossover
    (:data:`TILED_FILL_THRESHOLD`), the
    tiled path runs dense tile products with no per-product sort;
    otherwise the general sort-based ESC path. Either way the result is
    row-major consolidated (ADD), zeros dropped — the plain-``spgemm``
    contract. Scales, policies, ``transpose_a``, and jit use stay on
    :func:`spgemm` / :func:`spsparse_tpu.ops.multiply.multiply`."""
    from ..core.tiled import to_tiled
    from .spgemm_tiled import spgemm_tiled

    def fill(x):
        tl = to_tiled(x)
        live = int(np.sum(np.asarray(tl.vals) != 0))
        return live / max(int(tl.n_tiles), 1)

    # The tiled engine stores f32 blocks (densify_tiled) —
    # correct for f32/bf16 operands but a silent precision downgrade for
    # f64, so f64 operands always take the exact ESC path.
    f64 = np.dtype(A.dtype) == np.float64 or np.dtype(B.dtype) == np.float64
    if not f64 and min(fill(A), fill(B)) >= TILED_FILL_THRESHOLD:
        # use_pallas=None: the Hopper pair kernel on a GPU, the plain XLA
        # form elsewhere.
        out = spgemm_tiled(A, B, transpose_b=transpose_b, cap=cap)
        return out.consolidate((0, 1))
    return spgemm(A, B, transpose_b=transpose_b, cap=cap)


def coo_matrix_power(A: SparseCOO, k: int) -> SparseCOO:
    """``A**k`` for a square matrix by binary exponentiation over
    :func:`best_spgemm` (scipy.sparse.linalg.matrix_power) —
    ``O(log k)`` products, each structure-dispatched (tiled vs ESC).

    Eager/host-side by design: intermediate capacities are
    data-dependent (fill-in grows with each square), exactly the case
    the framework's static-cap contract routes to eager planning
    (CLAUDE.md conventions). ``k == 0`` returns the identity. For the
    action of a matrix *power series* on a vector under jit, use
    :func:`spsparse_tpu.solvers.funm_multiply` instead."""
    from ..core.construct import coo_eye
    from ..core.errors import SpSparseError
    k = int(k)
    if k < 0:
        raise SpSparseError("coo_matrix_power: negative powers need an "
                            "explicit solve; k must be >= 0")
    if A.rank != 2 or A.shape[0] != A.shape[1]:
        raise SpSparseError(f"coo_matrix_power needs a square matrix, "
                            f"got {A.shape}")
    if k == 0:
        return coo_eye(int(A.shape[0]), dtype=A.dtype)
    result = None
    base = A
    while k:
        if k & 1:
            result = base if result is None else best_spgemm(result, base)
        k >>= 1
        if k:
            base = best_spgemm(base, base)
    return result


def plan_spgemm_caps(A: SparseCOO, B: SparseCOO, *,
                     transpose_a: bool = False, transpose_b: bool = False,
                     safety: float = 1.0) -> tuple[int, int]:
    """Host-side (eager) exact capacity plan for a jitted SpGEMM.

    Returns ``(expand_cap, out_cap)`` where ``expand_cap`` is the exact
    number of elementary products (sum over A entries of the matching B row
    length — the Gustavson flop count) and ``out_cap`` bounds the output
    nnz by ``min(expand_cap, rows*cols)``. Both are scaled by ``safety``
    and rounded to powers of two, so one plan can be reused for a family of
    structurally-similar operands under a single compiled program.
    """
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    acon = Aw.consolidate((0, 1))
    bcsr = to_csr(Bw.consolidate((0, 1)))
    k = np.asarray(acon.indices[:, 1])[: int(acon.nnz)]
    row_len = np.asarray(bcsr.row_ptr[1:] - bcsr.row_ptr[:-1])
    expand = int(row_len[np.minimum(k, bcsr.nrows - 1)].sum())
    expand = max(int(expand * safety), 1)
    out = min(expand, Aw.shape[0] * Bw.shape[1])
    return round_up_pow2(expand), round_up_pow2(max(out, 1))
