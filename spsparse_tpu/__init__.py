"""spsparse-tpu: a sparse linear-algebra framework on JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
spsparse C++ template library (rank-N COO arrays, duplicate-consolidating
sort, sorted-merge joins, the diag-scaled sparse multiply chain, SpMV/SpMM,
NetCDF I/O) plus the capabilities an accelerator target demands:
static-shape padded arrays that travel through ``jit``/``vmap``/
``shard_map``, CSR/ELL/DIA/dense-block views, Hopper Pallas kernels where
they beat XLA (``core.backend``), and multi-device row-partitioned
execution over ``jax.sharding.Mesh``.
"""

from .core.dia import SparseDIA, to_dia
from .core.bsr import SparseBSR, to_bsr
from .core.tiled import SparseTiledCOO, to_tiled
from .core import (
    DuplicatePolicy,
    SpSparseError,
    set_error_handler,
    set_dump_stack_on_error,
    isnone,
    ROW_MAJOR,
    COL_MAJOR,
    SparseCOO,
    CooBuilder,
    coo_matrix,
    coo_vector,
    consolidate,
    sorted_permutation,
    filter_compact,
    Consolidated,
    dim_beginnings,
    DimBeginnings,
    SparseCSR,
    SparseELL,
    to_csr,
    to_csc,
    to_ell,
    coo_concat,
    coo_binop,
    coo_multiply,
    coo_maximum,
    coo_minimum,
    coo_power,
    coo_add,
    coo_scale,
    coo_hstack,
    coo_vstack,
    coo_block_diag,
    coo_norm,
    coo_eye,
    coo_diags,
    coo_random,
    coo_slice,
    coo_kron,
    coo_kronsum,
    coo_filter,
    coo_tril,
    coo_triu,
    rcm_permutation,
    coo_permute,
    bandwidth,
    row_sums,
    col_sums,
    scale_rows,
    scale_cols,
    join2,
    join3,
    scatter_to_dense,
    scalar_sum,
    permute_output,
    project_output,
)

# Subpackages as attributes (sp.ops.multiply, sp.solvers.pcg_solve, ...)
# — the natural spelling for users coming from scipy.sparse.
from . import core, graph, io, ops, solvers, utils  # noqa: E402
from . import dist  # noqa: E402

__version__ = "0.1.0"
