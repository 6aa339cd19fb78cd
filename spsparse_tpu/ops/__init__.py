"""Sparse operator layer: multiply chains, SpMV/SpMM, SpGEMM, kernels."""

from .multiply import multiply, multiply_mv, multiply_chain, expansion_size
from .spgemm import (spgemm, spgemm_aat, plan_spgemm_caps, best_spgemm,
                     coo_matrix_power)
from .spgemm_tiled import spgemm_tiled, plan_tiled_spgemm, densify_tiled
from .spgemm_planned import plan_esc, spgemm_planned, spgemm_planned_vals
from .general import (PreparedGeneral, prepare_general, spmm_general,
                      spmv_general)
from .block_spmm import (PreparedTiledDense, prepare_tiled_dense,
                         spmm_tiled_dense)
from .spmm import spmv, spmm, spmm_bsr
from .spmv_kernels import (spmv_dia, spmv_ell, prepare_dia, best_spmv,
                           best_spmm, spmm_route)
from .tiled_ops import spmv_tiled, spmm_tiled

__all__ = [
    "multiply", "multiply_mv", "multiply_chain", "expansion_size",
    "spgemm", "spgemm_aat", "plan_spgemm_caps", "best_spgemm",
    "coo_matrix_power",
    "spgemm_tiled", "plan_tiled_spgemm", "densify_tiled",
    "plan_esc", "spgemm_planned", "spgemm_planned_vals",
    "PreparedGeneral", "prepare_general", "spmm_general", "spmv_general",
    "PreparedTiledDense", "prepare_tiled_dense", "spmm_tiled_dense",
    "spmv", "spmm", "spmm_bsr",
    "spmv_dia", "spmv_ell", "prepare_dia", "best_spmv", "best_spmm",
    "spmm_route",
    "spmv_tiled", "spmm_tiled",
]
