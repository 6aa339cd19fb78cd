"""The one place the library asks which device it runs on.

Every operator has a plain ``jax.numpy``/``lax`` form that XLA compiles for
any backend. Two operators also have a hand-written Pallas kernel for
NVIDIA Hopper GPUs (the block-sparse SpMM of
:mod:`spsparse_tpu.ops.block_spmm` and the tile-pair SpGEMM of
:mod:`spsparse_tpu.ops.spgemm_tiled`); :func:`use_gpu_kernels` and
:func:`runs_gpu_kernel` decide whether they run. Nothing else in the
library branches on the backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["default_platform", "use_gpu_kernels", "runs_gpu_kernel",
           "dot_precision"]


def default_platform() -> str:
    """Platform of the default device (``"gpu"``, ``"cpu"``, ...)."""
    return jax.devices()[0].platform


def use_gpu_kernels(platform: str | None = None) -> bool:
    """True when the hand-written GPU kernels should run: the default
    device (or ``platform``, when given) is a GPU."""
    return (platform or default_platform()) == "gpu"


def runs_gpu_kernel(dtype, platform: str | None = None) -> bool:
    """Whether the hand-written GPU kernels run for blocks of ``dtype`` on
    ``platform`` (default: the default device's): bf16 blocks on a GPU.
    float32 blocks take the plain XLA form everywhere: at full precision
    (no TF32) a Triton dot runs on the CUDA cores and measured 3x or more
    slower than XLA's float32 contraction on an H200 (PERF.md)."""
    return (use_gpu_kernels(platform)
            and jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16))


def dot_precision(*dtypes) -> jax.lax.Precision:
    """Contraction precision for operands of ``dtypes``: ``HIGHEST`` for
    float32/float64 (a GPU would otherwise run float32 products in TF32,
    about 10 mantissa bits), ``DEFAULT`` for bf16 operands, which
    accumulate in float32 through ``preferred_element_type``."""
    if any(jnp.dtype(d) == jnp.bfloat16 for d in dtypes):
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST
