"""Persistent XLA compilation cache plumbing.

Large-shape programs pay a one-time compile cost (sort-heavy shapes most
of all). JAX's persistent compilation cache turns it into a once-per-
checkout cost; the repo-wide power-of-two capacity convention
(``core.coo.round_up_pow2``) exists so that eager workloads with drifting
nnz re-hit the same compiled programs, across processes too.

Where the cache lives:

* ``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads it itself,
  and this module sets no other directory;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``). The path is part of the cache's key, so it
  never depends on a temp name, a pid or the time.

Call :func:`enable_persistent_cache` once per process before the first
compile. ``bench.py`` and ``chip_smoke.py`` do.
"""

from __future__ import annotations

import os

__all__ = ["enable_persistent_cache", "cache_dir"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    return os.environ.get(_ENV) or os.path.join(_REPO, ".jax_cache")


def enable_persistent_cache(*, min_compile_secs: float = 1.0) -> str:
    """Enable JAX's on-disk compilation cache at :func:`cache_dir`
    (created if missing). Programs whose compile took at least
    ``min_compile_secs`` are persisted and re-loaded by later processes.
    Returns the cache directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    # XLA's own caches keep JAX's default (the per-fusion autotune cache):
    # adding the GPU kernel cache file ("all") made every multi-operand
    # lax.sort fail to compile on an H200 (RET_CHECK in
    # kernel_reuse_cache.cc).
    return path
