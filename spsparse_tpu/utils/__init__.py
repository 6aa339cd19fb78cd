"""Utilities: tracing/profiling scopes, roofline accounting, determinism."""

from .trace import traced, trace_scope
from .compilecache import enable_persistent_cache, cache_dir
from .roofline import (OpStats, roofline, device_hbm_bandwidth,
                       device_peaks, PEAKS)

__all__ = ["traced", "trace_scope", "OpStats", "roofline",
           "enable_persistent_cache", "cache_dir",
           "device_hbm_bandwidth", "device_peaks", "PEAKS"]
