"""Multi-host glue: process initialization + per-host partition ownership.

A multi-host cluster runs one process per host; collectives span all of
them once ``jax.distributed.initialize`` has run. These helpers wire that
into the row-partitioned containers and the sharded checkpoint writer so a
pod-slice program is::

    from spsparse_tpu.dist import multihost as mh

    mh.initialize(coordinator_address="host0:1234",
                  num_processes=2, process_id=0)
    mesh = mh.pod_mesh("x")
    part = partition_rows(A, mesh.devices.size)
    ...
    save_netcdf_sharded(prefix, part, parts=mh.my_partitions(part.n_parts))

Single-process (CPU testing with a virtual device count) works through the
same API: ``initialize`` becomes a no-op and ``my_partitions`` returns all
partitions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["initialize", "pod_mesh", "my_partitions", "is_multiprocess"]


def initialize(**kwargs) -> None:
    """``jax.distributed.initialize`` (pass ``coordinator_address``,
    ``num_processes`` and ``process_id``; GPU hosts have no
    autodiscovery); safe to call when already initialized or
    single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized, or single-process without coordinator config
        pass


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def pod_mesh(axis: str = "x") -> Mesh:
    """1-D mesh over every device in the (possibly multi-host) slice."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def my_partitions(n_parts: int) -> Sequence[int]:
    """The partition indices this *process* owns under the block-row
    distribution (for per-host checkpoint writes): partition ``p`` lives on
    the host owning device ``p`` of the pod mesh."""
    devs = jax.devices()
    me = jax.process_index()
    return [p for p in range(n_parts)
            if devs[p % len(devs)].process_index == me]
