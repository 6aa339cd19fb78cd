"""Row-partitioned SpMV over a device mesh (runs on a virtual 8-device
CPU mesh anywhere; the same code drives a mesh of real GPUs).

Run: python examples/distributed_spmv.py
"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
# Platform choice must happen BEFORE first backend use (calling
# jax.devices()/default_backend() first would pin the platform). Opt
# into real multi-GPU hardware explicitly (SPSPARSE_USE_GPU=1); the
# default is the virtual 8-device CPU mesh, which runs anywhere.
if not os.environ.get("SPSPARSE_USE_GPU"):
    jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

import spsparse_tpu as sp
from spsparse_tpu.dist import (dist_spmv, dist_spmv_halo, partition_rows,
                               partition_vector)

n, band = 1 << 12, 4
bld = sp.CooBuilder((n, n), dtype=np.float32)
rows = np.repeat(np.arange(n), 2 * band + 1)
cols = np.clip(rows + np.tile(np.arange(-band, band + 1), n), 0, n - 1)
vals = np.random.default_rng(0).uniform(-1, 1, rows.size).astype(np.float32)
bld.add_many(np.stack([rows, cols], 1), vals)
A = bld.build().consolidate((0, 1))

P = min(8, len(jax.devices()))
mesh = Mesh(np.asarray(jax.devices()[:P]), ("x",))
part = partition_rows(A, P)
x = np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
xp = partition_vector(x, P)

y_ring = np.asarray(dist_spmv(part, xp, mesh)).reshape(-1)
y_halo = np.asarray(dist_spmv_halo(part, xp, mesh, halo=band)).reshape(-1)
y_ref = np.asarray(A.to_dense()) @ x
print("ring  max err:", float(np.abs(y_ring - y_ref).max()))
print("halo  max err:", float(np.abs(y_halo - y_ref).max()))
