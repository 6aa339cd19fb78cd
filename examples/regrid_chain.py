"""Example: a conservative-regridding-style diag-scaled multiply chain.

Builds a synthetic overlap matrix O (destination cell x source cell), area
weights, and applies the reference-style chain

    R = diag(1/dst_area) . O . diag(src_frac) . O_identity

then round-trips the result through NetCDF. Run:

    python examples/regrid_chain.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Default to the CPU backend (set SPSPARSE_USE_GPU=1 for a real GPU):
# examples are functional demos, not benchmarks.
if not os.environ.get("SPSPARSE_USE_GPU"):
    import jax

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")

import spsparse_tpu as sp
from spsparse_tpu.io import load_netcdf, save_netcdf
from spsparse_tpu.ops import multiply, multiply_mv


def main() -> None:
    rng = np.random.default_rng(0)
    n_dst, n_src = 64, 128

    # Each destination cell overlaps ~3 source cells.
    b = sp.CooBuilder((n_dst, n_src), dtype=np.float64)
    for d in range(n_dst):
        base = d * 2
        for k in range(3):
            s = min(base + k, n_src - 1)
            b.add((d, s), rng.uniform(0.2, 1.0))
    O = b.build()

    # diag scales: inverse destination areas (dense over present rows),
    # source fractions over the inner index.
    inv_area = sp.CooBuilder((n_dst,), dtype=np.float64)
    for d in range(n_dst):
        inv_area.add((d,), 1.0 / rng.uniform(1.0, 2.0))
    src_frac = sp.CooBuilder((n_src,), dtype=np.float64)
    for s in range(n_src):
        src_frac.add((s,), rng.uniform(0.5, 1.0))
    eye = sp.CooBuilder((n_src, n_src), dtype=np.float64)
    for s in range(n_src):
        eye.add((s, s), 1.0)

    R = multiply(1.0, O, eye.build(), scalei=inv_area.build(),
                 scalej=src_frac.build())
    print("regrid matrix:", R)

    save_netcdf("/tmp/regrid.nc", {"R": R})
    R2 = load_netcdf("/tmp/regrid.nc", "R", rank=2)
    assert R2.to_lists() == R.to_lists()
    print("NetCDF round trip OK,", len(R2), "weights")

    # Apply to a sparse source field.
    field = sp.CooBuilder((n_src,), dtype=np.float64)
    for s in range(0, n_src, 3):
        field.add((s,), rng.uniform(-1, 1))
    out = multiply_mv(1.0, R2, field.build())
    print("regridded field:", out)


if __name__ == "__main__":
    main()
