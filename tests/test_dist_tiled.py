"""Distributed tiled SpGEMM on the 8-device virtual mesh."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from spsparse_tpu import CooBuilder
from spsparse_tpu.dist import dist_spgemm_tiled, plan_dist_spgemm_tiled
from spsparse_tpu.core.errors import SpSparseError


def _mesh(p):
    devs = jax.devices()
    if len(devs) < p:
        pytest.skip(f"needs {p} devices")
    return Mesh(np.asarray(devs[:p]), ("x",))


def _regrid(n, seed=0, per=4):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), 2 * n - 1)
    b = CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1),
               rng.uniform(0, 1, r.size).astype(np.float32))
    return b.build().consolidate((0, 1))


@pytest.mark.parametrize("p", [2, 8])
def test_aat_matches_dense_oracle(p):
    mesh = _mesh(p)
    A = _regrid(1200)
    plan = plan_dist_spgemm_tiled(A, A, p)
    out = dist_spgemm_tiled(plan, mesh)
    got = np.asarray(out.to_dense())
    dA = np.asarray(A.to_dense(), np.float64)
    np.testing.assert_allclose(got, dA @ dA.T, rtol=1e-5, atol=1e-5)


def test_rectangular_abt(p=4):
    mesh = _mesh(p)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, 700, 900),
                    rng.integers(0, 500, 900)], 1)
    ba = CooBuilder((700, 500), dtype=np.float32)
    ba.add_many(idx, rng.uniform(-1, 1, 900).astype(np.float32))
    A = ba.build().consolidate((0, 1))
    idx2 = np.stack([rng.integers(0, 300, 800),
                     rng.integers(0, 500, 800)], 1)
    bb = CooBuilder((300, 500), dtype=np.float32)
    bb.add_many(idx2, rng.uniform(-1, 1, 800).astype(np.float32))
    B = bb.build().consolidate((0, 1))
    plan = plan_dist_spgemm_tiled(A, B, p)
    out = dist_spgemm_tiled(plan, mesh)
    want = (np.asarray(A.to_dense(), np.float64)
            @ np.asarray(B.to_dense(), np.float64).T)
    np.testing.assert_allclose(np.asarray(out.to_dense()), want,
                               rtol=1e-5, atol=1e-5)


def test_agrees_with_single_device_tiled(p=4):
    from spsparse_tpu.ops.spgemm_tiled import spgemm_tiled
    mesh = _mesh(p)
    A = _regrid(900, seed=7)
    plan = plan_dist_spgemm_tiled(A, A, p)
    out = dist_spgemm_tiled(plan, mesh)
    single = spgemm_tiled(A, A, transpose_b=True, use_pallas=False)
    np.testing.assert_allclose(np.asarray(out.to_dense()),
                               np.asarray(single.to_dense()),
                               rtol=1e-6, atol=1e-6)


def test_untransposed_rejected():
    A = _regrid(300)
    with pytest.raises(SpSparseError):
        plan_dist_spgemm_tiled(A, A, 2, transpose_b=False)


def test_mesh_size_mismatch_rejected():
    A = _regrid(300)
    plan = plan_dist_spgemm_tiled(A, A, 2)
    with pytest.raises(SpSparseError):
        dist_spgemm_tiled(plan, _mesh(4))


def test_empty_trailing_partitions_no_junk_tiles():
    # B rows stop well short of the padded extent: the last partitions are
    # EMPTY. Their filler blocks must not generate pairs or register junk
    # output tiles (they used to, as live-looking (0,0) tiles).
    import numpy as np
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.dist import plan_dist_spgemm_tiled, dist_spgemm_tiled
    from jax.sharding import Mesh
    import jax

    rng = np.random.default_rng(0)
    n, m = 200, 300                     # 300 rows over 4 parts of 256 pad
    b = CooBuilder((n, m), dtype=np.float32)
    r = rng.integers(0, n, 400)
    c = rng.integers(0, m, 400)
    b.add_many(np.stack([r, c], 1),
               rng.uniform(-1, 1, 400).astype(np.float32))
    A = b.build()
    bb = CooBuilder((128, m), dtype=np.float32)   # only 1 block row lives
    rb = rng.integers(0, 128, 300)
    cb = rng.integers(0, m, 300)
    bb.add_many(np.stack([rb, cb], 1),
                rng.uniform(-1, 1, 300).astype(np.float32))
    B = b.build(), bb.build()
    plan = plan_dist_spgemm_tiled(A, B[1], 4, transpose_b=True)
    nbr_c = -(-A.shape[0] // 128)
    nbc_c = plan.out_tile_col.max()   # sentinel included
    # every REGISTERED (non-sentinel) out tile must be in range
    otr, otc = plan.out_tile_row, plan.out_tile_col
    live = otr < np.full_like(otr, -(-plan.out_shape[0] // 128))
    assert (otc[live] < -(-plan.out_shape[1] // 128)).all()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("x",))
    C = dist_spgemm_tiled(plan, mesh)
    np.testing.assert_allclose(
        np.asarray(C.to_dense()),
        np.asarray(A.to_dense()) @ np.asarray(B[1].to_dense()).T,
        rtol=1e-4, atol=1e-4)


def test_ring_overflow_reported(rng):
    # Undersized expand_cap_step must be REPORTED, not silently truncated.
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.dist import (dist_spgemm_ring, partition_bucketed,
                                   partition_rows)

    n = 32
    b = CooBuilder((n, n), dtype=np.float64)
    r = np.repeat(np.arange(n), 8)
    c = np.tile(np.arange(8), n)
    b.add_many(np.stack([r, c], 1), rng.uniform(1, 2, r.size))
    A = b.build()
    d = CooBuilder((n, n), dtype=np.float64)
    rd = np.repeat(np.arange(8), n)
    cd = np.tile(np.arange(n), 8)
    d.add_many(np.stack([rd, cd], 1), rng.uniform(1, 2, rd.size))
    B = d.build()
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))
    bp = partition_rows(B, 8)
    abkt = partition_bucketed(A, 8, blk_len=bp.rows_local)
    C_ok, ov_ok = dist_spgemm_ring(abkt, bp, mesh, expand_cap_step=2048,
                                   out_cap=2048)
    assert int(np.asarray(ov_ok).sum()) == 0
    np.testing.assert_allclose(
        np.asarray(C_ok.to_coo().to_dense()),
        np.asarray(A.to_dense()) @ np.asarray(B.to_dense()), rtol=1e-10)
    _, ov_bad = dist_spgemm_ring(abkt, bp, mesh, expand_cap_step=16,
                                 out_cap=2048)
    assert int(np.asarray(ov_bad).sum()) > 0
