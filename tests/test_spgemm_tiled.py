"""Tiled SpGEMM vs dense oracle (ops/spgemm_tiled.py).

Oracle pattern follows the reference's randomized differential testing
(test_multiply_sparse.cpp:84-136): random sparse operands, sparse product
vs densified numpy product.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from spsparse_tpu import CooBuilder
from spsparse_tpu.core.tiled import to_tiled
from spsparse_tpu.ops.spgemm_tiled import (
    TiledBlocks, densify_tiled, plan_tiled_spgemm, spgemm_tiled,
    spgemm_tiled_pallas, spgemm_tiled_xla, tiled_blocks_to_coo)


def _rand_coo(shape, nnz, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, shape[0], nnz),
                    rng.integers(0, shape[1], nnz)], axis=1)
    b = CooBuilder(shape, dtype=dtype)
    b.add_many(idx, rng.uniform(-1, 1, nnz).astype(dtype))
    return b.build().consolidate((0, 1))


def _dense(a):
    return np.asarray(a.to_dense(), np.float64)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tiled_xla_matches_dense_oracle(seed, transpose_b):
    m, k, n = 300, 260, 140
    A = _rand_coo((m, k), 400, seed)
    B = _rand_coo((n, k) if transpose_b else (k, n), 350, seed + 100)
    ta, tb = densify_tiled(to_tiled(A)), densify_tiled(to_tiled(B))
    plan = plan_tiled_spgemm(ta, tb, transpose_b=transpose_b)
    out = spgemm_tiled_xla(ta, tb, plan)
    want = _dense(A) @ (_dense(B).T if transpose_b else _dense(B))
    np.testing.assert_allclose(np.asarray(out.to_dense()), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transpose_b", [False, True])
def test_tiled_pallas_interpret_matches_xla(transpose_b):
    A = _rand_coo((200, 310), 500, 7)
    B = _rand_coo((170, 310) if transpose_b else (310, 170), 450, 8)
    ta, tb = densify_tiled(to_tiled(A)), densify_tiled(to_tiled(B))
    plan = plan_tiled_spgemm(ta, tb, transpose_b=transpose_b)
    ref = spgemm_tiled_xla(ta, tb, plan)
    out = spgemm_tiled_pallas(ta, tb, plan, interpret=True)
    assert int(out.n_tiles) == int(ref.n_tiles)
    np.testing.assert_array_equal(np.asarray(out.tile_row),
                                  np.asarray(ref.tile_row))
    np.testing.assert_allclose(np.asarray(out.blocks),
                               np.asarray(ref.blocks), rtol=1e-6,
                               atol=1e-6)


def test_tiled_coo_extraction_consolidated():
    A = _rand_coo((150, 220), 300, 11)
    B = _rand_coo((220, 90), 280, 12)
    C = spgemm_tiled(A, B, use_pallas=False)
    want = _dense(A) @ _dense(B)
    got = np.asarray(C.consolidate((0, 1)).to_dense())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # zero-product drop: every emitted value is nonzero
    vals = np.asarray(C.vals)[: int(C.nnz)]
    assert (vals != 0).all()


def test_tiled_aat_regrid_pattern():
    # BASELINE config-4 structure: 4 nnz/row clustered at col ~ 2r.
    n = 600
    rng = np.random.default_rng(0)
    r = np.repeat(np.arange(n), 4)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), 2 * n - 1)
    b = CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), rng.uniform(0, 1, r.size))
    A = b.build().consolidate((0, 1))
    C = spgemm_tiled(A, A, transpose_b=True, use_pallas=False)
    want = _dense(A) @ _dense(A).T
    np.testing.assert_allclose(
        np.asarray(C.consolidate((0, 1)).to_dense()), want,
        rtol=1e-5, atol=1e-5)


def test_tiled_empty_intersection():
    # A occupies left block-columns, B rows only in right block-rows:
    # no tile pairs match.
    ba = CooBuilder((100, 400), dtype=np.float32)
    ba.add((0, 0), 1.0)
    bb = CooBuilder((400, 50), dtype=np.float32)
    bb.add((399, 0), 2.0)
    A, B = ba.build(), bb.build()
    C = spgemm_tiled(A, B, use_pallas=False)
    assert int(C.nnz) == 0
    ta, tb = densify_tiled(to_tiled(A)), densify_tiled(to_tiled(B))
    plan = plan_tiled_spgemm(ta, tb)
    assert plan.n_pairs == 0


def test_tiled_inner_dim_mismatch_raises():
    A = _rand_coo((64, 64), 10, 1)
    B = _rand_coo((100, 64), 10, 2)
    ta, tb = densify_tiled(to_tiled(A)), densify_tiled(to_tiled(B))
    with pytest.raises(Exception):
        plan_tiled_spgemm(ta, tb)  # 64 vs 100


def test_tiled_bf16_blocks():
    A = _rand_coo((256, 256), 800, 21)
    B = _rand_coo((256, 256), 800, 22)
    C = spgemm_tiled(A, B, dtype=jnp.bfloat16, use_pallas=False)
    want = _dense(A) @ _dense(B)
    got = np.asarray(C.consolidate((0, 1)).to_dense())
    # bf16 has ~3 decimal digits; products of ~6-term dots stay within 2%.
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_tiled_blocks_roundtrip_to_coo():
    A = _rand_coo((130, 140), 120, 31)
    tbk = densify_tiled(to_tiled(A))
    back = tiled_blocks_to_coo(tbk)
    # to_dense works directly on the unsorted COO; no consolidate needed.
    np.testing.assert_allclose(np.asarray(back.to_dense()), _dense(A),
                               rtol=0, atol=0)


def test_tiled_blocks_to_dense_partial_edge_tiles():
    A = _rand_coo((130, 70), 90, 41)
    tbk = densify_tiled(to_tiled(A))
    assert isinstance(tbk, TiledBlocks)
    np.testing.assert_allclose(np.asarray(tbk.to_dense()), _dense(A),
                               rtol=0, atol=0)


def test_tiled_blocks_feed_spmm_kernel():
    # C = A @ A^T (tiled) -> Y = C @ X via the dense-block SpMM kernel,
    # all in block form (no COO round trip).
    from spsparse_tpu.ops.block_spmm import spmm_tiled_dense
    import jax.numpy as _jnp
    A = _rand_coo((300, 400), 700, 51)
    ta = densify_tiled(to_tiled(A))
    plan = plan_tiled_spgemm(ta, ta, transpose_b=True)
    C = spgemm_tiled_xla(ta, ta, plan)
    prep = C.to_prepared_dense()
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
    Y = np.asarray(spmm_tiled_dense(prep, _jnp.asarray(X),
                                    interpret=True))
    dA = _dense(A)
    want = (dA @ dA.T) @ X
    np.testing.assert_allclose(Y, want, rtol=1e-4, atol=1e-4)


class TestBestSpgemm:
    def test_routes_and_matches_on_both_structures(self, rng):
        from spsparse_tpu import CooBuilder
        from spsparse_tpu.ops import best_spgemm, spgemm

        # Blocky (regrid-style) operands -> tiled path.
        n = 512
        r = np.repeat(np.arange(n), 4)
        c = np.minimum(r * 2 + rng.integers(0, 3, r.size), 2 * n - 1)
        b = CooBuilder((n, 2 * n), dtype=np.float32)
        b.add_many(np.stack([r, c], 1),
                   rng.uniform(0, 1, r.size).astype(np.float32))
        A = b.build()
        C = best_spgemm(A, A, transpose_b=True)
        ref = np.asarray(A.to_dense()) @ np.asarray(A.to_dense()).T
        np.testing.assert_allclose(np.asarray(C.to_dense()), ref,
                                   rtol=1e-4, atol=1e-4)
        assert C.sort_order == (0, 1)

        # Scattered operands -> ESC path; same contract.
        s1 = CooBuilder((60, 80), dtype=np.float32)
        idx = np.stack([rng.integers(0, 60, 90), rng.integers(0, 80, 90)], 1)
        s1.add_many(idx, rng.uniform(-1, 1, 90).astype(np.float32))
        S = s1.build()
        C2 = best_spgemm(S, S, transpose_b=True)
        ref2 = np.asarray(S.to_dense()) @ np.asarray(S.to_dense()).T
        np.testing.assert_allclose(np.asarray(C2.to_dense()), ref2,
                                   rtol=1e-4, atol=1e-4)


def test_empty_plan_filler_is_sentinel(rng):
    # Disjoint patterns: no pairs -> the empty-result filler block must
    # carry sentinel coordinates, not a live-looking (0, 0).
    from spsparse_tpu import CooBuilder
    from spsparse_tpu.core.tiled import to_tiled
    from spsparse_tpu.ops.spgemm_tiled import (densify_tiled,
                                               plan_tiled_spgemm,
                                               spgemm_tiled_xla)
    a = CooBuilder((128, 256), dtype=np.float32)
    a.add((0, 0), 1.0)                      # A touches inner tile 0
    bm = CooBuilder((256, 128), dtype=np.float32)
    bm.add((200, 0), 1.0)                   # B touches inner tile 1 only
    ta, tb = densify_tiled(to_tiled(a.build())), densify_tiled(
        to_tiled(bm.build()))
    plan = plan_tiled_spgemm(ta, tb)
    assert plan.n_pairs == 0
    out = spgemm_tiled_xla(ta, tb, plan)
    assert int(out.tile_row[0]) >= -(-out.shape[0] // 128)
    np.testing.assert_array_equal(np.asarray(out.to_dense()),
                                  np.zeros(out.shape, np.float32))


def _banded_coo(n, m, half, seed):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 2 * half + 1)
    c = np.clip(r * m // n + np.tile(np.arange(-half, half + 1), n), 0,
                m - 1)
    b = CooBuilder((n, m), dtype=np.float32)
    b.add_many(np.stack([r, c], 1),
               rng.uniform(-1, 1, r.size).astype(np.float32))
    return b.build().consolidate((0, 1))


@pytest.mark.parametrize("case", [
    # (name, A shape, B shape, transpose_b, dtype, bm, bn)
    ("square_nt", (260, 300), (300, 190), False, np.float32, 64, 64),
    ("square_t", (260, 300), (190, 300), True, np.float32, 64, 64),
    ("bf16_t", (200, 310), (170, 310), True, jnp.bfloat16, 64, 64),
    ("bf16_nt", (200, 310), (310, 170), False, jnp.bfloat16, 64, 64),
    ("full_tile_slabs", (256, 384), (256, 384), True, np.float32, 128, 128),
    ("thin_slabs", (129, 257), (257, 129), False, np.float32, 32, 64),
    ("wide_slabs", (300, 140), (140, 300), False, np.float32, 128, 64),
    ("banded_gram", "banded", None, True, np.float32, 64, 64),
])
def test_pair_kernel_interpret_cases(case):
    """The Hopper pair kernel (Pallas interpreter) equals the plain
    batched-product + segment_sum form and the dense oracle: partial edge
    tiles, both contraction modes, bf16/f32, every slab shape."""
    from spsparse_tpu.ops.spgemm_tiled import (plan_pstart,
                                               spgemm_pairs_pallas)
    name, sa, sb, tb, dt, bm, bn = case
    if sa == "banded":
        A = _banded_coo(400, 800, 3, 11)
        B = A
    else:
        A = _rand_coo(sa, 600, 21)
        B = _rand_coo(sb, 500, 22)
    ta = densify_tiled(to_tiled(A), dtype=dt)
    tbk = densify_tiled(to_tiled(B), dtype=dt)
    plan = plan_tiled_spgemm(ta, tbk, transpose_b=tb)
    ref = spgemm_tiled_xla(ta, tbk, plan)
    out = spgemm_pairs_pallas(
        ta.blocks, tbk.blocks, jnp.asarray(plan_pstart(plan)),
        jnp.asarray(plan.pa), jnp.asarray(plan.pb), transpose_b=tb,
        n_out=plan.n_out_tiles, bm=bm, bn=bn, interpret=True)
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref.blocks),
                               rtol=1e-5, atol=1e-5)
    want = _dense(A) @ (_dense(B).T if tb else _dense(B))
    got = TiledBlocks(tile_row=ref.tile_row, tile_col=ref.tile_col,
                      blocks=out, shape=plan.out_shape).to_dense()
    # bf16 operands: 8 mantissa bits each, f32 accumulation
    tol = 3e-2 if dt == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol)


def test_pair_kernel_empty_intersection():
    # A's columns and B's rows never meet: no pairs, an empty product
    A = _rand_coo((200, 256), 50, 31)
    Ad = np.asarray(A.to_dense())
    keep = np.argwhere(Ad[:, :128] != 0)
    b = CooBuilder((200, 256), dtype=np.float32)
    b.add_many(keep, Ad[keep[:, 0], keep[:, 1]].astype(np.float32))
    A_left = b.build()
    bb = CooBuilder((256, 90), dtype=np.float32)
    bb.add((200, 5), 1.0)
    bb.add((255, 80), 2.0)
    B = bb.build()
    C = spgemm_tiled(A_left, B, interpret=True)
    assert int(C.nnz) == 0
    C2 = spgemm_tiled(A_left, B, use_pallas=False)
    assert int(C2.nnz) == 0


@pytest.mark.parametrize("platform,dtype,expect_kernel", [
    ("gpu", jnp.bfloat16, True), ("gpu", jnp.float32, False),
    ("cpu", jnp.bfloat16, False), ("cpu", jnp.float32, False)])
def test_spgemm_tiled_follows_dispatch(monkeypatch, platform, dtype,
                                       expect_kernel):
    """``use_pallas=None`` follows ``core.backend.use_gpu_kernels``: the
    pair kernel runs for bf16 blocks on a GPU only."""
    import importlib
    backend = importlib.import_module("spsparse_tpu.core.backend")
    st = importlib.import_module("spsparse_tpu.ops.spgemm_tiled")
    calls = []
    real = st.spgemm_tiled_pallas

    def spy(A, B, plan, *, interpret=False):
        calls.append(interpret)
        return real(A, B, plan, interpret=True)

    monkeypatch.setattr(backend, "default_platform", lambda: platform)
    monkeypatch.setattr(st, "spgemm_tiled_pallas", spy)
    A = _rand_coo((150, 200), 300, 41)
    C = spgemm_tiled(A, A, transpose_b=True, dtype=dtype)
    assert bool(calls) == expect_kernel
    # bf16 operands: 8 mantissa bits each, f32 accumulation
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(np.asarray(C.to_dense()),
                               _dense(A) @ _dense(A).T, rtol=tol,
                               atol=tol)
