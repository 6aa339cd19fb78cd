"""Core-layer tests pinned to the reference's golden values.

Mirrors /root/reference/tests/test_array.cpp (container, permutation
stability, transpose involution, consolidate goldens, dim_beginnings,
dense round trips) and the reference's documented duplicate-policy
semantics.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spsparse_tpu import (
    CooBuilder,
    DuplicatePolicy,
    SparseCOO,
    SpSparseError,
    consolidate,
    dim_beginnings,
    scalar_sum,
    sorted_permutation,
    to_csr,
    to_ell,
)


def build(shape, entries, dtype=np.float64):
    b = CooBuilder(shape, dtype=dtype)
    for idx, v in entries:
        b.add(idx, v)
    return b.build()


class TestContainer:
    # Reference test_array.cpp:39-64 (VectorCooArray)
    def test_add_and_access(self):
        b = CooBuilder((4,))
        b.add((1,), 2.0)
        b.add((3,), 6.0)
        arr = b.build()
        assert len(arr) == 2
        assert int(arr.index(0, 0)) == 1
        assert int(arr.index(0, 1)) == 3
        assert float(arr.val(0)) == 2.0

    def test_bounds_check_raises(self):
        b = CooBuilder((4,))
        with pytest.raises(SpSparseError):
            b.add((17,), 4.0)
        with pytest.raises(SpSparseError):
            b.add((-1,), 4.0)

    def test_from_arrays_bounds_check(self):
        with pytest.raises(SpSparseError):
            SparseCOO.from_arrays([[0, 5]], [1.0], (2, 4))

    def test_capacity_and_padding(self):
        arr = build((2, 4), [((1, 3), 5.0), ((0, 1), 2.0)])
        grown = arr.with_capacity(10)
        assert grown.cap == 10
        assert int(grown.nnz) == 2
        # Padding has sentinel indices and zero vals
        np.testing.assert_array_equal(np.asarray(grown.indices)[2:],
                                      np.tile([2, 4], (8, 1)))
        np.testing.assert_array_equal(np.asarray(grown.vals)[2:], 0.0)
        np.testing.assert_allclose(np.asarray(grown.to_dense()),
                                   np.asarray(arr.to_dense()))


class TestPermutation:
    # Reference test_array.cpp:67-79 — stability-sensitive goldens.
    def test_sorted_permutation_goldens(self):
        arr = build((2, 4), [((1, 3), 5.0), ((1, 2), 3.0), ((0, 3), 17.0)])
        perm0 = np.asarray(sorted_permutation(arr, (0, 1)))[: len(arr)]
        np.testing.assert_array_equal(perm0, [2, 1, 0])
        perm1 = np.asarray(sorted_permutation(arr, (1, 0)))[: len(arr)]
        np.testing.assert_array_equal(perm1, [1, 2, 0])

    def test_stability_with_duplicates(self):
        # {1,2} inserted twice: stable sort must keep insertion order
        arr = build((2, 4), [((1, 3), 5.0), ((1, 2), 3.0), ((0, 3), 17.0),
                             ((1, 2), 15.0)])
        perm = np.asarray(sorted_permutation(arr, (1, 0)))[: len(arr)]
        np.testing.assert_array_equal(perm, [1, 3, 2, 0])


class TestTranspose:
    # Reference test_array.cpp:108-132 — in-place transpose involution.
    ENTRIES = [((1, 3), 5.0), ((1, 2), 3.0), ((0, 3), 17.0),
               ((0, 1), 14.0), ((1, 2), 15.0)]

    def test_indices_only_involution(self):
        arr = build((2, 4), self.ENTRIES)
        n = len(arr)
        a1 = arr.transpose_indices_only((0, 1))
        np.testing.assert_array_equal(a1.index(0)[:n], [1, 1, 0, 0, 1])
        np.testing.assert_array_equal(a1.index(1)[:n], [3, 2, 3, 1, 2])
        np.testing.assert_array_equal(a1.vals[:n], [5., 3., 17., 14., 15.])

        a2 = a1.transpose_indices_only((1, 0))
        np.testing.assert_array_equal(a2.index(0)[:n], [3, 2, 3, 1, 2])
        np.testing.assert_array_equal(a2.index(1)[:n], [1, 1, 0, 0, 1])

        a3 = a2.transpose_indices_only((1, 0))
        np.testing.assert_array_equal(a3.index(0)[:n], [1, 1, 0, 0, 1])
        np.testing.assert_array_equal(a3.index(1)[:n], [3, 2, 3, 1, 2])
        np.testing.assert_array_equal(a3.vals[:n], [5., 3., 17., 14., 15.])

    def test_transposed_permutes_shape(self):
        arr = build((2, 4), self.ENTRIES)
        t = arr.transposed((1, 0))
        assert t.shape == (4, 2)
        np.testing.assert_allclose(np.asarray(t.to_dense()),
                                   np.asarray(arr.to_dense()).T)


class TestConsolidate:
    ENTRIES = [((1, 3), 5.0), ((1, 2), 3.0), ((0, 3), 17.0),
               ((0, 1), 14.0), ((1, 2), 15.0)]

    # Reference test_array.cpp:135-168 — exact golden vectors.
    def test_row_major_golden(self):
        arr = build((2, 4), self.ENTRIES)
        c = consolidate(arr, (0, 1))
        assert int(c.nnz) == 4
        n = int(c.nnz)
        np.testing.assert_array_equal(np.asarray(c.index(0))[:n], [0, 0, 1, 1])
        np.testing.assert_array_equal(np.asarray(c.index(1))[:n], [1, 3, 2, 3])
        np.testing.assert_allclose(np.asarray(c.vals)[:n], [14., 17., 18., 5.])
        assert dim_beginnings(c).to_list() == [0, 2, 4]

    def test_col_major_golden(self):
        arr = build((2, 4), self.ENTRIES)
        c = consolidate(arr, (1, 0))
        n = int(c.nnz)
        np.testing.assert_array_equal(np.asarray(c.index(0))[:n], [0, 1, 0, 1])
        np.testing.assert_array_equal(np.asarray(c.index(1))[:n], [1, 2, 3, 3])
        np.testing.assert_allclose(np.asarray(c.vals)[:n], [14., 18., 17., 5.])
        assert dim_beginnings(c).to_list() == [0, 1, 2, 4]

    def test_policies(self):
        arr = build((2, 4), self.ENTRIES)
        first = consolidate(arr, (0, 1), DuplicatePolicy.LEAVE_ALONE)
        np.testing.assert_allclose(
            np.asarray(first.vals)[:4], [14., 17., 3., 5.])
        last = consolidate(arr, (0, 1), DuplicatePolicy.REPLACE)
        np.testing.assert_allclose(
            np.asarray(last.vals)[:4], [14., 17., 15., 5.])

    def test_zero_dropping(self):
        # Input zeros dropped before merging (so REPLACE of [5, 0] keeps 5);
        # merged sums that equal zero are kept (algorithm.hpp:287 emits
        # unconditionally).
        arr = build((4,), [((1,), 5.0), ((1,), 0.0), ((2,), 3.0),
                           ((2,), -3.0), ((3,), 0.0)])
        rep = consolidate(arr, (0,), DuplicatePolicy.REPLACE)
        idx, vals = rep.to_lists()
        assert idx == [(1,), (2,)]
        np.testing.assert_allclose(vals, [5.0, -3.0])
        add = consolidate(arr, (0,))
        idx, vals = add.to_lists()
        assert idx == [(1,), (2,)]
        np.testing.assert_allclose(vals, [5.0, 0.0])  # zero SUM is kept

    def test_zero_nan(self):
        arr = build((4,), [((0,), np.nan), ((1,), 5.0), ((1,), np.nan),
                           ((2,), np.nan)])
        keep = consolidate(arr, (0,))
        idx, vals = keep.to_lists()
        assert idx == [(0,), (1,), (2,)]
        assert np.isnan(vals[0]) and np.isnan(vals[1]) and np.isnan(vals[2])
        drop = consolidate(arr, (0,), zero_nan=True)
        idx, vals = drop.to_lists()
        assert idx == [(1,)]
        np.testing.assert_allclose(vals, [5.0])

    def test_noop_when_sorted(self):
        arr = build((2, 4), self.ENTRIES)
        c = arr.consolidate((0, 1))
        assert c.consolidate((0, 1)) is c

    def test_empty(self):
        arr = SparseCOO.empty((3, 3), cap=8)
        c = consolidate(arr, (0, 1))
        assert int(c.nnz) == 0
        assert c.sort_order == (0, 1)


class TestDimBeginnings:
    # Reference test_array.cpp:170-218.
    def test_present_rows_walk(self):
        arr = build((20, 10), [((1, 0), 15.0), ((1, 3), 17.0),
                               ((2, 4), 17.0), ((6, 4), 10.0)])
        c = consolidate(arr, (0, 1))
        db = dim_beginnings(c)
        assert db.rows_to_list() == [1, 2, 6]
        assert db.to_list() == [0, 2, 3, 4]
        # Row contents via the slices
        idx, vals = c.to_lists()
        b = db.to_list()
        row0 = [(idx[p][1], vals[p]) for p in range(b[0], b[1])]
        assert row0 == [(0, 15.0), (3, 17.0)]
        row1 = [(idx[p][1], vals[p]) for p in range(b[1], b[2])]
        assert row1 == [(4, 17.0)]
        row2 = [(idx[p][1], vals[p]) for p in range(b[2], b[3])]
        assert row2 == [(4, 10.0)]

    def test_unsorted_raises(self):
        arr = build((4, 4), [((1, 0), 1.0)])
        with pytest.raises(SpSparseError):
            dim_beginnings(arr)


class TestDense:
    # Reference test_array.cpp:221-267.
    def test_to_dense(self):
        arr = build((20, 10), [((1, 0), 15.0), ((1, 3), 17.0),
                               ((2, 4), 17.0), ((6, 4), 10.0)])
        dense = np.asarray(arr.to_dense())
        assert dense.sum() == 59.0
        idx, vals = arr.to_lists()
        for i, v in zip(idx, vals):
            assert dense[i] == v

    def test_dense_round_trip(self):
        dense1 = np.zeros((4, 5))
        dense1[2, 3] = 5.0
        dense1[2, 4] = 6.0
        dense1[0, 1] = 7.0
        sp = SparseCOO.from_dense(dense1)
        assert int(sp.nnz) == 3
        np.testing.assert_allclose(np.asarray(sp.to_dense()), dense1)
        # jit-compatible variant with explicit cap
        sp2 = SparseCOO.from_dense(jnp.asarray(dense1), cap=8)
        assert int(sp2.nnz) == 3
        np.testing.assert_allclose(np.asarray(sp2.to_dense()), dense1)

    def test_scalar_sum(self):
        arr = build((20, 10), [((1, 0), 15.0), ((1, 3), 17.0),
                               ((2, 4), 17.0), ((6, 4), 10.0)])
        assert float(scalar_sum(arr)) == 59.0


class TestViews:
    def test_csr(self):
        arr = build((5, 6), [((1, 0), 1.0), ((1, 3), 2.0), ((3, 4), 3.0),
                             ((3, 4), 4.0), ((0, 5), 5.0)])
        csr = to_csr(arr)
        np.testing.assert_array_equal(csr.row_ptr, [0, 1, 3, 3, 4, 4])
        dense = np.asarray(arr.to_dense())
        np.testing.assert_allclose(np.asarray(csr.to_dense()), dense)
        # row_ids round trip
        rid = np.asarray(csr.row_ids())[: int(csr.nnz)]
        np.testing.assert_array_equal(rid, [0, 1, 1, 3])

    def test_csr_transpose(self):
        arr = build((5, 6), [((1, 0), 1.0), ((1, 3), 2.0), ((3, 4), 3.0)])
        csrt = to_csr(arr, transpose=True)
        assert csrt.shape == (6, 5)
        np.testing.assert_allclose(np.asarray(csrt.to_dense()),
                                   np.asarray(arr.to_dense()).T)

    def test_ell(self):
        arr = build((5, 6), [((1, 0), 1.0), ((1, 3), 2.0), ((3, 4), 3.0),
                             ((0, 5), 5.0)])
        ell = to_ell(arr)
        assert ell.max_row_nnz == 2
        np.testing.assert_allclose(np.asarray(ell.to_dense()),
                                   np.asarray(arr.to_dense()))


class TestRankN:
    def test_rank3_consolidate(self):
        b = CooBuilder((3, 4, 5), dtype=np.float64)
        b.add((2, 1, 0), 1.0)
        b.add((0, 3, 4), 2.0)
        b.add((2, 1, 0), 3.0)
        b.add((1, 0, 0), 4.0)
        arr = b.build()
        c = consolidate(arr, (0, 1, 2))
        idx, vals = c.to_lists()
        assert idx == [(0, 3, 4), (1, 0, 0), (2, 1, 0)]
        np.testing.assert_allclose(vals, [2.0, 4.0, 4.0])
        # alternate sort order
        c2 = consolidate(arr, (2, 1, 0))
        assert c2.sort_order == (2, 1, 0)
        idx2, _ = c2.to_lists()
        assert idx2 == [(1, 0, 0), (2, 1, 0), (0, 3, 4)]

    def test_rank3_transpose_and_dense(self):
        b = CooBuilder((2, 3, 4), dtype=np.float64)
        b.add((1, 2, 3), 5.0)
        b.add((0, 1, 2), 7.0)
        arr = b.build()
        t = arr.transposed((2, 0, 1))
        assert t.shape == (4, 2, 3)
        np.testing.assert_allclose(np.asarray(t.to_dense()),
                                   np.transpose(np.asarray(arr.to_dense()),
                                                (2, 0, 1)))

    def test_rank3_dim_beginnings(self):
        b = CooBuilder((3, 2, 2), dtype=np.float64)
        b.add((0, 1, 1), 1.0)
        b.add((2, 0, 0), 2.0)
        b.add((2, 1, 0), 3.0)
        c = consolidate(b.build(), (0, 1, 2))
        db = dim_beginnings(c)
        assert db.rows_to_list() == [0, 2]
        assert db.to_list() == [0, 1, 3]


class TestCheckify:
    def test_validate_coo_under_jit(self):
        import jax
        from jax.experimental import checkify
        from spsparse_tpu.core.validate import validate_coo

        good = build((4, 4), [((1, 2), 3.0)])
        f = jax.jit(checkify.checkify(validate_coo))
        err, _ = f(good)
        err.throw()  # no error

        import dataclasses
        bad = dataclasses.replace(
            good, indices=good.indices.at[0, 1].set(9))
        err, _ = f(bad)
        with pytest.raises(Exception):
            err.throw()


class TestFormatRoundTrips:
    def test_matmul_sugar(self, rng):
        b1 = CooBuilder((6, 5), dtype=np.float64)
        b1.add_many(np.stack([rng.integers(0, 6, 12), rng.integers(0, 5, 12)], 1),
                    rng.uniform(-1, 1, 12))
        b2 = CooBuilder((5, 4), dtype=np.float64)
        b2.add_many(np.stack([rng.integers(0, 5, 10), rng.integers(0, 4, 10)], 1),
                    rng.uniform(-1, 1, 10))
        A, B = b1.build(), b2.build()
        C = A @ B
        np.testing.assert_allclose(np.asarray(C.to_dense()),
                                   np.asarray(A.to_dense()) @
                                   np.asarray(B.to_dense()), rtol=1e-12)
        x = rng.uniform(-1, 1, 5)
        np.testing.assert_allclose(np.asarray(A @ x),
                                   np.asarray(A.to_dense()) @ x, rtol=1e-12)

    def test_ell_and_dia_to_coo(self, rng):
        from spsparse_tpu.core.dia import to_dia, dia_to_coo
        b = CooBuilder((8, 8), dtype=np.float64)
        for i in range(8):
            b.add((i, i), float(i + 1))
            if i >= 2:
                b.add((i, i - 2), 0.5)
        A = b.build()
        ell_back = to_ell(A).to_coo()
        np.testing.assert_allclose(np.asarray(ell_back.to_dense()),
                                   np.asarray(A.to_dense()), rtol=1e-12)
        dia_back = dia_to_coo(to_dia(A))
        np.testing.assert_allclose(np.asarray(dia_back.to_dense()),
                                   np.asarray(A.to_dense()), rtol=1e-12)


class TestUtils:
    def test_event_log(self):
        from spsparse_tpu.utils.trace import (enable_event_log, get_event_log)
        from spsparse_tpu import consolidate
        enable_event_log(True)
        arr = build((4, 4), [((1, 2), 3.0), ((1, 2), 4.0)])
        consolidate(arr, (0, 1))
        log = get_event_log()
        enable_event_log(False)
        assert any(e["op"] == "spsparse.consolidate" for e in log)

    def test_roofline_models(self):
        from spsparse_tpu.utils.roofline import (
            spmv_dia_stats, spmv_ell_stats, spmv_csr_stats, spmm_ell_stats,
            spgemm_esc_stats, roofline)
        s = spmv_dia_stats(11, 1 << 20)
        assert s.nnz == 11 * (1 << 20)
        assert s.bytes_moved == s.nnz * 4 + (1 << 20) * 8
        r = roofline(s, 1e-3, device_kind="NVIDIA H200")
        assert r["nnz_per_s"] == s.nnz / 1e-3
        assert 0 < r["pct_of_roofline"]
        for st in (spmv_ell_stats(100, 8), spmv_csr_stats(1000, 100),
                   spmm_ell_stats(100, 8, 128), spgemm_esc_stats(100, 100, 400, 150)):
            assert st.bytes_moved > 0 and st.flops > 0

    def test_error_handler_pluggable(self):
        from spsparse_tpu import set_error_handler, SpSparseError
        calls = []
        def handler(code, msg):
            calls.append((code, msg))
            raise SpSparseError("custom: " + msg)
        set_error_handler(handler)
        try:
            b = CooBuilder((2,))
            with pytest.raises(SpSparseError, match="custom:"):
                b.add((5,), 1.0)
            assert calls and calls[0][0] == -1
        finally:
            set_error_handler(None)

    def test_dump_stack_on_error(self, capsys):
        # Everytrace-hook analogue (reference spsparse.cpp:21-23): stack
        # dump to stderr before the structured exception propagates.
        from spsparse_tpu import set_dump_stack_on_error, SpSparseError
        set_dump_stack_on_error(True)
        try:
            b = CooBuilder((2,))
            with pytest.raises(SpSparseError):
                b.add((5,), 1.0)
            err = capsys.readouterr().err
            assert "test_dump_stack_on_error" in err  # our frame is in it
        finally:
            set_dump_stack_on_error(False)
        b = CooBuilder((2,))
        with pytest.raises(SpSparseError):
            b.add((5,), 1.0)
        assert "test_dump_stack_on_error" not in capsys.readouterr().err


class TestPropertyRandomized:
    """Randomized differential testing of consolidate against the numpy
    oracle across shapes, ranks, policies, and zero/NaN patterns."""

    @pytest.mark.parametrize("trial", range(20))
    def test_consolidate_vs_numpy_oracle(self, trial):
        from spsparse_tpu.native import _numpy_consolidate
        rng = np.random.default_rng(1000 + trial)
        rank = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(2, 12)) for _ in range(rank))
        n = int(rng.integers(0, 60))
        idx = np.stack([rng.integers(0, s, n) for s in shape], axis=1)
        vals = rng.uniform(-1, 1, n)
        vals[rng.uniform(size=n) < 0.15] = 0.0
        vals[rng.uniform(size=n) < 0.1] = np.nan
        policy = list(DuplicatePolicy)[int(rng.integers(0, 3))]
        zero_nan = bool(rng.integers(0, 2))
        order = tuple(rng.permutation(rank).tolist())

        b = CooBuilder(shape, dtype=np.float64)
        if n:
            b.add_many(idx, vals)
        got = consolidate(b.build(), order, policy, zero_nan)
        gi, gv = got.to_lists()

        keep = vals != 0
        if zero_nan:
            keep &= ~np.isnan(vals)
        ei, ev = _numpy_consolidate(
            idx.astype(np.int64), vals, shape, order, policy, zero_nan)
        assert gi == [tuple(r) for r in ei.tolist()]
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(ev))
        np.testing.assert_allclose(np.nan_to_num(gv), np.nan_to_num(ev),
                                   rtol=1e-13)
        assert got.sort_order == order


class TestInt64Extents:
    """Extents past 2^31 use int64 indices end-to-end (reference parity:
    IndexT is int64 and the NetCDF schema stores int64,
    /root/reference/slib/spsparse/netcdf.hpp:102)."""

    def test_default_dtype_selection(self):
        from spsparse_tpu.core.coo import default_index_dtype
        assert default_index_dtype((100, 100)) == jnp.int32
        assert default_index_dtype((4, 2**31)) == jnp.int64
        assert default_index_dtype(()) == jnp.int32

    def test_consolidate_and_netcdf_round_trip(self, tmp_path):
        from spsparse_tpu.io import load_netcdf, save_netcdf
        big = 2**33 + 5
        b = CooBuilder((4, big))
        assert b._idx.dtype == np.int64
        b.add((1, 2**32 + 7), 1.5)
        b.add((0, big - 1), 2.5)
        b.add((1, 2**32 + 7), 3.0)  # duplicate — merges under ADD
        A = b.build()
        assert A.index_dtype == jnp.int64
        C = A.consolidate()
        idx, vals = C.to_lists()
        assert idx == [(0, big - 1), (1, 2**32 + 7)]
        assert vals == [2.5, 4.5]

        path = tmp_path / "big.nc"
        save_netcdf(path, {"A": C})
        B = load_netcdf(path, "A", rank=2)
        assert B.index_dtype == jnp.int64
        assert B.shape == (4, big)
        assert B.to_lists() == C.to_lists()

    def test_from_arrays_upcasts_int32_input(self):
        A = SparseCOO.from_arrays(
            np.array([[0, 0]], np.int32), np.array([1.0]), (2, 2**31 + 2))
        assert A.index_dtype == jnp.int64


class TestMergeMethods:
    """The compact (sort-based) and scatter merge formulations agree; the
    scatter path keeps bitwise left-to-right ADD accumulation."""

    def _sorted_stream(self, rng, n=500, nrows=12, ncols=9):
        idx = np.stack([rng.integers(0, nrows, n),
                        rng.integers(0, ncols, n)], 1).astype(np.int32)
        order = np.lexsort((np.arange(n), idx[:, 1], idx[:, 0]))
        idx = idx[order]
        vals = rng.uniform(-1, 1, n)
        return idx, vals, (nrows, ncols)

    @pytest.mark.parametrize("policy", list(DuplicatePolicy))
    def test_methods_agree(self, rng, policy):
        from spsparse_tpu.core.consolidate import merge_sorted_entries
        idx, vals, shape = self._sorted_stream(rng)
        cols = (jnp.asarray(idx[:, 0]), jnp.asarray(idx[:, 1]))
        valid = jnp.ones((idx.shape[0],), bool)
        a = merge_sorted_entries(cols, jnp.asarray(vals), valid, shape=shape,
                                 duplicate_policy=policy, cap=256,
                                 method="compact")
        b = merge_sorted_entries(cols, jnp.asarray(vals), valid, shape=shape,
                                 duplicate_policy=policy, cap=256,
                                 method="scatter")
        assert int(a.nnz) == int(b.nnz)
        np.testing.assert_array_equal(np.asarray(a.indices),
                                      np.asarray(b.indices))
        np.testing.assert_allclose(np.asarray(a.vals), np.asarray(b.vals),
                                   rtol=1e-10)
        if policy != DuplicatePolicy.ADD:
            # first/last selection moves values untouched: bitwise equal
            np.testing.assert_array_equal(np.asarray(a.vals),
                                          np.asarray(b.vals))

    def test_compact_add_precision_is_per_run(self):
        # Regression (round 2): the compact ADD merge once differenced one
        # global cumsum, losing O(total_sum * eps) per run — on this f32
        # stream (total ~32k) single-value runs came back off by ~4e-3.
        # The segmented scan returns untouched values bitwise for
        # single-entry runs, regardless of the global prefix magnitude.
        from spsparse_tpu.core.consolidate import merge_sorted_entries
        n, ncols = 1 << 16, 1 << 8
        idx0 = jnp.asarray(np.arange(n) // ncols, jnp.int32)
        idx1 = jnp.asarray(np.arange(n) % ncols, jnp.int32)
        vals = jnp.asarray(
            np.random.default_rng(3).uniform(0.25, 0.75, n), jnp.float32)
        out = merge_sorted_entries((idx0, idx1), vals,
                                   jnp.ones((n,), bool),
                                   shape=(n // ncols, ncols),
                                   duplicate_policy=DuplicatePolicy.ADD,
                                   cap=n, method="compact")
        assert int(out.nnz) == n
        np.testing.assert_array_equal(np.asarray(out.vals),
                                      np.asarray(vals))

    def test_scatter_add_is_left_to_right_exact(self, rng):
        from spsparse_tpu.core.consolidate import merge_sorted_entries
        idx, vals, shape = self._sorted_stream(rng, n=300, nrows=3, ncols=2)
        cols = (jnp.asarray(idx[:, 0]), jnp.asarray(idx[:, 1]))
        valid = jnp.ones((idx.shape[0],), bool)
        out = merge_sorted_entries(cols, jnp.asarray(vals), valid,
                                   shape=shape,
                                   duplicate_policy=DuplicatePolicy.ADD,
                                   cap=64, method="scatter")
        oidx, ovals = out.to_lists()
        # numpy oracle: strict left-to-right per-run accumulation
        sums = {}
        order = []
        for (i, j), v in zip(map(tuple, idx), vals):
            if (i, j) not in sums:
                sums[(i, j)] = np.float64(0)
                order.append((i, j))
            sums[(i, j)] = sums[(i, j)] + v
        order.sort()
        assert oidx == order
        np.testing.assert_array_equal(ovals, [float(sums[k]) for k in order])

    def test_compact_nonfinite_semantics(self):
        from spsparse_tpu.core.consolidate import merge_sorted_entries
        # runs: (0,0): [1, nan] -> nan; (0,1): [inf, 1] -> inf;
        # (1,0): [inf, -inf] -> nan; (1,1): [2, 3] -> 5
        cols = (jnp.asarray([0, 0, 0, 0, 1, 1, 1, 1], jnp.int32),
                jnp.asarray([0, 0, 1, 1, 0, 0, 1, 1], jnp.int32))
        vals = jnp.asarray([1.0, np.nan, np.inf, 1.0, np.inf, -np.inf,
                            2.0, 3.0])
        valid = jnp.ones((8,), bool)
        out = merge_sorted_entries(cols, vals, valid, shape=(2, 2),
                                   duplicate_policy=DuplicatePolicy.ADD,
                                   cap=8, method="compact")
        v = np.asarray(out.vals)[:4]
        assert np.isnan(v[0])
        assert v[1] == np.inf
        assert np.isnan(v[2])
        assert v[3] == 5.0


class TestCoreReviewRegressions:
    def test_join_padding_positions_drop_cleanly(self):
        # pos padding must be each stream's OWN length: gathering stream-2
        # data at padded slots used to read live entries when stream 2's
        # buffer was longer than stream 1's.
        from spsparse_tpu import join2
        k1 = jnp.asarray([1, 3, 5, 9])
        k2 = jnp.asarray([1, 2, 3, 5, 6, 7, 8, 9])
        r = join2(k1, 4, k2, 8, sentinel=100)
        vals2 = jnp.asarray([10., 20., 30., 40., 50., 60., 70., 80.])
        got = jnp.take(vals2, r.pos[1], mode="fill", fill_value=-1.0)
        live = np.asarray(r.valid_mask())
        assert int(r.n_match) == 4
        np.testing.assert_array_equal(np.asarray(got)[live],
                                      [10., 30., 40., 80.])
        assert (np.asarray(got)[~live] == -1.0).all()

    def test_join_cap_clamps_n_match(self):
        from spsparse_tpu import join2
        k = jnp.asarray([1, 2, 3, 4])
        r = join2(k, 4, k, 4, sentinel=9, cap=2)
        assert int(r.n_match) == 2 and r.pos[0].shape == (2,)

    def test_partial_sort_order_still_merges_full_tuples(self):
        # Sorting by dim 0 alone used to leave duplicate (0,5) entries
        # separated by (0,3) and unmerged — yet stamped "sorted".
        b = CooBuilder((2, 8), dtype=np.float64)
        b.add((0, 5), 1.0)
        b.add((0, 3), 2.0)
        b.add((0, 5), 4.0)
        got = consolidate(b.build(), (0,))
        gi, gv = got.to_lists()
        assert gi == [(0, 3), (0, 5)]
        np.testing.assert_array_equal(gv, [2.0, 5.0])
        assert got.sort_order == (0, 1)   # completed order, truthful

    def test_from_dense_undersized_cap_clamps(self):
        d = jnp.asarray([[1., 2., 3.], [4., 5., 6.]])
        A = SparseCOO.from_dense(d, cap=4)
        assert int(A.nnz) == 4 <= A.cap

    def test_from_arrays_empty_keeps_sort_order(self):
        A = SparseCOO.from_arrays(np.zeros((0, 2), np.int32),
                                  np.zeros(0), (2, 2), sort_order=(0, 1))
        assert A.sort_order == (0, 1)

    def test_transpose_relabels_sort_order(self):
        from spsparse_tpu import to_csr
        b = CooBuilder((4, 6), dtype=np.float64)
        b.add((1, 2), 3.0)
        b.add((0, 4), 1.0)
        A = b.build().consolidate((1, 0))   # CSC-ready
        T = A.transposed((1, 0))
        assert T.sort_order == (0, 1)       # relabeled, still sorted
        # ... so CSR of A^T costs no consolidate and matches the oracle.
        csr = to_csr(A, transpose=True)
        np.testing.assert_allclose(
            np.asarray(csr.to_coo().to_dense()),
            np.asarray(A.to_dense()).T, rtol=1e-12)


class TestOperatorSugar:
    def test_T_and_matmul(self, rng):
        b = CooBuilder((4, 6), dtype=np.float64)
        idx = np.stack([rng.integers(0, 4, 9), rng.integers(0, 6, 9)], 1)
        b.add_many(idx, rng.uniform(-1, 1, 9))
        A = b.build()
        Ad = np.asarray(A.to_dense())
        np.testing.assert_allclose(np.asarray(A.T.to_dense()), Ad.T,
                                   rtol=1e-12)
        # sparse @ sparse
        G = A @ A.T
        np.testing.assert_allclose(np.asarray(G.to_dense()), Ad @ Ad.T,
                                   rtol=1e-12)
        # sparse @ dense vector / block
        x = rng.uniform(-1, 1, 6)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(x)), Ad @ x,
                                   rtol=1e-12)
        X = rng.uniform(-1, 1, (6, 3))
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(X)), Ad @ X,
                                   rtol=1e-12)

    def test_T_requires_rank2(self):
        b = CooBuilder((4,), dtype=np.float64)
        b.add((1,), 1.0)
        with pytest.raises(SpSparseError):
            _ = b.build().T

    def test_matmul_single_definition_and_1d_routing(self, rng):
        """VERDICT r4 weak #8: ``__matmul__`` was defined twice, the
        second silently shadowing the richer CSR-routing version. Pin
        that exactly one definition remains and that the 1-D operand
        routes through SpMV (1-D result), 2-D through SpMM."""
        import ast
        import inspect

        from spsparse_tpu.core import coo as coo_mod

        tree = ast.parse(inspect.getsource(coo_mod))
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "SparseCOO")
        defs = [n for n in cls.body if isinstance(n, ast.FunctionDef)
                and n.name == "__matmul__"]
        assert len(defs) == 1

        b = CooBuilder((4, 6), dtype=np.float64)
        b.add_many(np.stack([rng.integers(0, 4, 9),
                             rng.integers(0, 6, 9)], 1),
                   rng.uniform(-1, 1, 9))
        A = b.build()
        assert (A @ jnp.ones(6)).ndim == 1
        assert (A @ jnp.ones((6, 2))).shape == (4, 2)
        assert isinstance(A @ A.T, SparseCOO)
