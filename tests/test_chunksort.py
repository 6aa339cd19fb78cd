"""Compile-bounded chunked sorting (core.chunksort).

These run with tiny chunk sizes so the multi-chunk code paths execute at
test scale; the compile-time bound itself is a property of full-size
shapes, not of these tests.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu.core.chunksort import (chunked_compact_select,
                                         chunked_sort_unique)
from spsparse_tpu.core.consolidate import compact_select


class TestChunkedCompactSelect:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("chunk", [7, 64, 1 << 20])
    def test_matches_unchunked(self, seed, chunk):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 400))
        sel = jnp.asarray(rng.uniform(size=n) < 0.4)
        a = jnp.asarray(rng.integers(0, 1000, n).astype(np.int32))
        v = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))
        cap = n
        ref, nref = compact_select(sel, (a, v), cap_out=cap)
        got, ngot = chunked_compact_select(sel, (a, v), cap_out=cap,
                                           chunk=chunk)
        assert int(ngot) == int(nref)
        m = int(nref)
        np.testing.assert_array_equal(np.asarray(got[0])[:m],
                                      np.asarray(ref[0])[:m])
        np.testing.assert_array_equal(np.asarray(got[1])[:m],
                                      np.asarray(ref[1])[:m])

    def test_order_preserved_and_jittable(self):
        rng = np.random.default_rng(9)
        n = 300
        sel = jnp.asarray(rng.uniform(size=n) < 0.5)
        pos = jnp.arange(n, dtype=jnp.int32)
        f = jax.jit(lambda s, p: chunked_compact_select(
            s, (p,), cap_out=n, chunk=17))
        (got,), ng = f(sel, pos)
        expect = np.asarray(pos)[np.asarray(sel)]
        np.testing.assert_array_equal(np.asarray(got)[: int(ng)], expect)
        assert (np.diff(np.asarray(got)[: int(ng)]) > 0).all()

    def test_none_and_all_selected(self):
        n = 50
        pos = jnp.arange(n, dtype=jnp.int32)
        (got,), ng = chunked_compact_select(
            jnp.zeros(n, bool), (pos,), cap_out=n, chunk=8)
        assert int(ng) == 0
        (got,), ng = chunked_compact_select(
            jnp.ones(n, bool), (pos,), cap_out=n, chunk=8)
        assert int(ng) == n
        np.testing.assert_array_equal(np.asarray(got), np.asarray(pos))

    def test_cap_smaller_than_n(self):
        n, cap = 100, 16
        sel = jnp.asarray(np.arange(n) % 3 == 0)
        pos = jnp.arange(n, dtype=jnp.int32)
        (got,), ng = chunked_compact_select(sel, (pos,), cap_out=cap,
                                            chunk=9)
        keep = np.arange(n)[np.asarray(sel)][:cap]
        np.testing.assert_array_equal(np.asarray(got)[: len(keep)], keep)


class TestChunkedSortUnique:
    @pytest.mark.parametrize("seed", range(5))
    @pytest.mark.parametrize("chunk", [13, 100, 1 << 20])
    def test_matches_argsort(self, seed, chunk):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(10, 800))
        word = rng.permutation(n * 3)[:n].astype(np.int64)  # unique
        pay = rng.uniform(-1, 1, n).astype(np.float32)
        w, (p,) = chunked_sort_unique(jnp.asarray(word),
                                      (jnp.asarray(pay),), chunk=chunk)
        order = np.argsort(word)
        np.testing.assert_array_equal(np.asarray(w), word[order])
        np.testing.assert_array_equal(np.asarray(p), pay[order])

    def test_skewed_keys_with_position_bits(self):
        # heavy duplicate keys become unique once position bits are
        # appended — the caller contract — and PSRS buckets stay in
        # bounds deterministically
        rng = np.random.default_rng(3)
        n = 500
        key = np.where(rng.uniform(size=n) < 0.8, 7, rng.integers(0, 50, n))
        word = key.astype(np.int64) * (1 << 10) + np.arange(n)
        w, _ = chunked_sort_unique(jnp.asarray(word), (), chunk=31)
        np.testing.assert_array_equal(np.asarray(w), np.sort(word))

    def test_jittable_multi_payload(self):
        rng = np.random.default_rng(11)
        n = 257
        word = rng.permutation(2 * n)[:n].astype(np.int64)
        p1 = rng.uniform(size=n).astype(np.float32)
        p2 = np.arange(n, dtype=np.int32)
        f = jax.jit(lambda w, a, b: chunked_sort_unique(
            w, (a, b), chunk=64))
        w, (a, b) = f(jnp.asarray(word), jnp.asarray(p1), jnp.asarray(p2))
        order = np.argsort(word)
        np.testing.assert_array_equal(np.asarray(w), word[order])
        np.testing.assert_allclose(np.asarray(a), p1[order])
        np.testing.assert_array_equal(np.asarray(b), p2[order])

    def test_sorted_and_reverse_inputs(self):
        n = 200
        for word in (np.arange(n), np.arange(n)[::-1].copy()):
            w, _ = chunked_sort_unique(
                jnp.asarray(word.astype(np.int64)), (), chunk=16)
            np.testing.assert_array_equal(np.asarray(w), np.arange(n))


class TestConsolidateChunkedIntegration:
    """consolidate() routed through the chunked sort/compaction must
    match the direct path exactly (same policies, same stability)."""

    @pytest.mark.parametrize("policy", ["ADD", "LEAVE_ALONE", "REPLACE"])
    @pytest.mark.parametrize("seed", range(3))
    def test_matches_direct(self, monkeypatch, policy, seed):
        from spsparse_tpu import CooBuilder, DuplicatePolicy, consolidate
        from spsparse_tpu.core import chunksort
        rng = np.random.default_rng(seed)
        nnz = 700
        b = CooBuilder((37, 53), dtype=np.float64)
        idx = np.stack([rng.integers(0, 37, nnz),
                        rng.integers(0, 53, nnz)], 1)
        b.add_many(idx, rng.uniform(-1, 1, nnz))
        A = b.build()
        pol = getattr(DuplicatePolicy, policy)
        ref = consolidate(A, None, pol, False)
        monkeypatch.setattr(chunksort, "CHUNK_ELEMS", 64)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 128)
        got = consolidate(A, None, pol, False)
        assert int(got.nnz) == int(ref.nnz)
        m = int(ref.nnz)
        np.testing.assert_array_equal(np.asarray(got.indices)[:m],
                                      np.asarray(ref.indices)[:m])
        np.testing.assert_array_equal(np.asarray(got.vals)[:m],
                                      np.asarray(ref.vals)[:m])

    def test_nonfinite_add_semantics(self, monkeypatch):
        from spsparse_tpu import CooBuilder, DuplicatePolicy, consolidate
        from spsparse_tpu.core import chunksort
        monkeypatch.setattr(chunksort, "CHUNK_ELEMS", 32)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 64)
        b = CooBuilder((8, 8), dtype=np.float64)
        for _ in range(3):
            b.add((1, 1), np.inf)
        b.add((2, 2), np.nan)
        b.add((2, 2), 1.0)
        b.add((3, 3), np.inf)
        b.add((3, 3), -np.inf)
        for i in range(60):
            b.add((4, (i % 7) + 1), 0.5)
        A = b.build()
        out = consolidate(A, None, DuplicatePolicy.ADD, False)
        d = np.asarray(out.to_dense())
        assert d[1, 1] == np.inf
        assert np.isnan(d[2, 2])
        assert np.isnan(d[3, 3])

    def test_multiply_chain_chunked(self, monkeypatch):
        # the ESC SpGEMM compress phase shares fused_sort_merge — run the
        # reference-oracle chain through the chunked route
        from spsparse_tpu import CooBuilder
        from spsparse_tpu.core import chunksort
        from spsparse_tpu.ops import multiply
        monkeypatch.setattr(chunksort, "CHUNK_ELEMS", 128)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 256)
        rng = np.random.default_rng(5)
        ba = CooBuilder((20, 30), dtype=np.float64)
        bb = CooBuilder((30, 25), dtype=np.float64)
        for _ in range(200):
            ba.add((int(rng.integers(20)), int(rng.integers(30))),
                   float(rng.uniform(-1, 1)))
        for _ in range(180):
            bb.add((int(rng.integers(30)), int(rng.integers(25))),
                   float(rng.uniform(-1, 1)))
        A, B = ba.build(), bb.build()
        C = multiply(1.0, A, B)
        expect = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())
        np.testing.assert_allclose(np.asarray(C.to_dense()), expect,
                                   rtol=1e-12, atol=1e-12)


class TestAutoRoutingGlue:
    """ADVICE r4: the production ENGAGE_ELEMS routing glue (threshold,
    x64 gate, exts_key_plan_max bit check) — not just the chunked
    primitives — must be pinned end to end. Spies assert the chunked
    route actually engaged (or deliberately did not)."""

    def _build(self, nnz=600, seed=0, dtype=np.float64):
        from spsparse_tpu import CooBuilder
        rng = np.random.default_rng(seed)
        b = CooBuilder((41, 59), dtype=dtype)
        b.add_many(np.stack([rng.integers(0, 41, nnz),
                             rng.integers(0, 59, nnz)], 1),
                   rng.uniform(-1, 1, nnz).astype(dtype))
        return b.build()

    def test_x64_route_uses_chunked_primary_sort(self, monkeypatch):
        from spsparse_tpu import DuplicatePolicy, consolidate
        from spsparse_tpu.core import chunksort
        A = self._build()
        ref = consolidate(A, None, DuplicatePolicy.ADD, False)
        calls = {"sort": 0, "compact": 0}
        orig_sort = chunksort.chunked_sort_unique
        orig_comp = chunksort.chunked_compact_select

        def spy_sort(*a, **k):
            calls["sort"] += 1
            return orig_sort(*a, **k)

        def spy_comp(*a, **k):
            calls["compact"] += 1
            return orig_comp(*a, **k)

        monkeypatch.setattr(chunksort, "chunked_sort_unique", spy_sort)
        monkeypatch.setattr(chunksort, "chunked_compact_select", spy_comp)
        monkeypatch.setattr(chunksort, "CHUNK_ELEMS", 64)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 128)
        assert jax.config.jax_enable_x64  # conftest enables x64
        got = consolidate(A, None, DuplicatePolicy.ADD, False)
        # with x64 on, the PRIMARY sort routes through the chunked PSRS
        assert calls["sort"] >= 1
        assert calls["compact"] >= 1
        m = int(ref.nnz)
        assert int(got.nnz) == m
        np.testing.assert_array_equal(np.asarray(got.indices)[:m],
                                      np.asarray(ref.indices)[:m])
        np.testing.assert_array_equal(np.asarray(got.vals)[:m],
                                      np.asarray(ref.vals)[:m])

    def test_non_x64_route_chunks_compaction_only(self, monkeypatch):
        """Without x64 the composite (key, position) word cannot be
        built: the primary sort must stay monolithic (stable lax.sort)
        while compaction still chunks — and results stay exact."""
        from spsparse_tpu import DuplicatePolicy, consolidate
        from spsparse_tpu.core import chunksort
        A = self._build(dtype=np.float32)
        ref = consolidate(A, None, DuplicatePolicy.ADD, False)
        calls = {"sort": 0, "compact": 0}
        orig_sort = chunksort.chunked_sort_unique
        orig_comp = chunksort.chunked_compact_select

        def spy_sort(*a, **k):
            calls["sort"] += 1
            return orig_sort(*a, **k)

        def spy_comp(*a, **k):
            calls["compact"] += 1
            return orig_comp(*a, **k)

        monkeypatch.setattr(chunksort, "chunked_sort_unique", spy_sort)
        monkeypatch.setattr(chunksort, "chunked_compact_select", spy_comp)
        monkeypatch.setattr(chunksort, "CHUNK_ELEMS", 64)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 128)
        with jax.enable_x64(False):
            A32 = self._build(dtype=np.float32)
            got = consolidate(A32, None, DuplicatePolicy.ADD, False)
            assert calls["sort"] == 0      # x64 gate held
            assert calls["compact"] >= 1   # compaction still chunked
            m = int(got.nnz)
        assert m == int(ref.nnz)
        np.testing.assert_array_equal(np.asarray(got.indices)[:m],
                                      np.asarray(ref.indices)[:m])
        np.testing.assert_allclose(np.asarray(got.vals)[:m],
                                   np.asarray(ref.vals)[:m], rtol=1e-6)

    def test_key_plan_bit_check_blocks_chunked_sort(self, monkeypatch):
        """When extents are too wide for (key << pos_bits) to fit 62
        bits, the composite-key PSRS must NOT engage (fallback sort)."""
        from spsparse_tpu.core import chunksort
        from spsparse_tpu.core.consolidate import _stable_word_sort
        calls = {"sort": 0}
        orig_sort = chunksort.chunked_sort_unique

        def spy_sort(*a, **k):
            calls["sort"] += 1
            return orig_sort(*a, **k)

        monkeypatch.setattr(chunksort, "chunked_sort_unique", spy_sort)
        monkeypatch.setattr(chunksort, "ENGAGE_ELEMS", 32)
        n = 100
        rng = np.random.default_rng(2)
        w = jnp.asarray(rng.integers(0, 1 << 40, n).astype(np.int64))
        v = jnp.asarray(rng.uniform(size=n).astype(np.float32))
        # plan max so large the shifted composite cannot fit 62 bits
        out = _stable_word_sort((w,), (v,), exts_key_plan_max=1 << 60)
        assert calls["sort"] == 0
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      np.sort(np.asarray(w)))
        # and a narrow plan DOES engage
        out2 = _stable_word_sort((w,), (v,), exts_key_plan_max=1 << 41)
        assert calls["sort"] == 1
        np.testing.assert_array_equal(np.asarray(out2[0]),
                                      np.sort(np.asarray(w)))


class TestChunkedScans:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("chunk", [9, 100, 1 << 20])
    def test_cumsum_matches(self, seed, chunk):
        from spsparse_tpu.core.chunksort import chunked_cumsum
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 700))
        x = rng.integers(-5, 6, n).astype(np.int64)
        got = chunked_cumsum(jnp.asarray(x), chunk=chunk)
        np.testing.assert_array_equal(np.asarray(got), np.cumsum(x))

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("chunk", [13, 64, 1 << 20])
    def test_segmented_matches(self, seed, chunk):
        from spsparse_tpu.core.chunksort import (chunked_segmented_cumsum,
                                                 _seg_scan)
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(5, 900))
        x = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float64))
        st = rng.uniform(size=n) < rng.choice([0.02, 0.3, 0.9])
        st[0] = bool(rng.integers(2))
        got = chunked_segmented_cumsum(x, jnp.asarray(st), chunk=chunk)
        want = np.asarray(_seg_scan(x, jnp.asarray(st)))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)

    def test_segment_spanning_many_chunks(self):
        from spsparse_tpu.core.chunksort import chunked_segmented_cumsum
        n = 200
        x = jnp.ones(n)
        st = np.zeros(n, bool)
        st[0] = True                    # one segment spanning all chunks
        got = chunked_segmented_cumsum(x, jnp.asarray(st), chunk=16)
        np.testing.assert_allclose(np.asarray(got), np.arange(1, n + 1))
        st2 = np.zeros(n, bool)         # no start at all: same result
        got2 = chunked_segmented_cumsum(x, jnp.asarray(st2), chunk=16)
        np.testing.assert_allclose(np.asarray(got2), np.arange(1, n + 1))


class TestChunkedForwardFill:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("chunk", [11, 64, 1 << 20])
    def test_matches_direct(self, seed, chunk):
        from spsparse_tpu.core.chunksort import (chunked_forward_fill,
                                                 _fill_scan)
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 800))
        m = rng.uniform(size=n) < rng.choice([0.0, 0.05, 0.4])
        p1 = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))
        p2 = jnp.asarray(rng.integers(0, 99, n).astype(np.int32))
        got = chunked_forward_fill(jnp.asarray(m), (p1, p2), chunk=chunk)
        want = _fill_scan(jnp.asarray(m), (p1, p2))[1:]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    def test_unmarked_prefix_gets_position_zero(self):
        from spsparse_tpu.core.chunksort import chunked_forward_fill
        n = 100
        m = np.zeros(n, bool)
        m[57] = True
        p = jnp.asarray(np.arange(100, 200).astype(np.int32))
        (got,) = chunked_forward_fill(jnp.asarray(m), (p,), chunk=16)
        want = np.where(np.arange(n) < 57, 100, 157)
        np.testing.assert_array_equal(np.asarray(got), want)
