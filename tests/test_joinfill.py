"""core.joinfill: sort-based join primitives + the join ESC expansion.

The join path is an alternative ESC expansion to the per-element gather
(the default on every backend); these tests exercise it explicitly and
pin equivalence with the gather formulation.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder
from spsparse_tpu.core.joinfill import forward_fill_marked, merge_fill_compact
from spsparse_tpu.core.structure import to_csr
from spsparse_tpu.ops.multiply import expand_products_raw, multiply


@pytest.fixture
def rng():
    return np.random.default_rng(7)


class TestForwardFill:
    def test_carries_last_marked(self):
        marker = jnp.asarray([True, False, False, True, False])
        vals = jnp.asarray([10, 0, 0, 40, 0], jnp.int32)
        (out,) = forward_fill_marked(marker, (vals,))
        np.testing.assert_array_equal(out, [10, 10, 10, 40, 40])

    def test_before_first_mark_takes_position_zero(self):
        # positions before the first mark receive position 0's payload —
        # merge_fill_compact relies on this for unmatched-query zero fill
        marker = jnp.asarray([False, False, True, False])
        vals = jnp.asarray([7, 8, 9, 0], jnp.int32)
        (out,) = forward_fill_marked(marker, (vals,))
        np.testing.assert_array_equal(out, [7, 7, 9, 9])

    def test_multiple_payloads_random(self, rng):
        n = 257
        mk = rng.integers(0, 2, n).astype(bool)
        mk[0] = True  # pin the defined regime (see position-zero test)
        marker = jnp.asarray(mk)
        a = rng.integers(0, 1000, n).astype(np.int32)
        b = rng.uniform(-1, 1, n).astype(np.float32)
        oa, ob = forward_fill_marked(marker, (jnp.asarray(a),
                                              jnp.asarray(b)))
        ea, eb = a.copy(), b.copy()
        for i in range(1, n):
            if not marker[i]:
                if any(marker[:i + 1][::-1]):
                    last = max(j for j in range(i + 1) if marker[j])
                    ea[i], eb[i] = a[last], b[last]
        np.testing.assert_array_equal(oa, ea)
        np.testing.assert_array_equal(ob, eb)


class TestMergeFillCompact:
    def test_table_lookup(self, rng):
        # entries = dense table keyed 0..9; queries hit exact keys
        table = rng.uniform(0, 1, 10).astype(np.float32)
        keys_q = rng.integers(0, 10, 31).astype(np.int32)
        (filled,), (orig,) = merge_fill_compact(
            jnp.arange(10, dtype=jnp.int32), (jnp.asarray(table),),
            jnp.asarray(keys_q), (jnp.asarray(keys_q),), 31, key_bound=11)
        order = np.argsort(keys_q, kind="stable")
        np.testing.assert_array_equal(np.asarray(orig), keys_q[order])
        np.testing.assert_array_equal(np.asarray(filled), table[keys_q[order]])

    def test_last_entry_leq_semantics(self):
        # entries at keys 2 and 5; queries at 1, 2, 4, 7
        (filled,), (qid,) = merge_fill_compact(
            jnp.asarray([2, 5], jnp.int32),
            (jnp.asarray([20, 50], jnp.int32),),
            jnp.asarray([1, 2, 4, 7], jnp.int32),
            (jnp.asarray([0, 1, 2, 3], jnp.int32),), 4, key_bound=8)
        # query 1 precedes every entry -> zero fill; 2->20, 4->20, 7->50
        np.testing.assert_array_equal(np.asarray(qid), [0, 1, 2, 3])
        np.testing.assert_array_equal(np.asarray(filled), [0, 20, 20, 50])

    def test_stable_among_equal_query_keys(self):
        (_,), (qid,) = merge_fill_compact(
            jnp.asarray([0], jnp.int32), (jnp.asarray([1], jnp.int32),),
            jnp.asarray([3, 3, 3, 1], jnp.int32),
            (jnp.asarray([10, 11, 12, 13], jnp.int32),), 4, key_bound=4)
        np.testing.assert_array_equal(np.asarray(qid), [13, 10, 11, 12])


class TestJoinExpansion:
    def _case(self, seed, sj=False):
        r = np.random.default_rng(seed)
        m, K, n = int(r.integers(3, 12)), int(r.integers(3, 12)), \
            int(r.integers(3, 12))
        ba = CooBuilder((m, K), dtype=np.float64)
        for _ in range(int(r.integers(0, 40))):
            ba.add((int(r.integers(m)), int(r.integers(K))),
                   float(r.uniform(-1, 1)))
        bb = CooBuilder((K, n), dtype=np.float64)
        for _ in range(int(r.integers(0, 40))):
            bb.add((int(r.integers(K)), int(r.integers(n))),
                   float(r.uniform(-1, 1)))
        A = ba.build(cap=64).consolidate((0, 1))
        B = bb.build(cap=64).consolidate((0, 1))
        bc = to_csr(B)
        rl = bc.row_ptr[1:] - bc.row_ptr[:-1]
        pres = jnp.asarray(r.integers(0, 2, K + 1).astype(bool)) if sj \
            else None
        sv = jnp.asarray(r.uniform(0.5, 1.5, K + 1)) if sj else None
        return (A.indices[:, 0], A.indices[:, 1], A.vals, A.valid_mask(),
                bc.row_ptr[:-1], rl, bc.cols, bc.vals, bc.ncols, bc.nrows,
                pres, sv, 256)

    @staticmethod
    def _norm(o):
        i, j, v, val = (np.asarray(x) for x in o)
        sel = val.astype(bool)
        return sorted(zip(i[sel].tolist(), j[sel].tolist(),
                          np.round(v[sel], 12).tolist()))

    @pytest.mark.parametrize("sj", [False, True])
    def test_matches_gather_many_seeds(self, sj):
        for seed in range(40):
            args = self._case(seed, sj=sj)
            g = expand_products_raw(*args, method="gather")
            j = expand_products_raw(*args, method="join")
            assert self._norm(g) == self._norm(j), f"seed {seed}"

    def test_join_stream_is_ascending_k_per_cell(self):
        # Products of one output cell must appear in ascending k so the
        # stable product sort preserves reference accumulation order.
        args = self._case(3)
        i_t, j_t, v_t, valid = expand_products_raw(*args, method="join")
        # join stream is ordered by B CSR position = (k, j): within equal
        # (i, j), positions (and hence k) are ascending by construction;
        # verify validity mask is a front-contiguous prefix.
        val = np.asarray(valid)
        assert val[: val.sum()].all() and not val[val.sum():].any()

    def test_multiply_jit_with_join(self):
        # the join path must be jittable end to end
        args = self._case(11)

        @jax.jit
        def f(i_a, k_a, v_a, live, rs, rl, bc, bv):
            return expand_products_raw(i_a, k_a, v_a, live, rs, rl, bc, bv,
                                       args[8], args[9], None, None, 256,
                                       method="join")
        out = f(*args[:8])
        g = expand_products_raw(*args, method="gather")
        assert self._norm(g) == self._norm(out)
