"""Accumulator-combinator tests (reference accum.hpp semantics) plus the
determinism contract (SURVEY §5: bitwise-same outputs across runs replaces
race detection on an accelerator)."""

import numpy as np

import jax
import jax.numpy as jnp

from spsparse_tpu import (
    CooBuilder,
    DuplicatePolicy,
    consolidate,
    project_output,
    scatter_to_dense,
    scalar_sum,
)
from spsparse_tpu.ops import multiply


def stream():
    # Duplicate-bearing entry stream: (1,2) appears three times.
    b = CooBuilder((2, 4), dtype=np.float64)
    b.add((1, 2), 3.0)
    b.add((0, 1), 14.0)
    b.add((1, 2), 15.0)
    b.add((1, 3), 5.0)
    b.add((1, 2), -1.0)
    return b.build()


class TestDenseAccum:
    def test_add(self):
        d = np.asarray(scatter_to_dense(stream(), duplicate_policy=DuplicatePolicy.ADD))
        assert d[1, 2] == 17.0 and d[0, 1] == 14.0 and d[1, 3] == 5.0

    def test_leave_alone_first_wins(self):
        # Documented semantics (first value), not the reference's
        # overwrite-unless-NaN bug (accum.hpp:129-130).
        d = np.asarray(scatter_to_dense(stream(),
                                        duplicate_policy=DuplicatePolicy.LEAVE_ALONE))
        assert d[1, 2] == 3.0

    def test_replace_last_wins(self):
        d = np.asarray(scatter_to_dense(stream(),
                                        duplicate_policy=DuplicatePolicy.REPLACE))
        assert d[1, 2] == -1.0

    def test_into_existing(self):
        base = jnp.full((2, 4), 100.0)
        d = np.asarray(scatter_to_dense(stream(), out=base,
                                        duplicate_policy=DuplicatePolicy.REPLACE))
        assert d[1, 2] == -1.0
        assert d[0, 0] == 100.0  # untouched background


class TestOtherAccums:
    def test_scalar(self):
        assert float(scalar_sum(stream())) == 36.0

    def test_project(self):
        p = project_output(stream(), (1,))
        assert p.shape == (4,)
        c = consolidate(p, (0,))
        idx, vals = c.to_lists()
        assert idx == [(1,), (2,), (3,)]
        np.testing.assert_allclose(vals, [14.0, 17.0, 5.0])


class TestDeterminism:
    """Same input => bitwise-identical output, across repeated runs."""

    def test_consolidate_bitwise_stable(self, rng):
        b = CooBuilder((64, 64), dtype=np.float64)
        idx = np.stack([rng.integers(0, 64, 5000), rng.integers(0, 64, 5000)], 1)
        b.add_many(idx, rng.uniform(-1, 1, 5000))
        arr = b.build()
        outs = [consolidate(arr, (0, 1)) for _ in range(3)]
        for o in outs[1:]:
            np.testing.assert_array_equal(np.asarray(outs[0].vals),
                                          np.asarray(o.vals))
            np.testing.assert_array_equal(np.asarray(outs[0].indices),
                                          np.asarray(o.indices))

    def test_multiply_bitwise_stable(self, rng):
        def mk(shape, n):
            b = CooBuilder(shape, dtype=np.float64)
            b.add_many(np.stack([rng.integers(0, shape[0], n),
                                 rng.integers(0, shape[1], n)], 1),
                       rng.uniform(-1, 1, n))
            return b.build()
        A, B = mk((30, 30), 200), mk((30, 30), 200)
        r1 = multiply(1.0, A, B)
        r2 = multiply(1.0, A, B)
        np.testing.assert_array_equal(np.asarray(r1.vals), np.asarray(r2.vals))
        np.testing.assert_array_equal(np.asarray(r1.indices),
                                      np.asarray(r2.indices))
