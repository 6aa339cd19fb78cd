"""Test configuration: hermetic CPU backend with an 8-device virtual mesh.

The test suite runs on the CPU backend (8 virtual devices via
``xla_force_host_platform_device_count``) so sharding/collective tests work
without real multi-chip hardware; f64 is enabled because the reference's
oracles are double precision (its MM test uses ``EXPECT_DOUBLE_EQ``,
/root/reference/tests/test_multiply_sparse.cpp:126).

The platform is pinned with ``jax.config.update`` before any backend is
initialized, so a machine with a GPU still runs this suite on the CPU;
compiled GPU checks live in ``tests_gpu/``.
"""

import os

import jax

# CI matrix knob: virtual device count (>= 8; dist tests slice the first 8).
_N_DEV = max(int(os.environ.get("SPSPARSE_TEST_DEVICES", "8")), 8)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={_N_DEV}"
)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
