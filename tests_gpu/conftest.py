"""GPU test lane: compiled-kernel checks on a real NVIDIA GPU.

Run on a machine with a card, in one process (not under xdist — a JAX
process reserves most of the card's memory)::

    python -m pytest tests_gpu -m gpu -p no:xdist -q

Unlike ``tests/`` (which forces the CPU backend), this lane keeps JAX's
default platform. Whether a GPU is present is decided inside the ``gpu``
fixture, never at import or collection time, so every process collects
the same tests; without a card each test skips with a reason.
"""

import numpy as np
import pytest


@pytest.fixture
def gpu():
    import jax
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:  # no backend at all
        pytest.skip(f"no JAX backend: {e}")
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default device is {dev.platform}")
    jax.config.update("jax_enable_x64", True)
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)
