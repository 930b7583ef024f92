"""Test configuration: force an 8-virtual-device CPU platform so multi-device
sharding logic is exercised without accelerators (SURVEY §4)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller names a platform (``JAX_PLATFORMS=cuda pytest -m gpu``
# runs the card-only tests on a GPU)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from otto_tpu.data.synthetic import synthetic_events


@pytest.fixture(scope="session")
def small_events():
    return synthetic_events(n_sessions=300, n_aids=500, mean_length=8.0, seed=7)


@pytest.fixture
def gpu():
    """The first GPU, or a skip: card-only tests (marker ``gpu``) decide here,
    never at import time."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU; python chip_smoke.py covers this on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
