import os

# 8 placeholder devices for the distribution/integration tests (the dry-run
# uses 512, but only inside launch/dryrun.py).  Harmless for single-device
# tests: unsharded computations run on device 0.  Must be set before the
# first jax import anywhere in the session.
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")
