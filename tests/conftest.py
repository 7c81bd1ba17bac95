"""Shared test configuration: deterministic seeds, a pinned JAX platform,
and the ``tier1`` / ``slow`` marker convention.

Tier policy: the bare tier-1 command (``PYTHONPATH=src python -m pytest -x -q``)
runs everything *not* marked ``slow``; ``slow``-marked tests (large sweep
grids, subprocess-heavy paths) only run with ``--slow``.  ``tier1`` labels the
fast core set so ``-m tier1`` gives a sub-second sanity loop.
"""
import os
import random

# Pin the JAX platform before any test module imports jax: CPU everywhere,
# so results do not depend on what accelerator the host happens to expose.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

SEED = 20260801


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "tier1: fast core test, part of the sub-second sanity set")
    config.addinivalue_line(
        "markers", "slow: expensive test, skipped unless --slow is given")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
                   "without one")


def pytest_addoption(parser):
    parser.addoption("--slow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --slow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(autouse=True)
def _deterministic_seeds():
    """Reseed the stdlib and NumPy PRNGs before every test."""
    random.seed(SEED)
    try:
        import numpy as np
        np.random.seed(SEED)
    except ImportError:
        pass
    yield
