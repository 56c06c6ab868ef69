"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
single CPU device (the 512-device override is dryrun.py-only).

Corpus/AST generators live in ``tests/strategies.py`` (shared with the
hypothesis property suites); this module only binds them to fixtures."""

import numpy as np
import pytest

from strategies import make_lists


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def lists(rng):
    return make_lists(rng)


@pytest.fixture(scope="session")
def repair_result(lists):
    from repro.core.repair import repair_compress
    return repair_compress(lists)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where "
        "torch.cuda.is_available() is False)")
