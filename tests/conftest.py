import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see ONE
# device; only launch/dryrun.py forces 512 host devices (see system design).


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
