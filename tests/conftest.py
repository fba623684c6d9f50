"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see 1 device (dry-run contract §0); only launch/dryrun.py sets the
512-device flag."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where none is present")


TINY = ModelConfig(
    name="tiny-test", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test")


@pytest.fixture(scope="session")
def tiny_cfg():
    return TINY


@pytest.fixture(scope="session")
def tiny_params(tiny_cfg):
    from repro.models import init_params
    return init_params(tiny_cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
