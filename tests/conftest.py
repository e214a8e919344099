import jax
import jax.numpy as jnp
import pytest

from repro.core.utils import l2_normalize

# NOTE: no XLA_FLAGS here — unit tests must see the real single CPU device.
# Multi-device tests (tests/test_distributed.py) spawn subprocesses that set
# xla_force_host_platform_device_count themselves.


@pytest.fixture(scope="session")
def corpus():
    """Clustered unit-norm corpus (4000 x 64) + queries + exact top-10."""
    rng = jax.random.PRNGKey(0)
    kc, kx, kq, kb = jax.random.split(rng, 4)
    centers = jax.random.normal(kc, (32, 64))
    assign = jax.random.randint(kx, (4000,), 0, 32)
    x = l2_normalize(centers[assign] + 0.3 * jax.random.normal(kq, (4000, 64)))
    q = l2_normalize(x[:64] + 0.05 * jax.random.normal(kb, (64, 64)))
    gt = jax.lax.top_k(q @ x.T, 10)[1]
    return x, q, gt


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason where there is none"
    )
