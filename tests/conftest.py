"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
compile and execute without accelerators (the environment variables must be
set before jax initialises — this conftest imports before any test module).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Backends initialise lazily, so pinning the platform here (before any test
# touches a device) holds even if jax was imported earlier.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def load_csv(name: str):
    """Load the reference's golden CSV data (id column + 8 feature columns).

    Data files copied from the reference's test corpus
    (test/sql/training.csv, queries.csv) — parity targets, not code."""
    raw = np.loadtxt(os.path.join(DATA_DIR, name), delimiter=",",
                     dtype=np.float64)
    ids = raw[:, 0].astype(np.int64)
    vecs = raw[:, 1:].astype(np.float32)
    return ids, vecs


@pytest.fixture
def training_data():
    return load_csv("training.csv")


@pytest.fixture
def query_data():
    return load_csv("queries.csv")


@pytest.fixture
def catalog():
    """Fresh isolated catalog per test."""
    from duckdb_faiss_ext_tpu.catalog import Catalog

    return Catalog()
