"""Test env: force 8 virtual CPU devices so the distributed (shard_map)
tests can exercise real multi-device lowering in-process.

NOTE: this is 8, NOT the dry-run's 512 — the production-mesh compile path is
exercised only via ``launch/dryrun.py`` in its own process (see DESIGN.md).
Single-device tests simply use device 0 and are unaffected.
This must run before jax/jaxlib first parse XLA_FLAGS, hence conftest.
"""

import os
import zlib

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def shard_of(path: str, num_shards: int) -> int:
    """Stable file → shard assignment for CI tier-1 sharding.

    crc32, not ``hash()``: assignment must agree across processes and
    Python versions (PYTHONHASHSEED randomizes str hash). Sharding is by
    test FILE so a module-scoped fixture is built in exactly one shard
    (session-scoped fixtures are per-process either way: every shard that
    collects a file using one builds its own copy).
    """
    return zlib.crc32(path.encode()) % num_shards


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA Hopper card with CUDA (each test skips itself "
        "without one)",
    )


def pytest_collection_modifyitems(config, items):
    """Optional tier-1 sharding for the CI matrix.

    ``PYTEST_NUM_SHARDS=N`` + ``PYTEST_SHARD=1..N`` select a stable,
    disjoint, exhaustive partition of the test files; unset (the default,
    and every local run) leaves collection untouched.
    """
    num = int(os.environ.get("PYTEST_NUM_SHARDS", "1") or 1)
    if num <= 1:
        return
    shard = int(os.environ.get("PYTEST_SHARD", "1"))
    if not 1 <= shard <= num:
        raise pytest.UsageError(
            f"PYTEST_SHARD={shard} out of range 1..{num}"
        )
    keep, drop = [], []
    for item in items:
        fname = item.nodeid.split("::", 1)[0]
        (keep if shard_of(fname, num) == shard - 1 else drop).append(item)
    if drop:
        items[:] = keep
        config.hook.pytest_deselected(items=drop)


@pytest.fixture(scope="session")
def corpus():
    """A small power-law-ish normalized corpus (paper-style data)."""
    import jax.numpy as jnp

    from repro.core.apss import normalize_rows

    rng = np.random.default_rng(0)
    n, m = 128, 96
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < 0.3
    return np.asarray(normalize_rows(jnp.asarray(D)))


@pytest.fixture(scope="session")
def mesh8():
    from repro.compat import make_mesh

    return make_mesh((8,), ("data",))


@pytest.fixture(scope="session")
def mesh8_model():
    from repro.compat import make_mesh

    return make_mesh((8,), ("model",))


@pytest.fixture(scope="session")
def mesh4x2():
    from repro.compat import make_mesh

    return make_mesh((4, 2), ("data", "model"))
