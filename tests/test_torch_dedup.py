"""The port's near-duplicate detection (``repro_torch.data.dedup``) against
the JAX package's ``dedup_corpus`` on the CPU (the plain path; K1 runs it on
the card, ``tests/test_torch_kernels_gpu.py``).

The reference's planted-duplicate case (``tests/test_substrates.py``), and
a corpus with near duplicates (perturbed copies, chains of them, and a
row duplicated twice) whose float64 scores lie clear of the threshold:
``keep`` and ``duplicate_of`` equal to the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_clear_of_threshold  # noqa: E402
from repro.data.dedup import dedup_corpus as jax_dedup  # noqa: E402
from repro_torch.data import dedup_corpus  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402


def test_dedup_finds_planted_duplicates():
    D = synthetic_corpus(64, 256, 10.0, seed=2)
    dup = np.concatenate([D, D[:8]])
    keep, dup_of = dedup_corpus(dup, threshold=0.999, device="cpu")
    assert keep[:64].all()
    assert not keep[64:].any()
    np.testing.assert_array_equal(dup_of[64:], np.arange(8))
    assert (dup_of[:64] == -1).all() and dup_of.dtype == np.int32


def _near_duplicates():
    rng = np.random.default_rng(7)
    D = synthetic_corpus(192, 320, 14.0, seed=5)
    src = rng.choice(192, 40, replace=False)
    near = D[src] * (1 + 0.03 * rng.random((40, 320)).astype(np.float32))
    chain = near[:6] * (1 + 0.03 * rng.random((6, 320)).astype(np.float32))
    X = np.concatenate([D, near, chain, D[src[:3]]])
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X[rng.permutation(len(X))].astype(np.float32)


@pytest.mark.parametrize("threshold", [0.95, 0.99])
def test_dedup_matches_the_reference(threshold):
    X = _near_duplicates()
    assert_clear_of_threshold(X, X, threshold, exclude_self=True)
    keep, dup_of = dedup_corpus(X, threshold=threshold, block_rows=64, device="cpu")
    want_keep, want_dup = jax_dedup(X, threshold=threshold, block_rows=64)
    assert (~keep).sum() >= 20
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_array_equal(dup_of, want_dup)
    dropped = np.flatnonzero(~keep)
    assert (dup_of[dropped] < dropped).all() and keep[dup_of[dropped]].all()


def test_use_kernel_on_the_cpu_takes_the_plain_version():
    X = _near_duplicates()
    a = dedup_corpus(X, device="cpu")
    b = dedup_corpus(X, device="cpu", use_kernel=True)  # K1's plain version on CPU tensors
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
