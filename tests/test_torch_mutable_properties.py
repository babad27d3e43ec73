"""Hypothesis-driven metamorphic properties of the port's live corpus.

The invariant of ``tests/test_torch_mutable.py``: any interleaving of
append, delete, query and compact is bit-indistinguishable from a fresh
port index over the surviving rows, graph and queries, dense and sparse,
with hypothesis searching the op space (the twin of the reference's
``tests/test_mutable_properties.py``). Ops are small integer codes; the
rows come from a seeded numpy Generator, so examples shrink to short op
sequences rather than float arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.serving import MutableAPSSIndex  # noqa: E402

T = 0.15
K = 6
M = 16
CAP = 12

# (op_code, arg): 0 = append `arg+1` rows, 1 = delete `arg+1` live rows,
# 2 = compact. Deletes/compacts on an empty index degrade to appends.
_OPS = st.lists(st.tuples(st.integers(0, 2), st.integers(0, 5)), min_size=1, max_size=8)


def _rows(rng, n, sparse):
    D = rng.normal(size=(n, M)).astype(np.float32)
    if sparse:
        mask = rng.random((n, M)) < 0.3
        mask[np.arange(n), rng.integers(0, M, n)] = True
        D = np.where(mask, D, 0.0).astype(np.float32)
    return D


def _index(corpus, kind, block_rows):
    return MutableAPSSIndex(corpus, threshold=T, k=K, kind=kind, cap=CAP,
                            block_rows=block_rows, device="cpu")


def _check(mi, model, Q, kind, block_rows):
    gids = np.asarray([g for g, _ in model], np.int64)
    oracle = _index(np.stack([r for _, r in model]) if model else None, kind, block_rows)
    mg, g = mi.graph()
    assert np.array_equal(mg, gids)
    if model:
        _, og = oracle.graph()
        ti = np.where(og.indices >= 0, gids[np.maximum(og.indices, 0)], -1)
        assert np.array_equal(g.values, og.values)
        assert np.array_equal(g.indices, ti)
        assert np.array_equal(g.counts, og.counts)
    r, ro = mi.query(Q), oracle.query(Q)
    assert np.array_equal(r.values, ro.values)
    assert np.array_equal(r.counts, ro.counts)
    if model:
        ti = np.where(ro.indices >= 0, gids[np.maximum(ro.indices, 0)], -1)
        assert np.array_equal(r.indices, ti)


@settings(max_examples=12, deadline=None)
@given(ops=_OPS, seed=st.integers(0, 2**16), sparse=st.booleans(),
       block_rows=st.sampled_from([8, 64]))
def test_any_mutation_sequence_equals_fresh_rebuild(ops, seed, sparse, block_rows):
    rng = np.random.default_rng(seed)
    kind = "sparse" if sparse else "dense"
    Q = _rows(rng, 3, sparse)
    mi = _index(None, kind, block_rows)
    model = []
    for code, arg in ops:
        live = [g for g, _ in model]
        if code == 0 or not live:
            raw = _rows(rng, arg + 1, sparse)
            model += list(zip(mi.append(raw), raw))
        elif code == 1:
            victims = sorted(int(g) for g in rng.choice(live, min(arg + 1, len(live)),
                                                         replace=False))
            mi.delete(victims)
            model = [(g, r) for g, r in model if g not in set(victims)]
        else:
            mi.compact()
        _check(mi, model, Q, kind, block_rows)
