"""The reference against brute force in float64, and the judge against
answers broken one way at a time."""

import numpy as np
import pytest
import torch

from apssbench.gen import densify, query_pool, zipf_csr
from apssbench.reference import control_matches, judge, join_scores, query_scores, tf32_round
from apssbench.reference import apss as ref

T, K, MU = 0.2, 6, 1e-5


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def corpus():
    return zipf_csr(120, 700, 25.0, 1.1, _gen(1))


def _brute(Q, C):
    return Q.astype(np.float64) @ C.astype(np.float64).T


def _exact(S, t, k):
    """Brute-force answers from float64 scores: the top k by value, ties to
    the lower id, and the count."""
    vals, ids, counts = [], [], []
    for row in S:
        ok = np.flatnonzero(row >= t)
        order = ok[np.lexsort((ok, -row[ok]))][:k]
        ids.append(np.r_[order, -np.ones(k - len(order), int)])
        vals.append(np.r_[row[order], np.full(k - len(order), -np.inf)])
        counts.append(len(ok))
    return (torch.tensor(np.array(vals), dtype=torch.float32),
            torch.tensor(np.array(ids), dtype=torch.int32), torch.tensor(counts, dtype=torch.int32))


def test_scores_equal_brute_force(corpus, monkeypatch):
    monkeypatch.setattr(ref, "BLOCK_BYTES", 700 * 8 * 50)  # several blocks each way
    D = densify(corpus).numpy()
    S = join_scores(corpus.indices, corpus.values, corpus.m).numpy()
    want = _brute(D, D)
    np.fill_diagonal(want, -np.inf)
    np.testing.assert_allclose(S, want, rtol=0, atol=1e-15)
    pool = query_pool(corpus, 3, 8, 0.02, _gen(2))
    Sq = query_scores(pool.indices, pool.values, corpus.indices, corpus.values, corpus.m)
    np.testing.assert_allclose(Sq.numpy(), _brute(densify(pool).numpy(), D), rtol=0, atol=1e-15)


def _judged(answer, S):
    v, i, c = answer
    return judge(v, i, c, S, torch.arange(S.shape[0]), t=T, k=K, mu=MU)


def test_exact_answers_pass(corpus):
    S = join_scores(corpus.indices, corpus.values, corpus.m)
    verdict = _judged(_exact(S.numpy(), T, K), S)
    assert verdict.rows_wrong == 0 and verdict.value_gap < 1e-7


def _row_with(counts, at_least):
    return int(torch.nonzero(counts >= at_least)[0])


@pytest.mark.parametrize("fault", [
    "swap_id", "drop_pair", "count_up", "count_down", "duplicate", "unsorted",
    "self_pair", "out_of_range", "value", "pad_value", "half_rows_empty",
])
def test_each_broken_answer_is_caught(corpus, fault):
    S = join_scores(corpus.indices, corpus.values, corpus.m)
    v, i, c = (x.clone() for x in _exact(S.numpy(), T, K))
    r = _row_with(c, K + 1) if fault in ("swap_id", "unsorted", "duplicate") else _row_with(c, 2)
    if fault == "swap_id":  # the row's worst pair in place of its best
        j = int(torch.argmin(S[r].nan_to_num(neginf=9.0)))
        i[r, 0], v[r, 0] = j, float(S[r, j])
    elif fault == "drop_pair":  # the second pair left out, the count one less
        i[r, 1:] = torch.cat([i[r, 2:], torch.tensor([-1], dtype=torch.int32)])
        v[r, 1:] = torch.cat([v[r, 2:], torch.tensor([float("-inf")])])
        c[r] -= 1
    elif fault == "count_up":
        c[r] += 1
    elif fault == "count_down":
        c[r] -= 1
    elif fault == "duplicate":
        i[r, 1], v[r, 1] = i[r, 0], v[r, 0]
    elif fault == "unsorted":
        assert v[r, 0] > v[r, 1]
        v[r, 0], v[r, 1] = v[r, 1].clone(), v[r, 0].clone()
        i[r, 0], i[r, 1] = i[r, 1].clone(), i[r, 0].clone()
    elif fault == "self_pair":
        i[r, 0] = r
    elif fault == "out_of_range":
        i[r, 0] = S.shape[1]
    elif fault == "value":
        v[r, 0] += 1e-4
    elif fault == "pad_value":
        r = _row_with(torch.where(c < K, 1, 0), 1)
        v[r, K - 1] = 0.5
    elif fault == "half_rows_empty":
        h = c.shape[0] // 2
        v[h:], i[h:], c[h:] = float("-inf"), -1, 0
    verdict = _judged((v, i, c), S)
    assert verdict.rows_wrong > 0 or verdict.value_gap > MU


def test_tf32_round():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 0.1, 3.14159, 2**-20 * 1.337], dtype=torch.float32)
    y = tf32_round(x)
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((y - x).abs() <= x.abs() * 2**-11).all())
    assert y[1] == 1.0 and y[2] == 1 + 4 * 2**-11  # ties to even


def test_control_is_caught_and_the_reference_would_pass(corpus):
    """The control (TF32-rounded inputs, float32 sums) fails the judge, at a
    size a test run holds; the same selection on float64 scores passes."""
    S = join_scores(corpus.indices, corpus.values, corpus.m)
    ctl = control_matches(corpus.indices, corpus.values, corpus.indices, corpus.values,
                          corpus.m, t=T, k=K, exclude_self=True)
    verdict = _judged(ctl, S)
    assert verdict.value_gap > 10 * MU
    assert _judged(_exact(S.numpy(), T, K), S).value_gap < 1e-7
