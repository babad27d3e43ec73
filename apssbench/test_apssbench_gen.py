"""The device generator's law, at small sizes on the CPU."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from apssbench import harness
from apssbench.gen import densify, query_pool, zipf_csr

ROOT = Path(__file__).resolve().parents[1]
topical = harness.load_module(ROOT / "apssbench" / "laws" / "topical.py")


def _config(name):
    return json.loads((ROOT / "apssbench" / "configs" / f"{name}.json").read_text())


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _check_csr(c, n, m):
    assert c.indices.shape[0] == n and c.indices.dtype == torch.int32
    nnz = c.nnz.long()
    assert int(nnz.min()) >= 1 and int(nnz.max()) == c.cap <= m
    live = torch.arange(c.cap)[None, :] < nnz[:, None]
    idx = torch.where(live, c.indices.long(), m + torch.arange(c.cap)[None, :])
    assert bool((idx[:, 1:] > idx[:, :-1]).all()), "ids ascend and are distinct in a row"
    assert bool((c.indices[~live] == 0).all()) and bool((c.values[~live] == 0).all())
    assert bool((c.values[live] > 0).all())
    torch.testing.assert_close(c.values.square().sum(1), torch.ones(n), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["radikal", "20news"])
def test_law_at_the_papers_width(name):
    """Rows of Table 1's width and mean nonzeros: the mean and the Zipf head."""
    cfg = _config(name)
    assert cfg["assumed"]["law"] == "zipf"
    law = harness.load_module(ROOT / "apssbench" / "laws" / "zipf.py")
    n, m, avg = 192, cfg["m"], cfg["nnz"] / cfg["n"]
    c = law.draw({**cfg, "n": n, "nnz": cfg["nnz"] * n / cfg["n"]}, _gen(7))
    _check_csr(c, n, m)
    mean = c.nnz.double().mean().item()
    assert abs(mean - avg) < 4 * math.sqrt(avg / n)
    df = torch.bincount(c.indices[c.values > 0].long(), minlength=m)
    # The head dimensions are in nearly every row; a dimension far in the
    # tail is in almost none.
    assert int(df[:5].min()) >= 0.9 * n
    assert int(df[m // 2:].sum()) < 0.05 * n * avg


def test_head_matches_sampling_without_replacement():
    """Inclusion of the first dimensions against the port's numpy generator,
    which draws the same law one row at a time."""
    from repro_torch.data.sparse import sparse_zipfian_corpus

    n, m, avg = 1500, 3000, 20.0
    ours = zipf_csr(n, m, avg, 1.1, _gen(11))
    theirs = sparse_zipfian_corpus(n, m, avg, seed=11, device="cpu")
    for c in (ours, theirs):
        _check_csr(c, n, m)
    df_a = torch.bincount(ours.indices[ours.values > 0].long(), minlength=m)[:40].double() / n
    df_b = torch.bincount(theirs.indices[theirs.values > 0].long(), minlength=m)[:40].double() / n
    sigma = torch.sqrt(df_b.clamp(0.01, 0.99) * (1 - df_b.clamp(0.01, 0.99)) / n)
    assert bool(((df_a - df_b).abs() < 5 * sigma * math.sqrt(2)).all())


def test_one_seed_one_corpus():
    a = zipf_csr(64, 900, 12.0, 1.1, _gen(2**31 + 5))
    b = zipf_csr(64, 900, 12.0, 1.1, _gen(2**31 + 5))
    c = zipf_csr(64, 900, 12.0, 1.1, _gen(2**31 + 6))
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not torch.equal(a.indices, c.indices)


def test_query_pool_is_jittered_corpus_rows():
    c = zipf_csr(200, 1000, 15.0, 1.1, _gen(3))
    g = _gen(4)
    p = query_pool(c, 5, 16, 0.02, g)
    assert p.n == 80 and p.m == c.m
    D, Q = densify(c), densify(p)
    torch.testing.assert_close(Q.square().sum(1), torch.ones(80), rtol=0, atol=1e-5)
    sims = Q @ D.T
    best = sims.max(1)
    assert bool((best.values > 0.99).all()), "each query is a near duplicate of a row"
    rows = best.indices.view(5, 16)
    assert bool((rows[:, 1:] - rows[:, :-1] == 1).all()), "a batch is a contiguous range"
    assert torch.equal((Q > 0), (D[best.indices] > 0))


def test_query_pool_scattered_rows():
    c = zipf_csr(200, 1000, 15.0, 1.1, _gen(3))
    p = query_pool(c, 6, 16, 0.02, _gen(4), rows="scattered")
    Q, D = densify(p), densify(c)
    best = (Q @ D.T).max(1)
    assert bool((best.values > 0.99).all())
    rows = best.indices.view(6, 16)
    assert all(len(set(r.tolist())) == 16 for r in rows), "distinct rows in a batch"
    assert int((rows.max(1).values - rows.min(1).values).min()) > 16, "spread over the corpus"
    with pytest.raises(ValueError):
        query_pool(c, 1, 4, 0.02, _gen(4), rows="sorted")


def test_densify_scatters_rows():
    c = zipf_csr(30, 500, 9.0, 1.1, _gen(5))
    D = densify(c).numpy()
    idx, val, nnz = c.indices.numpy(), c.values.numpy(), c.nnz.numpy()
    want = np.zeros_like(D)
    for r in range(30):
        want[r, idx[r, :nnz[r]]] = val[r, :nnz[r]]
    np.testing.assert_array_equal(D, want)


@pytest.fixture(scope="module")
def two_topics():
    """The first two topics of ``20news_topics`` at the configuration's own
    band width and rows a topic."""
    cfg = _config("20news_topics")
    a = cfg["assumed"]
    topics, per = a["topics"], -(-cfg["n"] // a["topics"])
    width = cfg["m"] // topics
    c = topical.topical_csr(2 * per, 2 * width, cfg["nnz"] / cfg["n"], a["zipf_alpha"], 2, _gen(21))
    return cfg, c, per, width


def test_topical_rows_keep_to_their_topics_band(two_topics):
    cfg, c, per, width = two_topics
    _check_csr(c, 2 * per, 2 * width)
    live = torch.arange(c.cap)[None, :] < c.nnz.long()[:, None]
    topic = (torch.arange(c.n) // per)[:, None].expand_as(c.indices)
    band = c.indices.long() // width
    assert bool((band[live] == topic[live]).all()), "a row draws only from its topic's band"
    mean = c.nnz.double().mean().item()
    avg = cfg["nnz"] / cfg["n"]
    assert abs(mean - avg) < 4 * math.sqrt(avg / c.n)
    for t in range(2):
        rows = c.indices[t * per:(t + 1) * per][c.values[t * per:(t + 1) * per] > 0].long()
        df = torch.bincount(rows - t * width, minlength=width)
        assert int(df[:5].min()) >= 0.95 * per  # the band's head is in nearly every row


def test_topical_rows_match_about_k_others_at_t(two_topics):
    """At the configuration's ``t``, a row's matches lie in its own topic,
    about ``k`` of them; no pair of two topics scores above 0."""
    cfg, c, per, _ = two_topics
    D = densify(c).double()
    S = D @ D.T
    S.fill_diagonal_(-1.0)
    assert float(S[:per, per:].abs().max()) == 0.0
    matches = (S >= cfg["t"]).sum(1).double()
    assert 10 <= float(matches.median()) <= 60
    assert 0.2 <= float((matches > cfg["k"]).double().mean()) <= 0.7


def test_topical_one_seed_one_corpus():
    a = topical.topical_csr(90, 1200, 14.0, 1.7, 3, _gen(2**31 + 8))
    b = topical.topical_csr(90, 1200, 14.0, 1.7, 3, _gen(2**31 + 8))
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
