"""Roofline counts against brute force over the pairs."""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from apssbench import harness
from apssbench.gen import query_pool, zipf_csr
from apssbench.roofline import (
    PEAK_BYTES,
    PEAK_FLOPS,
    bound_s,
    doc_freq,
    join_pair_products,
    matches_bytes,
    query_pair_products,
    sharing_rows,
)

ROOT = Path(__file__).resolve().parents[1]


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _supports(c):
    return [set(c.indices[r, :int(c.nnz[r])].tolist()) for r in range(c.n)]


@pytest.fixture(scope="module")
def data():
    c = zipf_csr(60, 400, 18.0, 1.1, _gen(9))
    return c, query_pool(c, 3, 8, 0.02, _gen(10))


def test_join_products_are_the_pairs_shared_dimensions(data):
    c, _ = data
    sup = _supports(c)
    brute = sum(len(sup[i] & sup[j]) for i in range(c.n) for j in range(i + 1, c.n))
    assert join_pair_products(c.indices, c.nnz, c.m) == brute


def test_query_products_are_the_pairs_shared_dimensions(data):
    c, p = data
    sup, qs = _supports(c), _supports(p)
    df = doc_freq(c.indices, c.nnz, c.m)
    for b in range(3):
        brute = sum(len(q & s) for q in qs[b * 8:(b + 1) * 8] for s in sup)
        assert query_pair_products(p.indices[b * 8:(b + 1) * 8], p.nnz[b * 8:(b + 1) * 8], df,
                                   c.m) == brute


def test_bound_takes_the_larger_side():
    assert bound_s(PEAK_FLOPS, 0) == (1.0, "ops")
    assert bound_s(0, 2 * PEAK_BYTES) == (2.0, "bytes")


def test_sharing_rows_are_the_rows_that_meet_the_batch(data):
    c, p = data
    sup, qs = _supports(c), _supports(p)
    for b in range(3):
        batch = set().union(*qs[b * 8:(b + 1) * 8])
        want = sum(1 for s in sup if s & batch)
        assert sharing_rows(p.indices[b * 8:(b + 1) * 8], p.nnz[b * 8:(b + 1) * 8],
                            c.indices, c.nnz, c.m) == want
    none = sharing_rows(torch.full((1, 1), c.m - 1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32), c.indices, c.nnz, c.m)
    assert none == sum(1 for s in sup if c.m - 1 in s)


@pytest.mark.parametrize("kernel,traffic", [("k1", {}), ("k4", {"batch": 8})])
def test_kernel_counts(data, kernel, traffic):
    c, p = data
    mod = harness.load_module(ROOT / "apssbench" / "roofline" / f"{kernel}.py")
    run = SimpleNamespace(csr=c, pool=p, config={"k": 4}, traffic=traffic)
    counts = mod.count(run)
    if kernel == "k1":
        assert counts == {0: (2.0 * join_pair_products(c.indices, c.nnz, c.m),
                              c.n * c.m * 4 + matches_bytes(c.n, 4))}
    else:
        df = doc_freq(c.indices, c.nnz, c.m)
        assert counts == {b: (2.0 * query_pair_products(p.indices[b * 8:(b + 1) * 8],
                                                        p.nnz[b * 8:(b + 1) * 8], df, c.m),
                              sharing_rows(p.indices[b * 8:(b + 1) * 8], p.nnz[b * 8:(b + 1) * 8],
                                           c.indices, c.nnz, c.m) * c.m * 4
                              + 8 * c.m * 4 + matches_bytes(8, 4)) for b in range(3)}
        assert mod.count(SimpleNamespace(**{**vars(run), "pool": None})) is None
