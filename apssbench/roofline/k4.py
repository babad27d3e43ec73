"""K4 (``rect_tile_candidates.cu``): a query batch against a dense index.
Bytes a batch: the dense float32 rows of the corpus that share a dimension
with some query of the batch (no other row can score above 0, and the
index's block bounds may prove the rest dead) and the dense float32 batch
read once, the ``Matches`` written once. Ops a batch: 2 × ``Σ_d qf_d df_d``."""

from apssbench.roofline import doc_freq, matches_bytes, query_pair_products, sharing_rows

DEVICE_NAMES = ("apss::rect_part_kernel", "apss::rect_select_kernel")


def count(run):
    if run.pool is None:
        return None
    c, p, k, B = run.csr, run.pool, run.config["k"], run.traffic["batch"]
    df = doc_freq(c.indices, c.nnz, c.m)
    out = {}
    for b in range(p.n // B):
        qi, qn = p.indices[b * B:(b + 1) * B], p.nnz[b * B:(b + 1) * B]
        rows = sharing_rows(qi, qn, c.indices, c.nnz, c.m)
        out[b] = (2.0 * query_pair_products(qi, qn, df, c.m),
                  rows * c.m * 4 + B * c.m * 4 + matches_bytes(B, k))
    return out
