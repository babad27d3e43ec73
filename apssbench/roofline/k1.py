"""K1 (``apss_fused.cu``): the dense self-join, the corpus handed over as an
``(n, m)`` float32 tensor. Bytes: the dense corpus read once and the
``Matches`` written once. Ops: 2 × ``Σ_d df_d (df_d − 1) / 2``."""

from apssbench.roofline import join_pair_products, matches_bytes

DEVICE_NAMES = ("apss::fused_kernel", "apss::fused_merge_kernel")


def count(run):
    c, k = run.csr, run.config["k"]
    ops = 2.0 * join_pair_products(c.indices, c.nnz, c.m)
    return {0: (ops, c.n * c.m * 4 + matches_bytes(c.n, k))}
