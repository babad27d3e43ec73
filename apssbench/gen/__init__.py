"""Inputs made on the device from a seed: the corpus and the query pool."""

from apssbench.gen.corpus import Csr, densify, query_pool, row_nnz, weighted, zipf_csr, zipf_dims

__all__ = ["Csr", "densify", "query_pool", "row_nnz", "weighted", "zipf_csr", "zipf_dims"]
