"""``zipf``: dimensions Zipf-popular over all ``m`` (``apssbench.gen.zipf_csr``).
``assumed``: ``zipf_alpha``."""

from apssbench.gen import zipf_csr


def draw(config: dict, gen):
    return zipf_csr(config["n"], config["m"], config["nnz"] / config["n"],
                    config["assumed"]["zipf_alpha"], gen)
