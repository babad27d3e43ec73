"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: cells that
self-join and query the paper's Table 1 corpora on one H100, driven by
``BENCHMARK.json`` and the data files beside this package."""
