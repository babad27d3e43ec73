"""repro_torch: the all-pairs similarity self-join and its serving, and the
LM serving path, in PyTorch, with the kernels written in CUDA C++ for NVIDIA
Hopper (sm_90a).

The port of ``repro`` (JAX/Pallas on a TPU), laid out like it so that each
file sits at the same relative path as its reference. It imports torch,
numpy and the standard library only. Entry points take ``device=``
(default ``"cuda"``, which raises without a card); on the CPU the kernels'
plain PyTorch versions run. Importing the package builds nothing: each
kernel is compiled with ``nvcc`` on its first launch.

Subpackages:

- :mod:`repro_torch.core`    -- the self-join: oracle, blocked join (dense
                                and padded-CSR ``SparseCorpus``), the
                                paper's 1-D and 2-D distributions over
                                ``torch.distributed``, matches, pruning
                                bounds, graph helpers
- :mod:`repro_torch.kernels` -- K1 (streaming fused), K2 (live-tile
                                worklist), K3 (CSR worklist), K4/K5/K6
                                (rectangular serving tiles, K5 with early
                                exit), K7 (thresholded dense tile), K8
                                (flash attention) and K9 (flash-decode
                                partials) with their wrappers and plain
                                versions
- :mod:`repro_torch.serving` -- build-once index, ``query_topk``, the
                                live corpus (``MutableAPSSIndex``), the
                                retrieval servers
- :mod:`repro_torch.models`  -- the dense GQA transformer (qwen3) and its
                                layers: prefill, KV-cache decode
- :mod:`repro_torch.configs` -- architecture registry (qwen3-1.7b)
- :mod:`repro_torch.launch`  -- ``launch/serve.py`` (LM and retrieval
                                modes, ``LMServer``), ``launch/live.py``
                                (the live-corpus demo), ``launch/mesh.py``
                                (meshes of ranks, ``spawn``)
- :mod:`repro_torch.data`    -- synthetic corpora (dense numpy, CSR) and
                                the serving traffic model
- :mod:`repro_torch.obs`, :mod:`repro_torch.robust`,
  :mod:`repro_torch.checkpoint` -- tracing, metrics and the flight
                                recorder; fault injection; atomic verified
                                checkpoints (the live corpus's WAL)
"""

from repro_torch.core.apss import (
    apss_blocked,
    apss_reference,
    normalize_rows,
    similarity_topk,
)
from repro_torch.core.matches import Matches, extract_matches, merge_matches
from repro_torch.core.sparse import SparseCorpus, from_dense, to_dense
from repro_torch.kernels.apss_block.ops import (
    apss_block_matmul,
    apss_fused,
    apss_fused_compacted,
)
from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted

__version__ = "0.1.0"
