"""Online retrieval serving: a build-once APSS index and query-time top-k.

- :mod:`repro_torch.serving.index`  -- :class:`APSSIndex`: the normalized,
  padded corpus (dense or CSR), its block bounds and, for CSR, the
  per-block support compaction, built once per corpus.
- :mod:`repro_torch.serving.query`  -- :func:`query_topk`: the rectangular
  (queries × corpus) pruned scoring path through K4, K5 and K6.
- :mod:`repro_torch.serving.server` -- :class:`RetrievalServer` (batches at
  step boundaries, LRU cache, deadlines, degradation ladder) and
  :class:`ContinuousRetrievalServer` (worker threads claim batches the
  moment requests arrive).
"""

from repro_torch.serving.index import APSSIndex, build_index, index_nbytes  # noqa: F401
from repro_torch.serving.query import query_topk  # noqa: F401
from repro_torch.serving.server import (  # noqa: F401
    ContinuousRetrievalServer,
    RetrievalResult,
    RetrievalServer,
    ServerStats,
)
