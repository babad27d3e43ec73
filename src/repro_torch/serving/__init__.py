"""Online retrieval serving: a build-once APSS index and query-time top-k.

- :mod:`repro_torch.serving.index`  -- :class:`APSSIndex`: the normalized,
  padded corpus (dense or CSR), its block bounds and, for CSR, the
  per-block support compaction, built once per corpus, whole on one
  device or split into row-block shards over several (``devices=``).
- :mod:`repro_torch.serving.query`  -- :func:`query_topk`: the rectangular
  (queries × corpus) pruned scoring path through K4, K5 and K6, and on a
  sharded index K4 (or gather-dot) per shard at global ids.
- :mod:`repro_torch.serving.server` -- :class:`RetrievalServer` (batches at
  step boundaries, LRU cache, deadlines, degradation ladder) and
  :class:`ContinuousRetrievalServer` (worker threads claim batches the
  moment requests arrive).

``build_index(plan=)`` and ``query_topk(plan=)`` take the planner's
decisions (``repro_torch.planner``), and with a telemetry log active the
queries record ``ApssStats`` and the servers count their events. Not yet
ported: the live index (ROADMAP queue 1 item 6).
"""

from repro_torch.serving.index import APSSIndex, build_index, index_nbytes  # noqa: F401
from repro_torch.serving.query import query_topk  # noqa: F401
from repro_torch.serving.server import (  # noqa: F401
    ContinuousRetrievalServer,
    RetrievalResult,
    RetrievalServer,
    ServerStats,
)
