"""Online retrieval serving: a build-once APSS index and query-time top-k.

- :mod:`repro_torch.serving.index`  -- :class:`APSSIndex`: the normalized,
  padded corpus (dense or CSR), its block bounds and, for CSR, the
  per-block support compaction, built once per corpus, whole on one
  device or split into row-block shards over several (``devices=``).
- :mod:`repro_torch.serving.query`  -- :func:`query_topk`: the rectangular
  (queries × corpus) pruned scoring path through K4, K5 and K6, and on a
  sharded index K4 (or gather-dot) per shard at global ids.
- :mod:`repro_torch.serving.mutable` -- :class:`MutableAPSSIndex`: a live
  corpus (append, delete, compact) keeping a standing top-k graph current
  by delta joins through K4's masked entry, with a write-ahead log and
  snapshots (``repro_torch.checkpoint``).
- :mod:`repro_torch.serving.server` -- :class:`RetrievalServer` (batches at
  step boundaries, LRU cache keyed on the index version, deadlines,
  degradation ladder) and :class:`ContinuousRetrievalServer` (worker
  threads claim batches the moment requests arrive), over a built or a
  live index.

``build_index(plan=)`` and ``query_topk(plan=)`` take the planner's
decisions (``repro_torch.planner``). With a telemetry log active the
queries and delta joins record ``ApssStats`` and the servers count their
events; with a ``repro_torch.obs`` tracer, metrics registry or flight
recorder active, the servers and the live index feed it.
"""

from repro_torch.serving.index import APSSIndex, build_index, index_nbytes  # noqa: F401
from repro_torch.serving.mutable import MutableAPSSIndex  # noqa: F401
from repro_torch.serving.query import query_topk  # noqa: F401
from repro_torch.serving.server import (  # noqa: F401
    ContinuousRetrievalServer,
    RetrievalResult,
    RetrievalServer,
    ServerStats,
)
