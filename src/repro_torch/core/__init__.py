"""The dense self-join of the paper.

- :mod:`repro_torch.core.apss`      oracle + blocked self-join
- :mod:`repro_torch.core.matches`   fixed-capacity match extraction / merging
- :mod:`repro_torch.core.pruning`   maxweight / minsize block bounds
- :mod:`repro_torch.core.graph`     similarity-graph (COO) helpers
- :mod:`repro_torch.core.precision` full-float32 products
"""

from repro_torch.core.apss import (
    apss_blocked,
    apss_reference,
    normalize_rows,
    similarity_topk,
)
from repro_torch.core.matches import Matches, extract_matches, merge_matches
from repro_torch.core.pruning import (
    BlockStats,
    block_maxweight_bounds,
    block_minsize_bounds,
    block_prune_mask,
    dense_block_stats,
    live_tile_mask,
    local_threshold,
)
