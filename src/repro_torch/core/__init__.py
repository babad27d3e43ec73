"""The self-join of the paper, on dense and padded-CSR corpora.

- :mod:`repro_torch.core.apss`      oracle + blocked self-join
- :mod:`repro_torch.core.distributed` the paper's 1-D and 2-D distributions
                                    over ``torch.distributed``
- :mod:`repro_torch.core.matches`   fixed-capacity match extraction / merging
- :mod:`repro_torch.core.pruning`   maxweight / minsize block bounds, dense
                                    and sparse (inverted-index candidacy)
- :mod:`repro_torch.core.sparse`    padded-CSR SparseCorpus + sparse scoring
- :mod:`repro_torch.core.graph`     similarity-graph (COO) helpers
- :mod:`repro_torch.core.precision` full-float32 products
"""

from repro_torch.core.apss import (
    apss_blocked,
    apss_reference,
    normalize_rows,
    similarity_topk,
)
from repro_torch.core.distributed import (  # not `apss`: the name of core.apss
    ApssStats,
    apss_2d,
    apss_horizontal,
    apss_horizontal_hierarchical,
    apss_vertical,
    gather_matches,
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
    sparse_block_prune_mask,
    sparse_block_stats,
    sparse_candidate_mask,
)
from repro_torch.core.sparse import (
    SparseCorpus,
    from_dense,
    normalize_sparse,
    sparse_similarity_topk,
    to_dense,
)
