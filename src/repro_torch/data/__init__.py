from repro_torch.data.synthetic import (
    PAPER_DATASETS,
    clustered_corpus,
    corpus_stats,
    paper_like_corpus,
    synthetic_corpus,
)
from repro_torch.data.sparse import (
    perturbed_queries,
    sparse_clustered_corpus,
    sparse_zipfian_bulk,
    sparse_zipfian_corpus,
)
from repro_torch.data.dedup import dedup_corpus
