"""AdamW, schedules, clipping and top-k gradient compression over trees of
tensors (the reference's ``repro.optim``)."""

from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    compress_tree,
    compressed_psum_mean,
    compression_comm_bytes,
    compression_init,
)
