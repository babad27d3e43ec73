from repro_torch.kernels.apss_block.apss_block import apss_block_plain
from repro_torch.kernels.apss_block.ops import (
    apss_block_matmul,
    apss_fused,
    apss_fused_compacted,
)
from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted
