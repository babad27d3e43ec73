from repro_torch.kernels.apss_block.ops import apss_fused, apss_fused_compacted
