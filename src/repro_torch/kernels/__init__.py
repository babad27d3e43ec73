"""Kernels written by hand for Hopper, each with a plain PyTorch version.

- :mod:`repro_torch.kernels.apss_block` -- K1 (``csrc/apss_fused.cu``),
  K2 (``csrc/tile_candidates.cu``) and K3
  (``csrc/sparse_tile_candidates.cu``, one body with K2 in
  ``csrc/tile_items.cuh``) of the self-join; K4
  (``csrc/rect_tile_candidates.cu``), K5 (``csrc/rect_tile_candidates_ee.cu``)
  and K6 (``csrc/rect_sparse_tile_candidates.cu``) of serving; and K7
  (``csrc/apss_block.cu``), the thresholded dense score matrix.
- :mod:`repro_torch.kernels.flash_attention` -- K8
  (``csrc/flash_attention.cu``), causal GQA attention for prefill.
- :mod:`repro_torch.kernels.decode_attention` -- K9
  (``csrc/decode_attention.cu``), flash-decode partials over a KV cache.
- :mod:`repro_torch.kernels._build`     -- nvcc build + ctypes loading, at
  first launch.
"""

from repro_torch.kernels.apss_block.ops import (
    apss_block_matmul,
    apss_fused,
    apss_fused_compacted,
)
