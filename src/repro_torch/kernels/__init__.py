"""Kernels written by hand for Hopper, each with a plain PyTorch version.

- :mod:`repro_torch.kernels.apss_block` -- K1 (``csrc/apss_fused.cu``) and
  K2 (``csrc/tile_candidates.cu``) of the self-join.
- :mod:`repro_torch.kernels._build`     -- nvcc build + ctypes loading, at
  first launch.
"""

from repro_torch.kernels.apss_block.ops import apss_fused, apss_fused_compacted
