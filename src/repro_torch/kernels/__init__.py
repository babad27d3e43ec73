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

No kernel has a backward pass (the reference's Pallas kernels have none
either), and a kernel reached through ``ctypes`` leaves no ``grad_fn``: the
attention wrappers refuse inputs that require a gradient while grad mode
is on (:func:`refuse_autograd`), so a loss cannot lose a gradient silently.
"""

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` if grad mode is on and one of ``tensors``
    requires a gradient: ``name`` has no backward pass (train through the
    plain functions instead, as the reference trains through XLA)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} has no backward pass: an input requires grad. Training attends "
            "through the plain functions (models.layers, use_kernel=False)")


from repro_torch.kernels.apss_block.ops import (  # noqa: E402
    apss_block_matmul,
    apss_fused,
    apss_fused_compacted,
)

