"""Multi-head attention entry point for the ViT encoder.

Counterpart of distill_any_depth_tpu/ops/attention.py
``multi_head_attention_packed``. Bias-free attention goes through the packed
attention kernel; a bias or a window band goes through ``mha_flash_qkv``
(the biased or the banded kernel) on q, k, v viewed in place in the packed
tensor, whose backward on the card returns one packed ``d(qkv)``. Every
CUDA call reaches a kernel whatever N is: the JAX package's einsum cutover
below 512 tokens was a TPU launch-cost trade and does not change the
function.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.flash_attention import mha_flash_packed, mha_flash_qkv

__all__ = ["multi_head_attention_packed"]


def multi_head_attention_packed(qkv: torch.Tensor, num_heads: int,
                                bias: torch.Tensor | None = None,
                                band: tuple[int, int] | None = None) -> torch.Tensor:
    """Attention on the fused-QKV GEMM output ``[B, N, 3*H*D]`` (column
    order q|k|v, head, dim), returning ``[B, N, H*D]``. ``bias`` and
    ``band``: see ``ops/flash_attention.mha_flash``."""
    if bias is None and band is None:
        return mha_flash_packed(qkv, num_heads)
    return mha_flash_qkv(qkv, num_heads, bias, band)
