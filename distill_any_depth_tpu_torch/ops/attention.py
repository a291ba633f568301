"""Multi-head attention entry point for the ViT encoder.

Counterpart of distill_any_depth_tpu/ops/attention.py
``multi_head_attention_packed`` without ``bias``/``band`` (the windowed and
biased variants are not ported yet). Every CUDA call goes through the
packed attention kernel: the TPU package's einsum cutover below 512 tokens
was a TPU launch-cost trade and does not carry over.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.flash_attention import mha_flash_packed

__all__ = ["multi_head_attention_packed"]


def multi_head_attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention on the fused-QKV GEMM output ``[B, N, 3*H*D]`` (column
    order q|k|v, head, dim), returning ``[B, N, H*D]``."""
    return mha_flash_packed(qkv, num_heads)
