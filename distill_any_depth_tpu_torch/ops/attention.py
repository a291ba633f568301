"""Multi-head attention entry point for the ViT encoder.

Counterpart of distill_any_depth_tpu/ops/attention.py
``multi_head_attention_packed``. ``impl`` is the JAX package's:

- ``"auto"`` and ``"flash"``: bias-free attention goes through the packed
  attention kernel; a bias or a window band goes through ``mha_flash_qkv``
  (the biased or the banded kernel) on q, k, v viewed in place in the
  packed tensor, whose backward on the card returns one packed ``d(qkv)``.
  Every CUDA call reaches a kernel whatever N is: the JAX package's einsum
  cutover below 512 tokens was a TPU launch-cost trade and does not change
  the function, so the two names route alike.
- ``"reference"``: the plain version on any device, because the caller
  asked for it (``mha_packed_reference``; with a bias
  ``mha_bias_reference``, with a band alone ``mha_banded_reference``).
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.flash_attention import (
    _split,
    mha_banded_reference,
    mha_bias_reference,
    mha_flash_packed,
    mha_flash_qkv,
    mha_packed_reference,
)

__all__ = ["ATTN_IMPLS", "multi_head_attention_packed"]

ATTN_IMPLS = ("auto", "flash", "reference")


def multi_head_attention_packed(qkv: torch.Tensor, num_heads: int,
                                bias: torch.Tensor | None = None,
                                band: tuple[int, int] | None = None,
                                impl: str = "auto") -> torch.Tensor:
    """Attention on the fused-QKV GEMM output ``[B, N, 3*H*D]`` (column
    order q|k|v, head, dim), returning ``[B, N, H*D]``. ``bias`` and
    ``band``: see ``ops/flash_attention.mha_flash``; ``impl``: see the
    module docstring (anything else raises ``ValueError``)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "reference":
        b, n, c3 = qkv.shape
        if bias is None and band is None:
            return mha_packed_reference(qkv, num_heads)
        q, k, v = _split(qkv, num_heads)
        out = (mha_bias_reference(q, k, v, bias) if bias is not None
               else mha_banded_reference(q, k, v, band))
        return out.reshape(b, n, c3 // 3)
    if bias is None and band is None:
        return mha_flash_packed(qkv, num_heads)
    return mha_flash_qkv(qkv, num_heads, bias, band)
