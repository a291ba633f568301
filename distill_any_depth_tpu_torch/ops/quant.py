"""Dynamic W8A8 int8 GEMMs for inference-only forwards.

Counterpart of distill_any_depth_tpu/ops/quant.py (``quantize_rows``,
``quantize_cols``, ``int8_matmul``; its ``QuantDense`` is
``models/vit.QuantLinear``):

- activations: symmetric per-row int8, ``scale = max(amax, 1e-8) / 127``,
  ``q = round_half_even(x / scale)``, computed at every call;
- weights: symmetric per-output-channel int8 from the fp32 parameter (no new
  checkpoint format);
- an int32 product and the dequant ``(acc * row_scale) * col_scale`` in fp32.

Two routes, as in the JAX package:

- ``"int8"`` (``int8_matmul``, the JAX package's XLA route): plain PyTorch,
  a row-quant pass, the integer product (``torch._int_mm``, cuBLASLt's int8
  GEMM, on the card; the exact product of ``int_product_exact`` on the CPU),
  then the dequant, a cast to the output dtype and the bias added in that
  dtype.
- ``"int8_pallas"`` (``ops/quant_matmul.w8a8_matmul``, kernel 9): the
  activations are quantized inside the kernel, and the bias is added in fp32
  before the one cast.

The port's functions take the Linear's ``weight [out, in]`` (the JAX
functions take ``[in, out]``); ``quantize_cols`` keeps the JAX contract.
Under tensor parallelism a row-parallel ``QuantLinear`` (``reduce_group``
set by ``parallel/tp.shard_model``) holds a slice of each row of x and of
the weight. It quantizes with the global row absmax (the maximum of the
ranks' row maxima) and the weight's scales of the unsharded rows, so that
its integer products are those of the unsharded layer (``shard_product``);
the fp32 dequantized partial products are summed over the model group, then
the bias is added as the route adds it. Kernel 9 quantizes x inside itself:
it is handed x in fp32 with 16 more columns, the first holding the global
absmax, against 16 zero weight columns, so that its row scale is the global
one and its product unchanged.

The row and weight quantization and the exact integer product are
``ops/quant_matmul``'s (its note on true divisions holds for them).
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.quant_matmul import (
    int_product_exact,
    quantize_rows,
    quantize_weight,
    w8a8_matmul,
)

__all__ = ["quantize_cols", "int8_matmul", "shard_product"]


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX contract: an ``[in, out]`` matrix per output channel,
    ``(wq int8 [in, out], scale fp32 [out])``."""
    wq, scale = quantize_weight(w.t())
    return wq.t(), scale


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int8 product as fp32: cuBLASLt's on the card, the exact one on
    the CPU."""
    if xq.device.type == "cuda":
        return _int_mm(xq, wq).float()
    return int_product_exact(xq, wq).float()


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """cuBLASLt's int8 GEMM ``xq [M, K] @ wq [N, K]^T`` -> int32; it takes
    only M > 16, so fewer rows are padded with zeros."""
    m = xq.shape[0]
    if m <= 16:
        xq = torch.cat([xq, xq.new_zeros(17 - m, xq.shape[1])])
    return torch._int_mm(xq, wq.t())[:m]


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None, *, quantized=None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` over the last axis of x by dynamic W8A8 (the
    ``"int8"`` route): ``x [..., K]`` float, ``weight [N, K]`` float
    (quantized here unless ``quantized = (wq, ws)`` hands it over), the
    output in ``out_dtype`` (x's dtype by default)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k))
    wq, ws = quantize_weight(weight) if quantized is None else quantized
    y = (_int_product(xq, wq) * xs * ws).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.reshape(*lead, wq.shape[0])


def shard_product(x: torch.Tensor, amax: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """A row-parallel shard's dequantized product in fp32: ``x [M, k]`` (a
    slice of each row) quantized at the global row absmax ``amax [M, 1]``,
    times ``wq [N, k]`` (the same slice of the weight's rows, quantized at
    the unsharded rows' scales ``ws [N]``), by the route of ``mode``.
    "int8_pallas" runs kernel 9 on x in fp32 with 16 more columns, the first
    holding ``amax``, against 16 zero weight columns: its own row absmax is
    then the global one and its product unchanged."""
    if mode == "int8_pallas":
        xa = torch.cat([x.float(), amax, amax.new_zeros(x.shape[0], 15)], -1)
        padded = torch.cat([wq, wq.new_zeros(wq.shape[0], 16)], 1)
        return w8a8_matmul(xa, None, None, torch.float32, quantized=(padded, ws))
    xq, xs = quantize_rows(x, amax)
    return _int_product(xq, wq) * xs * ws

