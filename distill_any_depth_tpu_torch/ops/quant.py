"""Dynamic W8A8 int8 GEMMs for inference-only forwards.

Counterpart of distill_any_depth_tpu/ops/quant.py (``quantize_rows``,
``quantize_cols``, ``int8_matmul``, ``QuantDense``):

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
Every division is a true division: on the card PyTorch divides a tensor by
a Python number as a product with its reciprocal, which can differ in the
last bit and flip a round-half-even tie, so the scales divide by a 0-dim
tensor.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.models.vit import Linear

__all__ = ["QUANT_IMPLS", "quantize_rows", "quantize_weight", "quantize_cols",
           "int_product_exact", "int8_matmul", "QuantLinear"]

_EPS = 1e-8
# model-level ``quant`` mode -> QuantLinear impl
QUANT_IMPLS = {"int8": "xla", "int8_pallas": "pallas"}


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true division (NaN stays NaN)."""
    return amax.clamp_min(_EPS) / amax.new_full((), 127.0)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization along the last axis: ``(xq int8,
    scale fp32 [..., 1])`` with ``x ~= xq * scale``."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A Linear's ``[out, in]`` weight per output channel: ``(wq int8 [out,
    in], scale fp32 [out])``."""
    wq, scale = quantize_rows(weight)
    return wq, scale[:, 0]


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX contract: an ``[in, out]`` matrix per output channel,
    ``(wq int8 [in, out], scale fp32 [out])``."""
    wq, scale = quantize_weight(w.t())
    return wq.t(), scale


def int_product_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [N, K]^T`` of int8 values, exactly, as fp64: every
    partial sum is an integer below K * 127^2 < 2^53, so any summation order
    is exact. It uses no int8 library call, and BLAS makes it fast on the
    CPU (an int64 matmul has no BLAS path there)."""
    return xq.double() @ wq.double().t()


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
    if x.device.type == "cuda":
        acc = _int_mm(xq, wq).float()
    else:
        acc = int_product_exact(xq, wq).float()
    y = (acc * xs * ws).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.reshape(*lead, wq.shape[0])


class QuantLinear(Linear):
    """Drop-in for the port's ``Linear`` running its GEMM as dynamic W8A8
    int8, the counterpart of ``QuantDense``. It declares the same ``weight
    [out, in]`` and ``bias``, so state dicts load unchanged. ``impl``:
    ``"xla"`` (``int8_matmul``) or ``"pallas"`` (kernel 9,
    ``ops/quant_matmul.w8a8_matmul``).

    Inference only: in grad mode a weight that requires a gradient raises.
    The int8 weight and its scales are cached, keyed on the weight's device,
    storage and version counter, so an in-place update (``load_state_dict``,
    an optimizer step) quantizes anew."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 impl: str = "xla"):
        if impl not in ("xla", "pallas"):
            raise ValueError(f"QuantLinear impl must be 'xla' or 'pallas', not {impl!r}")
        super().__init__(in_features, out_features, bias=bias)
        self.impl = impl
        self._quantized = None  # ((device, data_ptr, version), wq, ws)

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.weight
        key = (w.device, w.data_ptr(), w._version)
        if self._quantized is None or self._quantized[0] != key:
            with torch.no_grad():
                self._quantized = (key, *quantize_weight(w))
        return self._quantized[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            raise RuntimeError("int8 GEMMs are inference-only: run under torch.no_grad() "
                               "or freeze the weights (a model that trains keeps quant='none')")
        if self.impl == "pallas":
            from distill_any_depth_tpu_torch.ops.quant_matmul import w8a8_matmul as matmul
        else:
            matmul = int8_matmul
        return matmul(x, self.weight, self.bias, x.dtype, quantized=self.quantized_weight())
