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
Under tensor parallelism a row-parallel ``QuantLinear`` (``reduce_group``
set by ``parallel/tp.shard_model``) holds a slice of each row of x and of
the weight. It quantizes with the global row absmax (the maximum of the
ranks' row maxima) and the weight's scales of the unsharded rows, so that
its integer products are those of the unsharded layer; the fp32 dequantized
partial products are summed over the model group, then the bias is added
as the route adds it. Kernel 9 quantizes x inside itself: it is handed x
in fp32 with 16 more columns, the first holding the global absmax, against
16 zero weight columns, so that its row scale is the global one and its
product unchanged.

The row and weight quantization and the exact integer product are
``ops/quant_matmul``'s (its note on true divisions holds for them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from distill_any_depth_tpu_torch.models.vit import Linear
from distill_any_depth_tpu_torch.ops.quant_matmul import (
    int_product_exact,
    quantize_rows,
    quantize_weight,
    w8a8_matmul,
)
from distill_any_depth_tpu_torch.parallel.tp import all_reduce_max

__all__ = ["QUANT_IMPLS", "quantize_rows", "quantize_weight", "quantize_cols",
           "int_product_exact", "int8_matmul", "shard_product", "QuantLinear"]

# model-level ``quant`` mode -> QuantLinear impl
QUANT_IMPLS = {"int8": "xla", "int8_pallas": "pallas"}


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
                  impl: str) -> torch.Tensor:
    """A row-parallel shard's dequantized product in fp32: ``x [M, k]`` (a
    slice of each row) quantized at the global row absmax ``amax [M, 1]``,
    times ``wq [N, k]`` (the same slice of the weight's rows, quantized at
    the unsharded rows' scales ``ws [N]``). ``impl="pallas"`` runs kernel 9
    on x in fp32 with 16 more columns, the first holding ``amax``, against
    16 zero weight columns: its own row absmax is then the global one and
    its product unchanged."""
    if impl == "pallas":
        xa = torch.cat([x.float(), amax, amax.new_zeros(x.shape[0], 15)], -1)
        padded = torch.cat([wq, wq.new_zeros(wq.shape[0], 16)], 1)
        return w8a8_matmul(xa, None, None, torch.float32, quantized=(padded, ws))
    xq, xs = quantize_rows(x, amax)
    return _int_product(xq, wq) * xs * ws


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

    reduce_group = None  # the model group of a row-parallel shard

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
                amax = None
                if self.reduce_group is not None:
                    # a shard's rows are slices of the unsharded rows: their
                    # scales come from the absmax over every shard
                    amax = all_reduce_max(w.float().abs().amax(-1, keepdim=True),
                                          self.reduce_group)
                wq, ws = quantize_rows(w, amax)
                self._quantized = (key, wq, ws[:, 0])
        return self._quantized[1:]

    def _row_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's fp32 partial products at the global scales, summed
        over the model group, then the bias as the route adds it."""
        wq, ws = self.quantized_weight()
        *lead, k = x.shape
        x2 = x.reshape(-1, k)
        amax = all_reduce_max(x2.float().abs().amax(-1, keepdim=True), self.reduce_group)
        y = shard_product(x2, amax, wq, ws, self.impl)
        dist.all_reduce(y, group=self.reduce_group)
        if self.bias is None:
            y = y.to(x.dtype)
        elif self.impl == "pallas":
            y = (y + self.bias.float()).to(x.dtype)
        else:
            y = y.to(x.dtype) + self.bias.to(x.dtype)
        return y.reshape(*lead, wq.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            raise RuntimeError("int8 GEMMs are inference-only: run under torch.no_grad() "
                               "or freeze the weights (a model that trains keeps quant='none')")
        if self.reduce_group is not None:
            return self._row_parallel(x)
        matmul = w8a8_matmul if self.impl == "pallas" else int8_matmul
        # a trace (torch.export) has no storage to key the cache on: the
        # weight is quantized in the traced graph
        quantized = (quantize_weight(self.weight) if torch.compiler.is_compiling()
                     else self.quantized_weight())
        return matmul(x, self.weight, self.bias, x.dtype, quantized=quantized)
