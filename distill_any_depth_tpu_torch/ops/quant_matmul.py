"""Kernel 9: the W8A8 GEMM with dynamic per-row activation quantization,
and its plain version.

Counterpart of distill_any_depth_tpu/ops/quant_matmul.py (``w8a8_matmul``,
TPU kernel ``_w8a8_2d``): ``x @ weight.T (+ bias)`` with x quantized per row
to int8, the weight per output channel, an int32 product and an fp32
dequant epilogue ``((acc * row_scale) * col_scale) + bias``, cast once to
the output dtype. On the card one call starts two kernels: a pass that
quantizes each row of x once into an int8 workspace (with its row scales),
then the int8 GEMM on ``wgmma`` with TMA loads and the epilogue; it counts
as one launch.
The numerics are those of ``ops/quant.int8_matmul`` except where the bias
is added (there after the cast, in the output dtype), as in the JAX package.

``weight`` is the Linear's fp32 ``[out, in]`` parameter (the JAX function
takes ``[in, out]``), quantized per output channel here unless the caller
hands over its cached ``(wq, ws)``. The kernel (``csrc/w8a8_matmul.cu``)
takes bf16 or fp32 x, writes x's dtype, and needs K a multiple of 16 and an
even N; its header states its bound on the H100 and its design. Forward
only.
"""
from __future__ import annotations

import ctypes

import torch

from distill_any_depth_tpu_torch.ops import _build
from distill_any_depth_tpu_torch.ops.quant import (
    int_product_exact,
    quantize_rows,
    quantize_weight,
)

__all__ = ["w8a8_matmul", "w8a8_reference"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def w8a8_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the kernel on ``x [M, K]``, ``wq [N, K]`` int8 and
    ``ws [N]`` fp32: the same row quantization, the integer product exactly
    (``ops/quant.int_product_exact``, no int8 library call), the same
    dequant in the same order, the bias in fp32, one cast."""
    xq, xs = quantize_rows(x)
    y = int_product_exact(xq, wq).float() * xs * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def w8a8_matmul(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None, *, quantized=None) -> torch.Tensor:
    """``x [..., K] @ weight.T (+ bias)`` -> ``[..., N]`` in ``out_dtype``
    (x's dtype by default): kernel 9 for a CUDA tensor, the plain version
    for a CPU tensor. ``quantized = (wq [N, K] int8, ws [N] fp32)`` skips
    the weight quantization."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    *lead, k = x.shape
    wq, ws = quantize_weight(weight) if quantized is None else quantized
    n = wq.shape[0]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return w8a8_reference(x2, wq, ws, bias, out_dtype).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A8 GEMM for device {x.device}")
    if x.dtype not in _DTYPES or out_dtype != x.dtype:
        raise TypeError(f"W8A8 kernel takes bfloat16 or float32 x and writes its dtype, not "
                        f"{x.dtype} -> {out_dtype}")
    if k % 16 or n % 2:
        raise ValueError(f"W8A8 kernel needs K a multiple of 16 and an even N, got K={k} N={n}")
    if (wq.dtype != torch.int8 or tuple(wq.shape) != (n, k) or ws.dtype != torch.float32
            or tuple(ws.shape) != (n,) or (bias is not None and tuple(bias.shape) != (n,))):
        raise ValueError(f"W8A8 kernel: expected wq int8 [{n}, {k}], ws fp32 [{n}] and bias "
                         f"[{n}], got {wq.dtype} {list(wq.shape)}, {ws.dtype} {list(ws.shape)}"
                         f", {None if bias is None else list(bias.shape)}")
    if torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in (x, weight, bias)
    ):
        raise RuntimeError("the W8A8 kernel is forward-only (no backward)")
    x2 = x2.contiguous()
    wq, ws = wq.contiguous(), ws.contiguous()
    b = None if bias is None else bias.float().contiguous()
    for name, a in (("x", x2), ("wq", wq), ("ws", ws), ("bias", b)):
        if a is not None and (a.device != x.device or a.data_ptr() % 16):
            raise ValueError(f"W8A8 kernel: {name} must be 16-byte aligned on {x.device}")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)  # the kernels' workspace
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dad_w8a8_matmul(x2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                  None if b is None else b.data_ptr(), out.data_ptr(),
                                  xq.data_ptr(), xs.data_ptr(), m, n, k, _DTYPES[x.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"W8A8 kernel launch failed (error {err})")
    w8a8_matmul.launches += 1
    return out.reshape(*lead, n)


w8a8_matmul.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("w8a8_matmul")
    if lib.dad_w8a8_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dad_w8a8_matmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.dad_w8a8_matmul.restype = i
    return lib
