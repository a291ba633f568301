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

The row and weight quantization (``quantize_rows``, ``quantize_weight``)
and the exact integer product live here, so that the op ``dad::w8a8_matmul``
(``torch.export`` keeps it as one node; ``utils/export``) is registered by
a module that imports nothing of ``models/``. Every division is a true
division: on the card PyTorch divides a tensor by a Python number as a
product with its reciprocal, which can differ in the last bit and flip a
round-half-even tie, so the scales divide by a 0-dim tensor.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops._build import DTYPES, Kernel

__all__ = ["quantize_rows", "quantize_weight", "int_product_exact", "w8a8_matmul",
           "w8a8_reference"]

_EPS = 1e-8
# x, wq, ws, bias, out, the workspace xq and xs; M, N, K, the dtype code
_W8A8 = Kernel("w8a8_matmul", "dad_w8a8_matmul", "pppppppiiii", "W8A8", "w8a8")


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true division (NaN stays NaN)."""
    return amax.clamp_min(_EPS) / amax.new_full((), 127.0)


def quantize_rows(x: torch.Tensor,
                  amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization along the last axis: ``(xq int8,
    scale fp32 [..., 1])`` with ``x ~= xq * scale``; ``amax [..., 1]``, when
    given, replaces the rows' own absmax (a shard's rows take the global
    one)."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True) if amax is None else amax)
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A Linear's ``[out, in]`` weight per output channel: ``(wq int8 [out,
    in], scale fp32 [out])``."""
    wq, scale = quantize_rows(weight)
    return wq, scale[:, 0]


def int_product_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [N, K]^T`` of int8 values, exactly, as fp64: every
    partial sum is an integer below K * 127^2 < 2^53, so any summation order
    is exact. It uses no int8 library call, and BLAS makes it fast on the
    CPU (an int64 matmul has no BLAS path there)."""
    return xq.double() @ wq.double().t()


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
    for a CPU tensor, and the op ``dad::w8a8_matmul`` under tracing
    (``torch.export``). ``quantized = (wq [N, K] int8, ws [N] fp32)`` skips
    the weight quantization."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    *lead, k = x.shape
    wq, ws = quantize_weight(weight) if quantized is None else quantized
    n = wq.shape[0]
    x2 = x.reshape(-1, k)
    if torch.compiler.is_compiling():
        return torch.ops.dad.w8a8_matmul(x2, wq, ws, bias, out_dtype).reshape(*lead, n)
    if x.device.type == "cpu":
        return w8a8_reference(x2, wq, ws, bias, out_dtype).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A8 GEMM for device {x.device}")
    if torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in (x, weight, bias)
    ):
        raise RuntimeError("the W8A8 kernel is forward-only (no backward)")
    return _launch(x2, wq, ws, bias, out_dtype).reshape(*lead, n)


def _launch(x2: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor | None,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel 9 on CUDA ``x2 [M, K]``: checks the operands, returns ``[M, N]``."""
    m, k = x2.shape
    n = wq.shape[0]
    if x2.dtype not in DTYPES or out_dtype != x2.dtype:
        raise TypeError(f"W8A8 kernel takes bfloat16 or float32 x and writes its dtype, not "
                        f"{x2.dtype} -> {out_dtype}")
    if k % 16 or n % 2:
        raise ValueError(f"W8A8 kernel needs K a multiple of 16 and an even N, got K={k} N={n}")
    if (wq.dtype != torch.int8 or tuple(wq.shape) != (n, k) or ws.dtype != torch.float32
            or tuple(ws.shape) != (n,) or (bias is not None and tuple(bias.shape) != (n,))):
        raise ValueError(f"W8A8 kernel: expected wq int8 [{n}, {k}], ws fp32 [{n}] and bias "
                         f"[{n}], got {wq.dtype} {list(wq.shape)}, {ws.dtype} {list(ws.shape)}"
                         f", {None if bias is None else list(bias.shape)}")
    x2 = x2.contiguous()
    wq, ws = wq.contiguous(), ws.contiguous()
    b = None if bias is None else bias.float().contiguous()
    for name, a in (("x", x2), ("wq", wq), ("ws", ws), ("bias", b)):
        if a is not None and (a.device != x2.device or a.data_ptr() % 16):
            raise ValueError(f"W8A8 kernel: {name} must be 16-byte aligned on {x2.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)  # the kernels' workspace
    xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
    _W8A8([x2, wq, ws, b, out, xq, xs], m, n, k, DTYPES[x2.dtype])
    return out


# ------------------------------------------------------------------ the op torch.export keeps
@torch.library.custom_op("dad::w8a8_matmul", mutates_args=(), device_types="cuda")
def _w8a8_op(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor | None,
             out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel 9 on ``x [M, K]``."""
    return _launch(x, wq, ws, bias, out_dtype)


@_w8a8_op.register_kernel("cpu")
def _(x, wq, ws, bias, out_dtype):
    return w8a8_reference(x, wq, ws, bias, out_dtype)


@_w8a8_op.register_fake
def _(x, wq, ws, bias, out_dtype):
    return x.new_empty((x.shape[0], wq.shape[0]), dtype=out_dtype)
