"""The SwiGLU gate: ``silu(x1) * x2`` on the packed output ``x12 [..., 2h]``
of the FFN's ``w12`` projection (``models/vit.SwiGLU``), and its plain
version.

It replaces no TPU kernel: the JAX package leaves ``jax.nn.silu(x1) * x2`` to
XLA, which fuses it into one pass. On the card ATen ran it as two kernels over
w12's strided halves (row stride 2h), both on its non-vectorized path: the
SiLU into an ``[M, h]`` temporary, then the product reading it back. The
kernel (``csrc/swiglu_gate.cu``) is bound by its bytes, ``3 * M * h``
elements (x1 and x2 read once, the product written once), and moves them
once, in 16-byte loads and stores, computing in fp32 and rounding once to
x12's dtype (bf16 or fp32). Its backward, a second kernel of the same file,
writes ``dx12 = [g * x2 * silu'(x1) | g * silu(x1)]`` in one pass
(``5 * M * h`` elements); an autograd Function joins the two.

A CPU tensor takes the plain version, ``F.silu(x1) * x2`` as ATen computes
it. Under tracing (``torch.export``) without a gradient the wrapper calls
the op ``dad::swiglu_gate``, which ``utils/export`` registers by importing
this module.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.ops._build import DTYPES, Kernel

__all__ = ["swiglu_gate", "swiglu_gate_reference", "swiglu_gate_backward"]

# x12 (and g), the output; rows, h, the dtype code, the SM count
_FWD = Kernel("swiglu_gate", "dad_swiglu_gate_fwd", "ppllii", "SwiGLU gate", "gate")
_BWD = Kernel("swiglu_gate", "dad_swiglu_gate_bwd", "pppllii", "SwiGLU gate backward", "gate")


def swiglu_gate_reference(x12: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.silu(x1) * x2`` over the halves of ``x12``."""
    x1, x2 = x12.chunk(2, dim=-1)
    return F.silu(x1) * x2


def swiglu_gate(x12: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` for ``x12 = [x1 | x2]`` along the last axis,
    ``[..., 2h]`` -> ``[..., h]``: the kernel for a CUDA tensor (with its
    backward when ``x12`` requires a gradient), the plain version for a CPU
    tensor."""
    if x12.ndim == 0 or x12.shape[-1] % 2:
        raise ValueError(f"x12 must be [..., 2h]; got {tuple(x12.shape)}")
    needs_grad = torch.is_grad_enabled() and x12.requires_grad
    if torch.compiler.is_compiling() and not needs_grad:
        return torch.ops.dad.swiglu_gate(x12)
    if x12.device.type == "cpu":
        return swiglu_gate_reference(x12)
    if x12.device.type != "cuda":
        raise ValueError(f"no SwiGLU gate kernel for device {x12.device}")
    if needs_grad:
        return _Gate.apply(x12)
    return _forward(x12)


def swiglu_gate_backward(g: torch.Tensor, x12: torch.Tensor) -> torch.Tensor:
    """The backward kernel: ``dx12 [..., 2h]`` from the cotangent ``g [...,
    h]`` of the gate's output and its input ``x12``, on the card."""
    if g.shape != (*x12.shape[:-1], x12.shape[-1] // 2) or g.dtype != x12.dtype:
        raise ValueError(f"g must be x12's dtype and shape [..., h]; got {g.dtype} "
                         f"{tuple(g.shape)} for x12 {x12.dtype} {tuple(x12.shape)}")
    x12, g = _check(x12), g.contiguous()
    dx12 = torch.empty_like(x12)
    _launch(_BWD, x12, [g, x12, dx12])
    return dx12


class _Gate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x12):
        ctx.save_for_backward(x12)
        return _forward(x12)

    @staticmethod
    def backward(ctx, g):
        (x12,) = ctx.saved_tensors
        return swiglu_gate_backward(g, x12)


def _check(x12: torch.Tensor) -> torch.Tensor:
    if x12.device.type != "cuda":
        raise ValueError(f"the SwiGLU gate kernel takes a CUDA tensor, not {x12.device}")
    if x12.dtype not in DTYPES:
        raise TypeError(f"the SwiGLU gate kernel takes bfloat16 or float32, not {x12.dtype}")
    return x12.contiguous()


def _forward(x12: torch.Tensor) -> torch.Tensor:
    x12 = _check(x12)
    out = x12.new_empty((*x12.shape[:-1], x12.shape[-1] // 2))
    _launch(_FWD, x12, [x12, out])
    return out


def _launch(kernel: Kernel, x12: torch.Tensor, tensors: list) -> None:
    """``kernel`` on the contiguous ``tensors`` with x12's rows and half
    width, its dtype and the card's SM count; nothing for an empty x12."""
    if x12.numel() == 0:
        return
    h = x12.shape[-1] // 2
    kernel(tensors, x12.numel() // (2 * h), h, DTYPES[x12.dtype], _sm_count(x12.device.index))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------------ the op torch.export keeps
@torch.library.custom_op("dad::swiglu_gate", mutates_args=(), device_types="cuda")
def _gate_op(x12: torch.Tensor) -> torch.Tensor:
    """The forward kernel on ``x12 [..., 2h]``."""
    return _forward(x12)


@_gate_op.register_kernel("cpu")
def _(x12):
    return swiglu_gate_reference(x12)


@_gate_op.register_fake
def _(x12):
    return x12.new_empty((*x12.shape[:-1], x12.shape[-1] // 2))
