"""The PEG conv (CPVT's position encoding, ``models/vit.PosConv``): a 37 x 37
depthwise conv with zero padding 18 over ``x [B, C, H, W]``, plus its bias
and its identity, ``conv(x) + bias + x``; its backward; and their plain
versions.

It replaces no TPU kernel: the JAX package leaves the PEG to flax's grouped
``nn.Conv``, that is to XLA, forward and backward. On the card ATen ran the
conv as its generic depthwise kernel (fp32 FMAs on CUDA cores; 17.0 ms at
the windowed teacher's 1036^2 bs8, 0.55% of the bound) and ``+ x`` as a
second pass, and the backward as its depthwise d(x) and d(weight) kernels
(178 ms at the windowed student's 1036^2 bs16, 0.31% of the bound). All
three are bound by operations. The kernels (``csrc/peg_conv.cu``) run the
conv as banded Toeplitz products on the tensor cores (bf16 in, fp32
accumulators), add the bias and ``x`` in fp32 and round once. The backward
is an autograd Function whose one op call (``kernels/peg_conv_bwd``) runs
d(x) as the forward on the cotangent with the kernel flipped and no bias
(the identity's gradient is the cotangent, the forward's ``+ x``), and
d(weight) as products of the two planes whose depth is the rows, summed
along their diagonals into fp32 partials a work item, which a second pass
adds in order with d(bias) and rounds once. fp32, and bf16 grids wider than
80 or taller than 384, take direct CUDA-core kernels of the same file. No
atomics: two calls give the same bits. Every forward counts
``kernels/peg_conv`` once, every backward ``kernels/peg_conv_bwd`` once.

A CPU tensor takes the plain version, ``F.conv2d(x, w, b, padding=18,
groups=C) + x``, and autograd's backward of it. Under tracing
(``torch.export``) without a gradient the wrapper calls the op
``dad::peg_conv``, which ``utils/export`` registers by importing this
module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.ops._build import DTYPES, Kernel, host_int

__all__ = ["TAPS", "PAD", "peg_conv", "peg_conv_reference", "peg_conv_backward"]

TAPS, PAD = 37, 18

# x, the weights [C, 37 * 37], the bias, the output; B, C, H, W, the dtype code
_FWD = Kernel("peg_conv", "dad_peg_conv_fwd", "ppppiiiii", "PEG conv", "peg_conv")
# g, x, the weights flipped [C, 37 * 37], zeros [C], dx, dweight, dbias, the
# fp32 scratch; B, C, H, W, the dtype code
_BWD = Kernel("peg_conv", "dad_peg_conv_bwd", "ppppppppiiiii", "PEG conv backward",
              "peg_conv_bwd")


def peg_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv2d(x, weight, bias, padding=18, groups=C) + x``."""
    return F.conv2d(x, weight, bias, padding=PAD, groups=x.shape[1]) + x


def peg_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv(x) + bias + x`` for ``x [B, C, H, W]``, ``weight [C, 1, 37,
    37]`` and ``bias [C]`` of x's dtype, as ``[B, C, H, W]`` (contiguous):
    the kernel for a CUDA tensor (with the backward kernels when an input
    requires a gradient), the plain version for a CPU tensor."""
    _check_shapes(x, weight, bias)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias))
    if torch.compiler.is_compiling() and not needs_grad:
        return torch.ops.dad.peg_conv(x, weight, bias)
    if x.device.type == "cpu":
        return peg_conv_reference(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no PEG conv kernel for device {x.device}")
    if needs_grad:
        return _PegConv.apply(x, weight, bias)
    return _forward(x, weight, bias)


def peg_conv_backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                      mask=(True, True, True)):
    """The gradients of ``conv(x) + bias + x`` for the cotangent ``g``: ``(dx,
    dweight, dbias)``, each None where ``mask`` leaves it out. The plain
    version: ATen's convolution backward on the saved input and weight, and
    ``g`` added to ``dx`` for the identity; on any device."""
    c = x.shape[1]
    dx, dw, db = torch.ops.aten.convolution_backward(
        g, x, weight, [c], [1, 1], [PAD, PAD], [1, 1], False, [0, 0], c, list(mask))
    return (dx + g if mask[0] else None), dw, db


class _PegConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _forward(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return _backward(g, x, weight, ctx.needs_input_grad)


def _check_shapes(x, weight, bias) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be [B, C, H, W]; got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, 1, TAPS, TAPS) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight must be [{c}, 1, {TAPS}, {TAPS}] and bias [{c}]; got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")


def _check_kernel_inputs(x, **others) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the PEG conv kernel takes a CUDA tensor, not {x.device}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in others.values()):
        raise TypeError("the PEG conv kernel takes bfloat16 or float32 of one dtype, not "
                        + ", ".join(f"{k} {t.dtype}" for k, t in {"x": x, **others}.items()))


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check_kernel_inputs(x, weight=weight, bias=bias)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        b, c, h, w = x.shape
        _FWD([x, weight.reshape(c, TAPS * TAPS).contiguous(), bias.contiguous(), out],
             b, c, h, w, DTYPES[x.dtype])
    return out


def _backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mask):
    """The backward kernels on CUDA tensors: ``(dx, dweight, dbias)`` as
    ``peg_conv_backward`` gives them, each None where ``mask`` leaves it
    out, in x's dtype, with one launch count."""
    _check_kernel_inputs(x, weight=weight, cotangent=g)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"the cotangent must match x {tuple(x.shape)} on {x.device}; got "
                         f"{tuple(g.shape)} on {g.device}")
    want_dx, want_dw, want_db = (bool(m) for m in mask)
    b, c, h, w = x.shape
    g, x = g.contiguous(), x.contiguous()
    dx = torch.empty_like(x) if want_dx else None
    dw = torch.empty_like(weight, memory_format=torch.contiguous_format) if want_dw else None
    db = x.new_empty(c) if want_db else None
    if not x.numel():
        return dx, None if dw is None else dw.zero_(), None if db is None else db.zero_()
    flipped = weight.flip(-2, -1).reshape(c, TAPS * TAPS) if want_dx else None
    zeros = x.new_zeros(c) if want_dx else None
    code = DTYPES[x.dtype]
    scratch = None
    if want_dw or want_db:  # a partial of 37^2 + 1 floats for each work item of a channel
        nbytes = host_int("peg_conv", "dad_peg_conv_bwd_scratch", b, c, h, w, code)
        scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    _BWD([g, x, flipped, zeros, dx, dw, db, scratch], b, c, h, w, code)
    return dx, dw, db


# ------------------------------------------------------------------ the op torch.export keeps
@torch.library.custom_op("dad::peg_conv", mutates_args=(), device_types="cuda")
def _peg_conv_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward kernel."""
    return _forward(x, weight, bias)


@_peg_conv_op.register_kernel("cpu")
def _(x, weight, bias):
    return peg_conv_reference(x, weight, bias)


@_peg_conv_op.register_fake
def _(x, weight, bias):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
