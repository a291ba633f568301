"""DPT-head tail: the CUDA kernel and its plain version.

Counterpart of distill_any_depth_tpu/ops/dpt_tail.py ``fused_dpt_tail_v2``
(TPU kernel ``_tail_kernel_v2``), with the contract of its
``tail_reference``:

    t [B, ht, wt, C] -> bilinear x2 (align_corners) -> conv3x3 C->C/2 + b1
      -> bilinear to (oh, ow) (align_corners) -> conv3x3 C/2->32 + b2 -> ReLU
      -> 1x1 32->1 + bd [-> ReLU]                      -> [B, oh, ow]

Layouts follow the JAX contract: ``t`` channels-last, ``k1``/``k2`` HWIO,
``kd`` ``[32, 1]``. The kernel (``csrc/dpt_tail.cu``, two launches) takes
C in {64, 128, 256, 384}, the DPT features of every preset (384: ViT-g's),
and raises on any other width; its header states its bound on the H100
and its design. Its bf16 convs read the weights packed by ``pack_conv_weight``
(``prepare_weights``; the DPT head keeps them in an ``ops/derived.Derived``
until a weight changes). Forward only.

The kernel is also the op ``dad::dpt_tail`` on the prepared weights
(``prepare_weights``): the kernel on the card, the plain version on the CPU
(the weights unpacked again), a fake implementation for tracing. Under
tracing (``torch.export``) ``fused_dpt_tail`` prepares the weights in the
traced graph and calls the op, so that an exported program keeps the tail
as one node; eagerly it calls the kernel itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.ops._build import DTYPES, Kernel

__all__ = ["fused_dpt_tail", "tail_reference", "pack_conv_weight", "unpack_conv_weight",
           "prepare_weights", "TailWeights"]

_CHANNELS = (64, 128, 256, 384)
_C2 = 32
# kernel 2's two launches, counted once as "tail": conv1 (t, w1, b1, v; B, ht,
# wt, C, the dtype code), then the head (v, w2, b2, kd, bd, out; B, hv, wv,
# C / 2, oh, ow, relu, the dtype code)
_CONV1 = Kernel("dpt_tail", "dad_tail_conv1", "ppppiiiii", "DPT tail conv1", None)
_HEAD = Kernel("dpt_tail", "dad_tail_head", "ppppppiiiiiiii", "DPT tail head", "tail")


def tail_reference(t, out_hw, k1, b1, k2, b2, kd, bd, *, trailing_relu):
    """Plain PyTorch tail, computed in ``t``'s dtype (the chain the kernel
    implements)."""
    dtype = t.dtype
    x = t.permute(0, 3, 1, 2)
    u = F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                      align_corners=True)
    v = F.conv2d(u, k1.to(dtype).permute(3, 2, 0, 1), b1.to(dtype), padding=1)
    w = F.interpolate(v, size=tuple(out_hw), mode="bilinear", align_corners=True)
    z = F.relu(F.conv2d(w, k2.to(dtype).permute(3, 2, 0, 1), b2.to(dtype), padding=1))
    d = F.conv2d(z, kd.to(dtype).t()[:, :, None, None], bd.to(dtype))
    if trailing_relu:
        d = F.relu(d)
    return d[:, 0]


def pack_conv_weight(k: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C_in, C_out]`` conv weight -> the bf16 ``[C_out, chunks
    * 9 * 64]`` matrix the bf16 kernel streams by TMA: row n holds, for each
    64-channel chunk of C_in (zero-padded to 64) and each tap, that tap's 64
    weights into output channel n. Element ``(n, (cc * 9 + tap) * 64 + ci)``
    is ``k[tap // 3, tap % 3, 64 * cc + ci, n]``."""
    kh, kw, cin, cout = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 HWIO weight, got {tuple(k.shape)}")
    cinp = -(-cin // 64) * 64
    w = F.pad(k.detach().to(torch.bfloat16).reshape(9, cin, cout), (0, 0, 0, cinp - cin))
    return w.reshape(9, cinp // 64, 64, cout).permute(3, 1, 0, 2).reshape(cout, -1).contiguous()


def unpack_conv_weight(w: torch.Tensor, cin: int) -> torch.Tensor:
    """``pack_conv_weight``'s inverse: the HWIO ``[3, 3, cin, C_out]``
    weight (in bf16) from its packed ``[C_out, chunks * 9 * 64]`` matrix."""
    cout = w.shape[0]
    w = w.reshape(cout, -1, 9, 64).permute(2, 1, 3, 0).reshape(9, -1, cout)
    return w[:, :cin].reshape(3, 3, cin, cout)


class TailWeights(NamedTuple):
    """The tail's weights as the kernel reads them, for one compute dtype:
    w1 and w2 packed (bf16, ``pack_conv_weight``) or the plain ``[9 * C_in,
    C_out]`` matrices (fp32); the biases and the head rounded to the compute
    dtype, as the plain version uses them, and held in fp32."""

    w1: torch.Tensor
    w2: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    kd: torch.Tensor
    bd: torch.Tensor


def prepare_weights(k1, b1, k2, b2, kd, bd, dtype: torch.dtype) -> TailWeights:
    """The kernel's operands for compute ``dtype`` from the JAX-layout
    weights (HWIO k1, k2; kd ``[32, 1]``)."""
    if dtype == torch.bfloat16:
        w1, w2 = pack_conv_weight(k1), pack_conv_weight(k2)
    else:
        w1 = k1.detach().to(dtype).reshape(-1, k1.shape[-1]).contiguous()
        w2 = k2.detach().to(dtype).reshape(-1, k2.shape[-1]).contiguous()
    small = (a.detach().to(dtype).float().reshape(-1).contiguous() for a in (b1, b2, kd, bd))
    return TailWeights(w1, w2, *small)


def fused_dpt_tail(t, out_hw, k1, b1, k2, b2, kd, bd, *, trailing_relu,
                   weights: TailWeights | None = None):
    """The tail on ``t``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Returns ``[B, oh, ow]`` in ``t``'s dtype.
    ``weights``: the kernel's operands from ``prepare_weights`` for these
    weights and ``t``'s dtype; prepared on this call when None."""
    if torch.compiler.is_compiling():
        if weights is None:
            weights = prepare_weights(k1, b1, k2, b2, kd, bd, t.dtype)
        oh, ow = (int(x) for x in out_hw)
        return torch.ops.dad.dpt_tail(t, *weights, oh, ow, trailing_relu)
    if t.device.type == "cpu":
        return tail_reference(t, out_hw, k1, b1, k2, b2, kd, bd, trailing_relu=trailing_relu)
    if t.device.type != "cuda":
        raise ValueError(f"no DPT tail for device {t.device}")
    _check(t, k1, b1, k2, b2, kd, bd)
    if torch.is_grad_enabled() and any(
        a.requires_grad for a in (t, k1, b1, k2, b2, kd, bd)
    ):
        raise RuntimeError("the DPT tail kernel is forward-only (no backward)")
    if weights is None:
        weights = prepare_weights(k1, b1, k2, b2, kd, bd, t.dtype)
    return _launch(t, weights, out_hw, trailing_relu)


def _check(t, k1, b1, k2, b2, kd, bd) -> None:
    """The JAX-layout weights of ``t``'s width, on its device."""
    c = t.shape[-1]
    cm = c // 2
    expect = {"k1": (3, 3, c, cm), "b1": (cm,), "k2": (3, 3, cm, _C2), "b2": (_C2,),
              "kd": (_C2, 1), "bd": (1,)}
    for name, arr in zip(expect, (k1, b1, k2, b2, kd, bd)):
        if tuple(arr.shape) != expect[name] or arr.device != t.device:
            raise ValueError(f"{name}: expected {expect[name]} on {t.device}, "
                             f"got {tuple(arr.shape)} on {arr.device}")


def _launch(t: torch.Tensor, weights: TailWeights, out_hw, trailing_relu: bool) -> torch.Tensor:
    """Kernel 2's two launches on CUDA ``t`` (contiguous, aligned, bf16 or
    fp32 ``[B, ht, wt, C]`` with C in ``_CHANNELS``) with its prepared
    ``weights``."""
    if t.dtype not in DTYPES:
        raise TypeError(f"DPT tail kernel takes bfloat16 or float32, not {t.dtype}")
    if t.ndim != 4 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("DPT tail kernel needs a contiguous, 16-byte aligned [B, ht, wt, C] t")
    b, ht, wt, c = t.shape
    if c not in _CHANNELS:
        raise ValueError(f"DPT tail kernel takes C in {_CHANNELS}, got {c}")
    cm = c // 2
    oh, ow = (int(s) for s in out_hw)
    dtype = t.dtype
    w1_rows = cm if dtype == torch.bfloat16 else 9 * c
    if (weights.w1.dtype != dtype or weights.w1.shape[0] != w1_rows
            or weights.w1.device != t.device):
        raise ValueError("weights were prepared for another dtype, width or device")
    v = torch.empty((b, 2 * ht, 2 * wt, cm), dtype=dtype, device=t.device)
    out = torch.empty((b, oh, ow), dtype=dtype, device=t.device)
    code = DTYPES[dtype]
    _CONV1([t, weights.w1, weights.b1, v], b, ht, wt, c, code)
    _HEAD([v, weights.w2, weights.b2, weights.kd, weights.bd, out], b, 2 * ht, 2 * wt, cm, oh,
          ow, int(trailing_relu), code)
    return out


# ------------------------------------------------------------------ the op torch.export keeps
@torch.library.custom_op("dad::dpt_tail", mutates_args=(), device_types="cuda")
def _tail_op(t: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, b1: torch.Tensor,
             b2: torch.Tensor, kd: torch.Tensor, bd: torch.Tensor, oh: int, ow: int,
             trailing_relu: bool) -> torch.Tensor:
    """Kernel 2 on ``t [B, ht, wt, C]`` with the ``prepare_weights`` operands."""
    return _launch(t, TailWeights(w1, w2, b1, b2, kd, bd), (oh, ow), trailing_relu)


@_tail_op.register_kernel("cpu")
def _(t, w1, w2, b1, b2, kd, bd, oh, ow, trailing_relu):
    c = t.shape[3]
    if t.dtype == torch.bfloat16:
        k1, k2 = unpack_conv_weight(w1, c), unpack_conv_weight(w2, c // 2)
    else:
        k1, k2 = w1.reshape(3, 3, c, -1), w2.reshape(3, 3, c // 2, -1)
    return tail_reference(t, (oh, ow), k1, b1, k2, b2, kd.reshape(-1, 1), bd,
                          trailing_relu=trailing_relu)


@_tail_op.register_fake
def _(t, w1, w2, b1, b2, kd, bd, oh, ow, trailing_relu):
    return t.new_empty((t.shape[0], oh, ow))
