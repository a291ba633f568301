"""DPT-head tail: the CUDA kernel and its plain version.

Counterpart of distill_any_depth_tpu/ops/dpt_tail.py ``fused_dpt_tail_v2``
(TPU kernel ``_tail_kernel_v2``), with the contract of its
``tail_reference``:

    t [B, ht, wt, C] -> bilinear x2 (align_corners) -> conv3x3 C->C/2 + b1
      -> bilinear to (oh, ow) (align_corners) -> conv3x3 C/2->32 + b2 -> ReLU
      -> 1x1 32->1 + bd [-> ReLU]                      -> [B, oh, ow]

Layouts follow the JAX contract: ``t`` channels-last, ``k1``/``k2`` HWIO,
``kd`` ``[32, 1]``. The kernel (``csrc/dpt_tail.cu``, two launches) takes
C in {64, 128, 256}; its header states its bound on the H100 and its
design. Forward only.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.ops import _build

__all__ = ["fused_dpt_tail", "tail_reference", "pack_b_fragments"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_CHANNELS = (64, 128, 256)
_C2 = 32


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


def pack_b_fragments(bmat: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` bf16 GEMM B matrix -> mma.sync m16n8k16 B-fragment order.

    Element (k, n) with k = 16*ks + 8*half + 2*t + pair and
    n = 8*(2*np + jj) + g goes to ``[ks, np, lane = 4*g + t, jj, half, pair]``:
    one 16-byte load per lane yields the (b0, b1) registers of n-tiles 2*np
    and 2*np + 1 for k-step ks.
    """
    k, n = bmat.shape
    if k % 16 or n % 16:
        raise ValueError(f"B matrix {k}x{n} must be a multiple of 16 both ways")
    v = bmat.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)
    return v.permute(0, 4, 6, 2, 5, 1, 3).reshape(k // 16, n // 16, 32, 2, 2, 2)


def fused_dpt_tail(t, out_hw, k1, b1, k2, b2, kd, bd, *, trailing_relu):
    """The tail on ``t``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Returns ``[B, oh, ow]`` in ``t``'s dtype."""
    if t.device.type == "cpu":
        return tail_reference(t, out_hw, k1, b1, k2, b2, kd, bd, trailing_relu=trailing_relu)
    if t.device.type != "cuda":
        raise ValueError(f"no DPT tail for device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"DPT tail kernel takes bfloat16 or float32, not {t.dtype}")
    if t.ndim != 4 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("DPT tail kernel needs a contiguous, 16-byte aligned [B, ht, wt, C] t")
    b, ht, wt, c = t.shape
    cm = c // 2
    oh, ow = (int(s) for s in out_hw)
    if c not in _CHANNELS:
        raise ValueError(f"DPT tail kernel takes C in {_CHANNELS}, got {c}")
    expect = {"k1": (3, 3, c, cm), "b1": (cm,), "k2": (3, 3, cm, _C2), "b2": (_C2,),
              "kd": (_C2, 1), "bd": (1,)}
    for name, arr in zip(expect, (k1, b1, k2, b2, kd, bd)):
        if tuple(arr.shape) != expect[name] or arr.device != t.device:
            raise ValueError(f"{name}: expected {expect[name]} on {t.device}, "
                             f"got {tuple(arr.shape)} on {arr.device}")
    if torch.is_grad_enabled() and any(
        a.requires_grad for a in (t, k1, b1, k2, b2, kd, bd)
    ):
        raise RuntimeError("the DPT tail kernel is forward-only (no backward)")

    dtype = t.dtype
    if dtype == torch.bfloat16:
        w1 = pack_b_fragments(k1.to(dtype).reshape(9 * c, cm))
        w2 = pack_b_fragments(k2.to(dtype).reshape(9 * cm, _C2))
    else:
        w1 = k1.to(dtype).reshape(9 * c, cm).contiguous()
        w2 = k2.to(dtype).reshape(9 * cm, _C2).contiguous()
    # biases and the head weights are rounded to the compute dtype, as the
    # plain version uses them, then handed over in fp32
    b1f, b2f, kdf, bdf = (a.to(dtype).float().reshape(-1).contiguous()
                          for a in (b1, b2, kd, bd))
    v = torch.empty((b, 2 * ht, 2 * wt, cm), dtype=dtype, device=t.device)
    out = torch.empty((b, oh, ow), dtype=dtype, device=t.device)
    lib = _lib()
    code = _DTYPES[dtype]
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dad_tail_conv1(t.data_ptr(), w1.data_ptr(), b1f.data_ptr(), v.data_ptr(),
                                 b, ht, wt, c, code, stream)
        if err:
            raise RuntimeError(f"DPT tail conv1 launch failed (error {err})")
        err = lib.dad_tail_head(v.data_ptr(), w2.data_ptr(), b2f.data_ptr(), kdf.data_ptr(),
                                bdf.data_ptr(), out.data_ptr(), b, 2 * ht, 2 * wt, cm, oh, ow,
                                int(trailing_relu), code, stream)
    if err:
        raise RuntimeError(f"DPT tail head launch failed (error {err})")
    fused_dpt_tail.launches += 1
    return out


fused_dpt_tail.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("dpt_tail")
    if lib.dad_tail_conv1.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dad_tail_conv1.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.dad_tail_conv1.restype = i
        lib.dad_tail_head.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.dad_tail_head.restype = i
    return lib
