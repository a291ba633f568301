"""Packed-QKV attention forward: the CUDA kernel and its plain version.

Counterpart of distill_any_depth_tpu/ops/flash_attention.py
``mha_flash_packed`` (TPU kernel ``_packed_fwd_impl`` / ``_packed_kernel``).
The kernel is ``csrc/flash_attention.cu``; its header states its bound on
the H100 and what its design does about it.

``qkv`` is the fused-QKV GEMM output ``[B, N, 3*H*D]`` in the column order
(q|k|v, head, dim); the result is ``[B, N, H*D]`` in (head, dim) order,
ready for the output projection. Forward only: the kernel has no backward
yet, so the CUDA path refuses tensors that require a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from distill_any_depth_tpu_torch.ops import _build

__all__ = ["mha_flash_packed", "mha_packed_reference"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIM = 64


def mha_packed_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention with ``_packed_kernel``'s numerics: fp32
    scores ``(q.k) * D**-0.5`` and softmax, ``exp(s - max)`` rounded to the
    input dtype before the PV product, the fp32 sum of the rounded values,
    and the division after PV."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = qkv.view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, N, D] each
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(qkv.dtype)
    denom = e.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(e.float(), v.float()) / denom
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, c)


def mha_flash_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention on packed ``qkv``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={num_heads}; got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return mha_packed_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"packed attention kernel takes bfloat16 or float32, not {qkv.dtype}")
    if d != _HEAD_DIM:
        raise ValueError(f"packed attention kernel needs head dim {_HEAD_DIM}, got {d}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed attention kernel needs a contiguous, 16-byte aligned qkv")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("the packed attention kernel is forward-only (no backward yet)")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dad_packed_attention(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, _DTYPES[qkv.dtype],
            d ** -0.5, stream,
        )
    if err:
        raise RuntimeError(f"packed attention kernel launch failed (error {err})")
    mha_flash_packed.launches += 1
    return out


mha_flash_packed.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.dad_packed_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
