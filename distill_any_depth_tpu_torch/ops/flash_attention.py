"""Packed-QKV attention: the CUDA kernels and their plain version.

Counterpart of distill_any_depth_tpu/ops/flash_attention.py
``mha_flash_packed`` (TPU kernels ``_packed_fwd_impl`` / ``_packed_kernel``
forward and ``_packed_bwd_impl`` / ``_packed_bwd_kernel`` backward, joined
by ``jax.custom_vjp``). The kernels are ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``; their headers state their bounds on the
H100 and what their designs do about them.

``qkv`` is the fused-QKV GEMM output ``[B, N, 3*H*D]`` in the column order
(q|k|v, head, dim); the result is ``[B, N, H*D]`` in (head, dim) order,
ready for the output projection. On a CUDA tensor that requires a gradient
the call is a ``torch.autograd.Function``: the forward kernel also writes
the row log-sum-exp and the backward kernel returns ``d(qkv)`` in the same
packed layout. On the CPU, autograd runs through the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from distill_any_depth_tpu_torch.ops import _build

__all__ = ["mha_flash_packed", "mha_packed_reference", "packed_attention_backward"]

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


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"packed attention kernel takes bfloat16 or float32, not {qkv.dtype}")
    if qkv.shape[-1] // 3 // num_heads != _HEAD_DIM:
        raise ValueError(f"packed attention kernel needs head dim {_HEAD_DIM}, "
                         f"got {qkv.shape[-1] // 3 // num_heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed attention kernel needs a contiguous, 16-byte aligned qkv")


def _forward(qkv: torch.Tensor, num_heads: int, with_lse: bool):
    """Kernel 1: ``out [B, N, C]`` and, if asked, ``lse [B, H, N]`` fp32."""
    b, n, c3 = qkv.shape
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    lib = _lib("flash_attention", "dad_packed_attention", 3, ["i"] * 5 + ["f", "p"])
    with torch.cuda.device(qkv.device):
        err = lib.dad_packed_attention(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, n, num_heads, _HEAD_DIM, _DTYPES[qkv.dtype], _HEAD_DIM ** -0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"packed attention kernel launch failed (error {err})")
    mha_flash_packed.launches += 1
    return out, lse


def packed_attention_backward(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                              g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 3: ``d(qkv) [B, N, 3C]`` from the forward's ``qkv``, ``out``
    and ``lse`` and the output cotangent ``g [B, N, C]`` (CUDA tensors).
    One call counts as one launch, though it starts three kernels."""
    _check(qkv, num_heads)
    b, n, c3 = qkv.shape
    if out.shape != g.shape or out.shape != (b, n, c3 // 3) or lse.shape != (b, num_heads, n):
        raise ValueError(f"packed attention backward: qkv {tuple(qkv.shape)}, out "
                         f"{tuple(out.shape)}, g {tuple(g.shape)}, lse {tuple(lse.shape)}")
    if out.dtype != qkv.dtype or g.dtype != qkv.dtype or lse.dtype != torch.float32:
        raise TypeError("packed attention backward: out and g in qkv's dtype, lse in float32")
    g = g.contiguous()
    if not (out.is_contiguous() and lse.is_contiguous()) or g.data_ptr() % 16:
        raise ValueError("packed attention backward needs contiguous, aligned operands")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    lib = _lib("flash_attention_bwd", "dad_packed_attention_bwd", 6, ["i"] * 5 + ["f", "p"])
    with torch.cuda.device(qkv.device):
        err = lib.dad_packed_attention_bwd(
            qkv.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), b, n, num_heads, _HEAD_DIM, _DTYPES[qkv.dtype], _HEAD_DIM ** -0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"packed attention backward launch failed (error {err})")
    packed_attention_backward.launches += 1
    return dqkv


packed_attention_backward.launches = 0


class _PackedAttention(torch.autograd.Function):
    """Kernel 1 (with lse) forward, kernel 3 backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        out, lse = _forward(qkv, num_heads, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        return packed_attention_backward(qkv, out, lse, g, ctx.num_heads), None


def mha_flash_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention on packed ``qkv``: the CUDA kernels for a CUDA tensor (with
    their backward when ``qkv`` requires a gradient), the plain version for a
    CPU tensor."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={num_heads}; got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return mha_packed_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    _check(qkv, num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedAttention.apply(qkv, num_heads)
    return _forward(qkv, num_heads, with_lse=False)[0]


mha_flash_packed.launches = 0


def _lib(name: str, fn_name: str, n_ptrs: int, rest: list[str]) -> ctypes.CDLL:
    """The library ``name`` with ``fn_name``'s signature set: ``n_ptrs``
    pointers, then ``rest`` ("i" int, "f" float, "p" pointer)."""
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        kinds = {"i": ctypes.c_int, "f": ctypes.c_float, "p": ctypes.c_void_p}
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [kinds[k] for k in rest]
        fn.restype = ctypes.c_int
    return lib
