"""Attention kernels and their plain versions.

Counterpart of distill_any_depth_tpu/ops/flash_attention.py:

- ``mha_flash_packed``: bias-free attention on the packed QKV (TPU kernels
  ``_packed_fwd_impl`` / ``_packed_kernel`` forward and ``_packed_bwd_impl``
  / ``_packed_bwd_kernel`` backward, joined by ``jax.custom_vjp``), CUDA
  ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``;
- ``mha_flash``: attention over ``[B, N, H, D]`` with an additive bias or a
  window band, dispatched as the JAX ``mha_flash`` does to
  ``mha_flash_bias`` (TPU ``_flash_fwd_impl``, CUDA
  ``csrc/flash_attention_bias.cu``) or ``mha_flash_banded`` (TPU
  ``_banded_fwd_impl``, CUDA ``csrc/flash_attention_banded.cu``). Both are
  forward-only on the card.

The kernels' headers state their bounds on the H100 and what their designs
do about them.

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

__all__ = ["mha_flash_packed", "mha_packed_reference", "packed_attention_backward",
           "mha_flash", "mha_flash_bias", "mha_flash_banded", "mha_bias_reference",
           "mha_banded_reference", "banded_eligible"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIM = 64
_TILE = 64  # key tile of the online softmax (the kernels' and the banded plain version's)
# Below this token count a band runs the dense bias kernel, as in the JAX
# package (its threshold; the two kernels compute the same function).
_BANDED_MIN_SEQ = 3000


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
    pointers, then ``rest`` ("i" int, "l" int64, "f" float, "p" pointer)."""
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        kinds = {"i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float,
                 "p": ctypes.c_void_p}
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [kinds[k] for k in rest]
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------ biased and banded attention
def mha_bias_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch attention over ``[B, N, H, D]`` with ``_attn_kernel``'s
    numerics: fp32 scores ``(q.k) * D**-0.5 + bias``, ``exp(s - max)``
    rounded to the input dtype before both the row sum and the PV product,
    the division after PV. ``bias``: ``[N, N]``, ``[H, N, N]`` or None. A row
    with no finite score gives 0 (the JAX dense kernel gives NaN there)."""
    d = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, N, D]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(m == -torch.inf, 0.0, m)).to(q.dtype)
    denom = e.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(e.float(), vf) / torch.where(denom == 0, 1.0, denom)
    return o.to(q.dtype).transpose(1, 2)


def _band_tiles(n: int, gh: int, gw: int, half: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First and last key tile (inclusive) of each 64-row q tile's band: the
    token rows ``[clip(r0) - half, clip(r1) + half]`` of its grid rows
    ``r0..r1`` (the JAX ``_band_bounds_traced``; the kernel's ``tiles``)."""
    top = max(gh - 1 - half, half)
    q0 = torch.arange(0, n, _TILE)
    r0, r1 = q0 // gw, torch.clamp(q0 + _TILE - 1, max=n - 1) // gw
    lo = (r0.clamp(half, top) - half) * gw
    hi = torch.clamp((r1.clamp(half, top) + half + 1) * gw, max=n) - 1
    return lo // _TILE, hi // _TILE


def mha_banded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         band: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch window attention over ``[B, N, H, D]`` on a row-major
    ``(N / gw, gw)`` grid, ``band = (gw, window)``, with ``_banded_kernel``'s
    numerics: each 64-row q tile runs an online softmax over the 64-key
    tiles of its band (all q tiles at once, one band step at a time), with
    the clamped-centre window mask, exp rounded to the input dtype before
    the sum and PV, and the -inf guards that keep a row with no live key so
    far at a zero correction. Equal to ``mha_bias_reference`` with
    ``ops/window.local_window_bias(gh, gw, window, n_prefix=0)`` but for
    the rounding of the online softmax."""
    b, n, h, d = q.shape
    gw, window = band
    gh, half = n // gw, window // 2
    dev = q.device
    j0, j1 = (x.to(dev) for x in _band_tiles(n, gh, gw, half))
    nq = j0.numel()
    nspan = int((j1 - j0).max()) + 1

    def tiles(x):  # [B, N, H, D] -> fp32 [B, H, nq, 64, D], zero rows past N
        x = x.float().transpose(1, 2)
        x = torch.nn.functional.pad(x, (0, 0, 0, nq * _TILE - n))
        return x.reshape(b, h, nq, _TILE, d)

    qt, kt, vt = tiles(q), tiles(k), tiles(v)
    tok = torch.arange(nq * _TILE, device=dev)
    cy = (tok // gw).clamp(half, max(gh - 1 - half, half)).view(nq, _TILE, 1)
    cx = (tok % gw).clamp(half, max(gw - 1 - half, half)).view(nq, _TILE, 1)
    m = torch.full((b, h, nq, _TILE, 1), -torch.inf, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, nq, _TILE, d), device=dev)
    for step in range(nspan):
        jt = j0 + step
        live = jt <= j1  # q tiles whose band has this step
        jt = jt.clamp(max=nq - 1)
        keys = (jt[:, None] * _TILE + torch.arange(_TILE, device=dev)).view(nq, 1, _TILE)
        allowed = (((cy - keys // gw).abs() <= half) & ((cx - keys % gw).abs() <= half)
                   & (keys < n) & live.view(nq, 1, 1))
        s = torch.matmul(qt, kt[:, :, jt].transpose(-1, -2)) * d ** -0.5
        s = s.masked_fill(~allowed, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.nan_to_num(torch.exp(m - m_new), nan=0.0)  # exp(-inf - -inf)
        e = torch.exp(s - torch.where(m_new == -torch.inf, 0.0, m_new)).to(q.dtype)
        l = l * corr + e.float().sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(e.float(), vt[:, :, jt])
        m = m_new
    out = (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)
    return out.reshape(b, h, nq * _TILE, d)[:, :, :n].transpose(1, 2)


def banded_eligible(n: int, band: tuple[int, int] | None) -> bool:
    """Whether ``mha_flash`` runs ``band`` on the banded kernel: a whole grid
    of at least ``_BANDED_MIN_SEQ`` tokens (the JAX package's dispatch)."""
    return band is not None and n % band[0] == 0 and n >= _BANDED_MIN_SEQ


def _check_heads(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels read q, k, v ``[B, N, H, 64]`` in place: one shape, dtype
    and stride pattern, heads contiguous, rows and batches 16-byte aligned."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, not {q.dtype}")
    if q.shape[-1] != _HEAD_DIM:
        raise ValueError(f"{name} kernel needs head dim {_HEAD_DIM}, got {q.shape[-1]}")
    for x in (k, v):
        if x.shape != q.shape or x.dtype != q.dtype or x.stride() != q.stride() \
                or x.device != q.device:
            raise ValueError(f"{name} kernel needs q, k, v of one shape, dtype, layout and device")
    item = q.element_size()
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v))
    if q.stride(3) != 1 or q.stride(2) != _HEAD_DIM or not aligned \
            or (q.stride(1) * item) % 16 or (q.stride(0) * item) % 16:
        raise ValueError(f"{name} kernel needs [B, N, H, D] with contiguous heads and 16-byte "
                         f"aligned rows; got strides {q.stride()}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(f"the {name} kernel is forward-only: its backward is not on the "
                           f"card yet")


def _run(name: str, fn_name: str, q, k, v, ptrs, ints) -> torch.Tensor:
    """Launch ``fn_name`` of library ``name`` on q, k, v (checked), writing
    ``out [B, N, H, D]``: ``ptrs`` after q, k, v and before out, ``ints``
    after (batch, n, heads, head dim, row stride, batch stride)."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _lib(name, fn_name, 4 + len(ptrs),
               ["i"] * 4 + ["l", "l"] + ["i"] * len(ints) + ["f", "p"])
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, out.data_ptr(), b, n, h, d,
            q.stride(1), q.stride(0), *ints, d ** -0.5, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    return out


def mha_flash_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over ``[B, N, H, D]`` with an additive ``[N, N]`` bias shared
    by batch and heads (or none): kernel 5 for CUDA tensors, returning
    ``[B, N, H, D]`` contiguous; the plain version for CPU tensors. With a
    bias, one call launches two kernels (the tile marks, then attention) and
    counts as one launch."""
    if q.device.type == "cpu":
        return mha_bias_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no biased attention for device {q.device}")
    _check_heads("biased attention", q, k, v)
    n = q.shape[1]
    if bias is None:
        ptrs, bias_dtype = [None, None], -1
    else:
        if bias.shape != (n, n) or bias.dtype not in _DTYPES or bias.device != q.device:
            raise ValueError(f"biased attention kernel needs a bfloat16 or float32 [N, N] bias "
                             f"on {q.device}; got {tuple(bias.shape)} {bias.dtype} {bias.device}")
        bias = bias.contiguous()
        nt = -(-n // _TILE)
        live = torch.empty(nt * nt, dtype=torch.uint8, device=q.device)  # the kernel's tile marks
        ptrs, bias_dtype = [bias.data_ptr(), live.data_ptr()], _DTYPES[bias.dtype]
    out = _run("flash_attention_bias", "dad_bias_attention", q, k, v, ptrs,
               [_DTYPES[q.dtype], bias_dtype])
    mha_flash_bias.launches += 1
    return out


mha_flash_bias.launches = 0


def mha_flash_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     band: tuple[int, int]) -> torch.Tensor:
    """Window attention over ``[B, N, H, D]`` on a prefix-less row-major
    ``(N / gw, gw)`` grid, ``band = (gw, window)``: kernel 7 for CUDA
    tensors, returning ``[B, N, H, D]`` contiguous; the plain version for
    CPU tensors."""
    n = q.shape[1]
    gw, window = band
    if n % gw or window < 1:
        raise ValueError(f"band {band} does not fit N={n}")
    if q.device.type == "cpu":
        return mha_banded_reference(q, k, v, band)
    if q.device.type != "cuda":
        raise ValueError(f"no banded attention for device {q.device}")
    _check_heads("banded attention", q, k, v)
    out = _run("flash_attention_banded", "dad_banded_attention", q, k, v, [],
               [n // gw, gw, window, _DTYPES[q.dtype]])
    mha_flash_banded.launches += 1
    return out


mha_flash_banded.launches = 0


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None,
              band: tuple[int, int] | None = None) -> torch.Tensor:
    """Attention over ``[B, N, H, D]`` with an optional additive bias
    (``[N, N]`` or ``[1, N, N]`` shared by batch and heads, or per-head
    ``[H, N, N]``), dispatched as the JAX ``mha_flash``: a per-head bias to
    the plain attention, a ``band = (gw, window)`` over a whole grid of at
    least ``_BANDED_MIN_SEQ`` tokens to ``mha_flash_banded``, everything else
    to ``mha_flash_bias``. A band asserts that the bias is the prefix-less
    local-window mask of that grid; the banded kernel computes the mask
    itself, so a band needs no bias beside it here (the JAX package needs
    both)."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, N, H, D]; got {tuple(q.shape)}")
    if bias is not None:
        if bias.ndim == 3 and bias.shape[0] == 1:
            bias = bias[0]
        elif bias.ndim == 3:
            return mha_bias_reference(q, k, v, bias)
        elif bias.ndim != 2:
            raise ValueError(f"bias shape {tuple(bias.shape)}")
    if banded_eligible(q.shape[1], band):
        return mha_flash_banded(q, k, v, band)
    return mha_flash_bias(q, k, v, bias)
