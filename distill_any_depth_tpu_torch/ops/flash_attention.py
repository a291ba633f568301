"""Attention kernels and their plain versions.

Counterpart of distill_any_depth_tpu/ops/flash_attention.py:

- ``mha_flash_packed``: bias-free attention on the packed QKV (TPU kernels
  ``_packed_fwd_impl`` / ``_packed_kernel`` forward and ``_packed_bwd_impl``
  / ``_packed_bwd_kernel`` backward, joined by ``jax.custom_vjp``), CUDA
  ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``;
- ``mha_flash``: attention over ``[B, N, H, D]`` with an additive bias or a
  window band, dispatched as the JAX ``mha_flash`` does to
  ``mha_flash_bias`` (TPU ``_flash_fwd_impl`` forward and ``_flash_bwd_impl``
  backward, CUDA ``csrc/flash_attention_bias.cu`` and
  ``csrc/flash_attention_bias_bwd.cu``) or ``mha_flash_banded`` (TPU
  ``_banded_fwd_impl`` and ``_banded_bwd_impl``, CUDA
  ``csrc/flash_attention_banded.cu`` and
  ``csrc/flash_attention_banded_bwd.cu``); ``mha_flash_qkv`` is the same on
  the packed QKV, with the backward writing ``d(qkv)`` packed.

The kernels' headers state their bounds on the H100 and what their designs
do about them.

``qkv`` is the fused-QKV GEMM output ``[B, N, 3*H*D]`` in the column order
(q|k|v, head, dim); the result is ``[B, N, H*D]`` in (head, dim) order,
ready for the output projection. On a CUDA tensor that requires a gradient
each call is a ``torch.autograd.Function``: the forward kernel also writes
the row log-sum-exp and the backward kernels return the gradient in the
packed layout. On the CPU, autograd runs through the plain versions; the
plain backward versions (``*_backward_reference``) follow the backward
kernels' numerics and serve the tests and ``chip_smoke.py``.

The forwards without gradient are also registered as ops
(``dad::packed_attention``, ``dad::bias_attention``,
``dad::banded_attention``: the kernel on the card, the plain version on the
CPU, and a fake implementation for tracing). Under tracing
(``torch.compiler.is_compiling()``: ``torch.export``, ``torch.compile``) the
wrappers call the op, so that an exported program keeps each attention as
one node; eagerly they call the implementation itself, which spares the
dispatcher's cost on the host-bound forwards.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops._build import DTYPES, Kernel

__all__ = ["mha_flash_packed", "mha_packed_reference", "packed_attention_backward",
           "mha_flash", "mha_flash_qkv", "mha_flash_bias", "mha_flash_banded",
           "mha_bias_reference", "mha_banded_reference", "bias_attention_backward",
           "banded_attention_backward", "bias_attention_backward_reference",
           "banded_attention_backward_reference", "banded_eligible"]

_HEAD_DIM = 64
_SCALE = _HEAD_DIM ** -0.5
_TILE = 64  # key tile of the online softmax (the kernels' and the banded plain version's)
# Below this token count a band runs the dense bias kernel, as in the JAX
# package (its threshold; the two kernels compute the same function).
_BANDED_MIN_SEQ = 3000

# the pointers; the shape, strides and dtype codes; the scale
_K1 = Kernel("flash_attention", "dad_packed_attention", "pppiiiiif", "packed attention",
             "attention")
_K3 = Kernel("flash_attention_bwd", "dad_packed_attention_bwd", "ppppppiiiiif",
             "packed attention backward", "attention_bwd")
_K5 = Kernel("flash_attention_bias", "dad_bias_attention", "ppppppppiiiilliif",
             "biased attention", "attention_bias")
_K6 = Kernel("flash_attention_bias_bwd", "dad_bias_attention_bwd", "p" * 13 + "iiiilllliiiif",
             "biased attention backward", "attention_bias_bwd")
_K7 = Kernel("flash_attention_banded", "dad_banded_attention", "pppppiiiilliiiif",
             "banded attention", "attention_banded")
_K8 = Kernel("flash_attention_banded_bwd", "dad_banded_attention_bwd", "p" * 10 + "iiiilllliiiif",
             "banded attention backward", "attention_banded_bwd")


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
    if qkv.dtype not in DTYPES:
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
    _K1([qkv, out, lse], b, n, num_heads, _HEAD_DIM, DTYPES[qkv.dtype], _SCALE)
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
    _K3([qkv, out, g, lse, delta, dqkv], b, n, num_heads, _HEAD_DIM, DTYPES[qkv.dtype], _SCALE)
    return dqkv


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
    if torch.compiler.is_compiling() and not _needs_grad(qkv):
        return torch.ops.dad.packed_attention(qkv, num_heads)
    if qkv.device.type == "cpu":
        return mha_packed_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    _check(qkv, num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedAttention.apply(qkv, num_heads)
    return _forward(qkv, num_heads, with_lse=False)[0]


# ------------------------------------------------------------------ biased and banded attention
def mha_bias_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor | None = None, with_lse: bool = False):
    """Plain PyTorch attention over ``[B, N, H, D]`` with ``_attn_kernel``'s
    numerics: fp32 scores ``(q.k) * D**-0.5 + bias``, ``exp(s - max)``
    rounded to the input dtype before both the row sum and the PV product,
    the division after PV. ``bias``: ``[N, N]``, ``[H, N, N]`` or None. A row
    with no finite score gives 0 (the JAX dense kernel gives NaN there).
    With ``with_lse`` it returns ``(out, lse)``: the row log-sum-exp
    ``[B, H, N]`` fp32 of the rounded exponentials, +inf on a row with no
    finite score, as kernel 5 writes it for the backward."""
    d = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, N, D]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(m == -torch.inf, 0.0, m)).to(q.dtype)
    denom = e.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(e.float(), vf) / torch.where(denom == 0, 1.0, denom)
    out = o.to(q.dtype).transpose(1, 2)
    if not with_lse:
        return out
    return out, torch.where(denom == 0, torch.inf, m + torch.log(denom))[..., 0]


def bias_attention_backward_reference(q, k, v, bias, out, lse, g):
    """Plain version of kernel 6: ``(dq, dk, dv)`` ``[B, N, H, D]`` of
    ``mha_flash_bias`` from the forward's ``out`` ``[B, N, H, D]`` and row
    log-sum-exp ``lse`` ``[B, H, N]`` and the cotangent ``g``, with the
    kernel's numerics (those of kernel 3 and of the JAX banded backward):
    ``p = exp(s - lse)`` in fp32, rounded to the input dtype before the dV
    product; ``ds = p (dP - delta)``, ``delta = rowsum(g * out)``, rounded
    before the dQ and dK products; ``D**-0.5`` on the fp32 sums. The scores
    are dense, ``[B, H, N, N]`` fp32."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf, of = (x.float().transpose(1, 2) for x in (q, k, v, g, out))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    del s
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = (p * (dp - (gf * of).sum(-1, keepdim=True))).to(q.dtype).float()
    del dp
    grads = (torch.matmul(ds, kf) * scale, torch.matmul(ds.transpose(-1, -2), qf) * scale,
             torch.matmul(p.transpose(-1, -2), gf))
    return tuple(x.to(q.dtype).transpose(1, 2) for x in grads)


def _band_tiles(n: int, gh: int, gw: int, half: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First and last key tile (inclusive) of each 64-row q tile's band: the
    token rows ``[clip(r0) - half, clip(r1) + half]`` of its grid rows
    ``r0..r1`` (the JAX ``_band_bounds_traced``; the kernels' ``tiles``)."""
    top = max(gh - 1 - half, half)
    q0 = torch.arange(0, n, _TILE)
    r0, r1 = q0 // gw, torch.clamp(q0 + _TILE - 1, max=n - 1) // gw
    lo = (r0.clamp(half, top) - half) * gw
    hi = torch.clamp((r1.clamp(half, top) + half + 1) * gw, max=n) - 1
    return lo // _TILE, hi // _TILE


def _inv_band_tiles(n: int, gh: int, gw: int, half: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First and last q tile (inclusive) whose band holds a key of each
    64-key tile, covering grid rows ``c0..c1``: query rows ``[c0 - half,
    c1 + half]``, from row 0 (to the last row) where that passes the clip
    (the JAX ``_inv_band_bounds_traced``; the kernels' ``inv_tiles``)."""
    k0 = torch.arange(0, n, _TILE)
    c0, c1 = k0 // gw, torch.clamp(k0 + _TILE - 1, max=n - 1) // gw
    r_lo = torch.where(c0 - half <= half, 0, c0 - half)
    r_hi = torch.where(c1 + half >= gh - 1 - half, gh - 1, c1 + half)
    return r_lo * gw // _TILE, ((r_hi + 1) * gw - 1) // _TILE


def mha_banded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         band: tuple[int, int], with_lse: bool = False):
    """Plain PyTorch window attention over ``[B, N, H, D]`` on a row-major
    ``(N / gw, gw)`` grid, ``band = (gw, window)``, with ``_banded_kernel``'s
    numerics: each 64-row q tile runs an online softmax over the 64-key
    tiles of its band (all q tiles at once, one band step at a time), with
    the clamped-centre window mask, exp rounded to the input dtype before
    the sum and PV, and the -inf guards that keep a row with no live key so
    far at a zero correction. Equal to ``mha_bias_reference`` with
    ``ops/window.local_window_bias(gh, gw, window, n_prefix=0)`` but for
    the rounding of the online softmax. With ``with_lse``, ``(out, lse)``
    as ``mha_bias_reference`` gives them."""
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
    out = out.reshape(b, h, nq * _TILE, d)[:, :, :n].transpose(1, 2)
    if not with_lse:
        return out
    lse = torch.where(l == 0, torch.inf, m + torch.log(l))
    return out, lse.reshape(b, h, nq * _TILE)[:, :, :n]


def banded_attention_backward_reference(q, k, v, band, out, lse, g):
    """Plain version of kernel 8: ``(dq, dk, dv)`` ``[B, N, H, D]`` of
    ``mha_flash_banded`` from the forward's ``out`` and ``lse`` and the
    cotangent ``g``, with ``bias_attention_backward_reference``'s numerics,
    tile by tile as the JAX ``_banded_tile_grads`` and the kernel visit the
    tiles: dQ over each q tile's band (``_band_tiles``), dK and dV over each
    key tile's inverse band (``_inv_band_tiles``), all tiles of one step of
    the band at once. Memory is O(N * band): at 1036^2 bs16 dense fp32
    scores would take 23 GB."""
    b, n, h, d = q.shape
    gw, window = band
    gh, half = n // gw, window // 2
    scale = d ** -0.5
    dev = q.device
    nt = -(-n // _TILE)
    pad = nt * _TILE - n

    def tiles(x):  # [B, N, H, D] -> fp32 [B, H, nt, 64, D], zero rows past N
        x = torch.nn.functional.pad(x.float().transpose(1, 2), (0, 0, 0, pad))
        return x.reshape(b, h, nt, _TILE, d)

    qt, kt, vt, gt = (tiles(x) for x in (q, k, v, g))
    delta = (gt * tiles(out)).sum(-1, keepdim=True)
    lse_t = torch.nn.functional.pad(lse.float(), (0, pad), value=torch.inf)
    lse_t = lse_t.view(b, h, nt, _TILE, 1)
    # each token's clamped window centre as a query and its grid cell as a
    # key; a token past N gets a coordinate no window reaches
    tok = torch.arange(nt * _TILE, device=dev)
    real, far = tok < n, 1 << 20
    cy = torch.where(real, (tok // gw).clamp(half, max(gh - 1 - half, half)), far)
    cx = torch.where(real, (tok % gw).clamp(half, max(gw - 1 - half, half)), far)
    ky, kx = torch.where(real, tok // gw, -far), torch.where(real, tok % gw, -far)
    local = torch.arange(_TILE, device=dev)

    def tile_grads(qi, kj):
        """p and ds ``[B, H, T, 64, 64]`` of the tile pairs (qi[t], kj[t])."""
        rows = (qi[:, None] * _TILE + local)[:, :, None]
        keys = (kj[:, None] * _TILE + local)[:, None, :]
        allowed = ((cy[rows] - ky[keys]).abs() <= half) & ((cx[rows] - kx[keys]).abs() <= half)
        s = torch.matmul(qt[:, :, qi], kt[:, :, kj].transpose(-1, -2)) * scale
        p = torch.exp(s.masked_fill(~allowed, -torch.inf) - lse_t[:, :, qi]).to(q.dtype).float()
        dp = torch.matmul(gt[:, :, qi], vt[:, :, kj].transpose(-1, -2))
        return p, (p * (dp - delta[:, :, qi])).to(q.dtype).float()

    dq, dk, dv = (torch.zeros_like(qt) for _ in range(3))
    every = torch.arange(nt, device=dev)
    j0, j1 = (x.to(dev) for x in _band_tiles(n, gh, gw, half))
    for step in range(int((j1 - j0).max()) + 1):
        live = j0 + step <= j1
        qi, kj = every[live], (j0 + step)[live]
        dq[:, :, qi] += torch.matmul(tile_grads(qi, kj)[1], kt[:, :, kj])
    i0, i1 = (x.to(dev) for x in _inv_band_tiles(n, gh, gw, half))
    for step in range(int((i1 - i0).max()) + 1):
        live = i0 + step <= i1
        qi, kj = (i0 + step)[live], every[live]
        p, ds = tile_grads(qi, kj)
        dk[:, :, kj] += torch.matmul(ds.transpose(-1, -2), qt[:, :, qi])
        dv[:, :, kj] += torch.matmul(p.transpose(-1, -2), gt[:, :, qi])

    def untile(x, f):
        return (x * f).reshape(b, h, nt * _TILE, d)[:, :, :n].to(q.dtype).transpose(1, 2)

    return untile(dq, scale), untile(dk, scale), untile(dv, 1.0)


def banded_eligible(n: int, band: tuple[int, int] | None) -> bool:
    """Whether ``mha_flash`` runs ``band`` on the banded kernel: a whole grid
    of at least ``_BANDED_MIN_SEQ`` tokens (the JAX package's dispatch)."""
    return band is not None and n % band[0] == 0 and n >= _BANDED_MIN_SEQ


def _check_heads(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels read q, k, v ``[B, N, H, 64]`` in place: one shape, dtype
    and stride pattern, heads contiguous, rows and batches 16-byte aligned."""
    if q.dtype not in DTYPES:
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


def _checked_bias(bias: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    n = q.shape[1]
    if bias.shape != (n, n) or bias.dtype not in DTYPES or bias.device != q.device:
        raise ValueError(f"biased attention kernel needs a bfloat16 or float32 [N, N] bias "
                         f"on {q.device}; got {tuple(bias.shape)} {bias.dtype} {bias.device}")
    return bias.contiguous()


def _term_rows(n: int) -> int:
    """Rows and columns of the bias terms that the bf16 kernels read: N
    rounded up to 128 (their blocks' rows)."""
    return -(-n // 128) * 128


def _bias_forward(q, k, v, bias, with_lse: bool):
    """Kernel 5 on CUDA tensors: ``out [B, N, H, D]``, the row log-sum-exp
    ``[B, H, N]`` fp32 if asked, the (q tile, key tile) live marks of the
    bias (None without a bias) and, in bf16, the bias's padded fp32 terms
    ``[N', N']`` (N' = N rounded up to 128, -inf past N; None in fp32). Its
    first pass writes the marks and the terms, and the backward reads both
    again. With a bias or in bf16 one call launches two kernels and counts
    as one launch."""
    _check_heads("biased attention", q, k, v)
    b, n, h, d = q.shape
    live, bias_dtype, terms = None, -1, None
    if bias is not None:
        bias = _checked_bias(bias, q)
        nt = -(-n // _TILE)
        live = torch.empty(nt * nt, dtype=torch.uint8, device=q.device)
        bias_dtype = DTYPES[bias.dtype]
    if q.dtype == torch.bfloat16:
        tn = _term_rows(n)
        terms = torch.empty((tn, tn), dtype=torch.float32, device=q.device)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    _K5([q, k, v, bias, live, terms, out, lse], b, n, h, d, q.stride(1), q.stride(0),
        DTYPES[q.dtype], bias_dtype, _SCALE)
    return out, lse, live, terms


def _banded_forward(q, k, v, band, with_lse: bool):
    """Kernel 7 on CUDA tensors: ``out [B, N, H, D]`` and the row
    log-sum-exp ``[B, H, N]`` fp32 if asked."""
    _check_heads("banded attention", q, k, v)
    b, n, h, d = q.shape
    gw, window = band
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    _K7([q, k, v, out, lse], b, n, h, d, q.stride(1), q.stride(0), n // gw, gw, window,
        DTYPES[q.dtype], _SCALE)
    return out, lse


def _grad_operands(q, out, lse, g) -> torch.Tensor:
    """Check the backward's operands; returns ``g`` ``[B, N, H, D]``
    contiguous."""
    b, n, h, d = q.shape
    g = g.reshape(b, n, h, d).contiguous()
    if out.shape != q.shape or lse.shape != (b, h, n):
        raise ValueError(f"attention backward: q {tuple(q.shape)}, out {tuple(out.shape)}, "
                         f"lse {tuple(lse.shape)}")
    if out.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("attention backward: out and g in q's dtype, lse in float32")
    if not (out.is_contiguous() and lse.is_contiguous()) or g.data_ptr() % 16 \
            or out.data_ptr() % 16:
        raise ValueError("attention backward needs contiguous, aligned out and lse")
    return g


def _dst(dqkv: torch.Tensor) -> tuple[list, list]:
    """dq, dk, dv pointers of a packed ``[B, N, 3, H, D]`` gradient, and its
    row and batch strides."""
    return list(dqkv.unbind(2)), [dqkv.stride(1), dqkv.stride(0)]


def _bias_backward(q, k, v, bias, out, lse, g, live, terms, dqkv) -> None:
    """Kernel 6 into the packed ``dqkv [B, N, 3, H, D]``: ``live`` None
    marks the tiles first, ``terms`` None (bf16) writes the padded fp32
    copy of the bias first."""
    _check_heads("biased attention backward", q, k, v)
    g = _grad_operands(q, out, lse, g)
    b, n, h, d = q.shape
    bias_dtype, mark, copy = -1, 0, 0
    if bias is not None:
        bias = _checked_bias(bias, q)
        bias_dtype = DTYPES[bias.dtype]
        if live is None:
            nt = -(-n // _TILE)
            live, mark = torch.empty(nt * nt, dtype=torch.uint8, device=q.device), 1
    if q.dtype != torch.bfloat16:
        terms = None  # the fp32 kernels stage the bias itself
    elif terms is None:
        tn = _term_rows(n)
        terms, copy = torch.empty((tn, tn), dtype=torch.float32, device=q.device), 1
    elif terms.shape != (_term_rows(n),) * 2 or terms.dtype != torch.float32 \
            or terms.device != q.device or not terms.is_contiguous():
        raise ValueError(f"biased attention backward: terms {tuple(terms.shape)} {terms.dtype}")
    ptrs, strides = _dst(dqkv)
    delta = torch.empty_like(lse)
    _K6([q, k, v, out, g, lse, delta, bias, live, terms, *ptrs], b, n, h, d, q.stride(1),
        q.stride(0), *strides, DTYPES[q.dtype], bias_dtype, mark, copy, _SCALE)


def _banded_backward(q, k, v, band, out, lse, g, dqkv) -> None:
    """Kernel 8 into the packed ``dqkv [B, N, 3, H, D]``."""
    _check_heads("banded attention backward", q, k, v)
    g = _grad_operands(q, out, lse, g)
    b, n, h, d = q.shape
    gw, window = band
    ptrs, strides = _dst(dqkv)
    delta = torch.empty_like(lse)
    _K8([q, k, v, out, g, lse, delta, *ptrs], b, n, h, d, q.stride(1), q.stride(0), *strides,
        n // gw, gw, window, DTYPES[q.dtype], _SCALE)


def bias_attention_backward(q, k, v, bias, out, lse, g, live=None, terms=None):
    """Kernel 6: ``(dq, dk, dv)`` of ``mha_flash_bias`` (q, k, v ``[B, N, H,
    D]``, a constant ``[N, N]`` bias or None) from the forward's ``out``,
    its row log-sum-exp ``lse [B, H, N]`` and the cotangent ``g``: the plain
    version for CPU tensors; for CUDA tensors the kernels, which write the
    three into one packed ``[B, N, 3, H, D]`` buffer (the results are views
    of it). ``live`` and ``terms``: kernel 5's tile marks and (bf16) padded
    fp32 bias terms, written here when not given. One call counts as one
    launch, though it starts three or four kernels (the marks and terms if
    either is not given, delta, the dK/dV pass, the dQ pass)."""
    if q.device.type == "cpu":
        return bias_attention_backward_reference(q, k, v, bias, out, lse, g)
    b, n, h, d = q.shape
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    _bias_backward(q, k, v, bias, out, lse, g, live, terms, dqkv)
    return dqkv.unbind(2)



def banded_attention_backward(q, k, v, band, out, lse, g):
    """Kernel 8: ``(dq, dk, dv)`` of ``mha_flash_banded`` from the forward's
    ``out`` and ``lse`` and the cotangent ``g``, as
    ``bias_attention_backward``: the plain version for CPU tensors, the
    kernels (one launch counted) for CUDA tensors."""
    if q.device.type == "cpu":
        return banded_attention_backward_reference(q, k, v, band, out, lse, g)
    b, n, h, d = q.shape
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    _banded_backward(q, k, v, band, out, lse, g, dqkv)
    return dqkv.unbind(2)



class _MaskedAttention(torch.autograd.Function):
    """On q, k, v viewed in the packed ``qkv [B, N, 3*H*D]``: kernel 5 (no
    ``band``) or kernel 7 forward with the row log-sum-exp, returning ``out
    [B, N, H, D]``, and kernel 6 or 8 backward writing ``d(qkv)`` in the
    packed layout. Kernel 5's tile marks and padded fp32 bias terms are kept
    for kernel 6, which so writes no copy of its own. The bias is a
    constant: it gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, num_heads, bias, band):
        q, k, v = _split(qkv, num_heads)
        if band is None:
            out, lse, live, terms = _bias_forward(q, k, v, bias, with_lse=True)
        else:
            (out, lse), bias, live, terms = _banded_forward(q, k, v, band, True), None, None, None
        ctx.save_for_backward(qkv, out, lse, bias, live, terms)
        ctx.num_heads, ctx.band = num_heads, band
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, out, lse, bias, live, terms = ctx.saved_tensors
        q, k, v = _split(qkv, ctx.num_heads)
        dqkv = torch.empty_like(qkv)
        dst = dqkv.view(q.shape[0], q.shape[1], 3, q.shape[2], q.shape[3])
        if ctx.band is None:
            _bias_backward(q, k, v, bias, out, lse, g, live, terms, dst)
        else:
            _banded_backward(q, k, v, ctx.band, out, lse, g, dst)
        return dqkv, None, None, None


def _split(qkv: torch.Tensor, num_heads: int):
    """q, k, v ``[B, N, H, D]`` viewed in place in the packed ``qkv``."""
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, num_heads, c3 // 3 // num_heads).unbind(2)


def _pack(q, k, v) -> torch.Tensor:
    """Separate q, k, v ``[B, N, H, D]`` as one packed ``[B, N, 3*H*D]`` (a
    copy), for the autograd Function."""
    b, n, h, d = q.shape
    return torch.stack((q, k, v), dim=2).reshape(b, n, 3 * h * d)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _trains(bias) -> bool:
    """A bias that needs a gradient: the plain attention serves it (the JAX
    ``_flash_bwd``'s einsum fallback), whose autograd returns a real dbias."""
    return bias is not None and _needs_grad(bias)


def mha_flash_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over ``[B, N, H, D]`` with an additive ``[N, N]`` bias shared
    by batch and heads (or none): kernel 5 for CUDA tensors, returning
    ``[B, N, H, D]`` contiguous, with kernel 6 as its backward when q, k or
    v requires a gradient (a bias that requires one takes the plain
    version); the plain version for CPU tensors. With a bias or in bf16,
    one call launches two kernels (the tile marks and the terms, then
    attention) and counts as one launch."""
    if torch.compiler.is_compiling() and not _needs_grad(q, k, v) and not _trains(bias):
        return torch.ops.dad.bias_attention(q, k, v, bias)
    if q.device.type == "cpu" or _trains(bias):
        return mha_bias_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no biased attention for device {q.device}")
    if _needs_grad(q, k, v):
        return _MaskedAttention.apply(_pack(q, k, v), q.shape[2], bias, None)
    return _bias_forward(q, k, v, bias, with_lse=False)[0]



def mha_flash_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     band: tuple[int, int]) -> torch.Tensor:
    """Window attention over ``[B, N, H, D]`` on a prefix-less row-major
    ``(N / gw, gw)`` grid, ``band = (gw, window)``: kernel 7 for CUDA
    tensors, returning ``[B, N, H, D]`` contiguous, with kernel 8 as its
    backward when q, k or v requires a gradient; the plain version for CPU
    tensors."""
    n = q.shape[1]
    gw, window = band
    if n % gw or window < 1:
        raise ValueError(f"band {band} does not fit N={n}")
    if torch.compiler.is_compiling() and not _needs_grad(q, k, v):
        return torch.ops.dad.banded_attention(q, k, v, gw, window)
    if q.device.type == "cpu":
        return mha_banded_reference(q, k, v, band)
    if q.device.type != "cuda":
        raise ValueError(f"no banded attention for device {q.device}")
    if _needs_grad(q, k, v):
        return _MaskedAttention.apply(_pack(q, k, v), q.shape[2], None, band)
    return _banded_forward(q, k, v, band, with_lse=False)[0]



def _shared_bias(bias: torch.Tensor | None) -> torch.Tensor | None:
    """``[1, N, N]`` as ``[N, N]``; ``[N, N]``, a per-head ``[H, N, N]`` or
    None as given."""
    if bias is None or bias.ndim == 2:
        return bias
    if bias.ndim == 3:
        return bias[0] if bias.shape[0] == 1 else bias
    raise ValueError(f"bias shape {tuple(bias.shape)}")


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None,
              band: tuple[int, int] | None = None) -> torch.Tensor:
    """Attention over ``[B, N, H, D]`` with an optional additive bias
    (``[N, N]`` or ``[1, N, N]`` shared by batch and heads, or per-head
    ``[H, N, N]``), dispatched as the JAX ``mha_flash``: a per-head bias or
    one that requires a gradient to the plain attention, a ``band = (gw,
    window)`` over a whole grid of at least ``_BANDED_MIN_SEQ`` tokens to
    ``mha_flash_banded``, everything else to ``mha_flash_bias``. A band
    asserts that the bias is the prefix-less local-window mask of that
    grid; the banded kernel computes the mask itself, so a band needs no
    bias beside it here (the JAX package needs both)."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, N, H, D]; got {tuple(q.shape)}")
    bias = _shared_bias(bias)
    if bias is not None and (bias.ndim == 3 or _trains(bias)):
        return mha_bias_reference(q, k, v, bias)
    if banded_eligible(q.shape[1], band):
        return mha_flash_banded(q, k, v, band)
    return mha_flash_bias(q, k, v, bias)


def mha_flash_qkv(qkv: torch.Tensor, num_heads: int, bias: torch.Tensor | None = None,
                  band: tuple[int, int] | None = None) -> torch.Tensor:
    """``mha_flash`` on q, k, v viewed in place in the fused-QKV output
    ``[B, N, 3*H*D]``, returning ``[B, N, H*D]``. On the card, when ``qkv``
    requires a gradient and the bias is a constant shared by batch and
    heads, one autograd Function runs kernel 5 or 7 and, as its backward,
    kernel 6 or 8, which writes ``d(qkv)`` in the packed layout: autograd of
    the three views would sum three strided gradients into a zeroed
    buffer."""
    b, n, c3 = qkv.shape
    bias = _shared_bias(bias)
    if qkv.device.type == "cuda" and _needs_grad(qkv) \
            and (bias is None or (bias.ndim == 2 and not _trains(bias))):
        band = band if banded_eligible(n, band) else None
        return _MaskedAttention.apply(qkv, num_heads, bias, band).reshape(b, n, c3 // 3)
    q, k, v = _split(qkv, num_heads)
    return mha_flash(q, k, v, bias, band).reshape(b, n, c3 // 3)


# ------------------------------------------------------------------ the ops torch.export keeps
@torch.library.custom_op("dad::packed_attention", mutates_args=(), device_types="cuda")
def _packed_op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 1 without the log-sum-exp."""
    _check(qkv, num_heads)
    return _forward(qkv, num_heads, with_lse=False)[0]


@_packed_op.register_kernel("cpu")
def _(qkv, num_heads):
    return mha_packed_reference(qkv, num_heads)


@_packed_op.register_fake
def _(qkv, num_heads):
    b, n, c3 = qkv.shape
    return qkv.new_empty((b, n, c3 // 3))


@torch.library.custom_op("dad::bias_attention", mutates_args=(), device_types="cuda")
def _bias_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
    """Kernel 5 without the log-sum-exp, on ``[B, N, H, D]``."""
    return _bias_forward(q, k, v, bias, with_lse=False)[0]


@_bias_op.register_kernel("cpu")
def _(q, k, v, bias):
    return mha_bias_reference(q, k, v, bias).contiguous()


@_bias_op.register_fake
def _(q, k, v, bias):
    return q.new_empty(q.shape)


@torch.library.custom_op("dad::banded_attention", mutates_args=(), device_types="cuda")
def _banded_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gw: int,
               window: int) -> torch.Tensor:
    """Kernel 7 without the log-sum-exp, on ``[B, N, H, D]``."""
    return _banded_forward(q, k, v, (gw, window), with_lse=False)[0]


@_banded_op.register_kernel("cpu")
def _(q, k, v, gw, window):
    return mha_banded_reference(q, k, v, (gw, window)).contiguous()


@_banded_op.register_fake
def _(q, k, v, gw, window):
    return q.new_empty(q.shape)
