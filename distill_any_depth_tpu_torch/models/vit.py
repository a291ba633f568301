"""DINOv2-style ViT encoder (global attention, cls token).

Counterpart of distill_any_depth_tpu/models/vit.py (``PatchEmbed``, ``Mlp``,
``Attention``, ``Block``, ``_interp_pos_embed``, ``DinoViT``). Submodules
carry the reference state-dict names (``pretrained.blocks.{i}.attn.qkv``
...), so a state dict from ``utils/convert.params_from_jax`` loads with
``strict=True``.

Parameters stay fp32; every layer casts its weights to the dtype of its
input, as flax does with ``kernel.astype(dtype)``, so bf16 activations reach
the attention kernel. Not ported yet: register tokens, the PEG conv
positional encoding, windowed attention, LoRA/SSF adapters, int8 GEMMs and
SwiGLU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distill_any_depth_tpu_torch.configs import EncoderConfig
from distill_any_depth_tpu_torch.ops.attention import multi_head_attention_packed
from distill_any_depth_tpu_torch.ops.resize import resize_matrix

__all__ = ["Linear", "LayerNorm", "Conv2d", "gelu", "PatchEmbed", "Mlp", "Attention", "Block",
           "interp_pos_embed", "DinoViT"]


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, the tanh form under bf16 (the JAX
    package's ``gelu="auto"``: its error is below bf16 rounding)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class PatchEmbed(nn.Module):
    """Conv2d(3, D, p, stride p) over ``[B, 3, H, W]`` -> ``[B, N, D]``."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # qkv columns are (q|k|v, head, dim): the layout the kernel reads as is
        return self.proj(multi_head_attention_packed(self.qkv(x), self.num_heads))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (eval path)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float | None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def interp_pos_embed(pos_embed: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Bicubic resampling of the cls-prefixed base-grid pos-embed with the
    ``[gh, base]`` / ``[gw, base]`` interpolation matrices ``mh``, ``mw``."""
    base, dim = mh.shape[1], pos_embed.shape[-1]
    grid = pos_embed[0, 1:].float().reshape(base, base, dim)
    out = torch.einsum("Hh,hwc->Hwc", mh, grid)
    out = torch.einsum("Ww,hwc->hWc", mw, out).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :1].float(), out], dim=1).to(dtype)


class DinoViT(nn.Module):
    """DINOv2 encoder with intermediate-layer taps.

    ``forward(x [B, 3, H, W])`` returns ``(taps, cls_tokens)``: for each
    index in ``cfg.out_indices`` the final-normed patch tokens ``[B, N, C]``
    and the cls token ``[B, C]``.
    """

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        n_base = (cfg.base_img_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_base + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.init_values) for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(d, eps=1e-6)
        self._pe_mats: dict = {}  # (gh, gw, device) -> pos-embed resampling matrices

    def _pos_embed(self, gh: int, gw: int, dtype: torch.dtype) -> torch.Tensor:
        """The pos-embed for a ``gh x gw`` grid: DINOv2's bicubic resampling
        with the ``(g + offset) / base`` scale factor driving the source
        coordinates (``F.interpolate(scale_factor=..., mode="bicubic")``
        semantics, pinned by the tests), 37 -> 28 at 392^2.

        It runs as two small fp32 products with ``resize_matrix`` weights, as
        in the JAX package: PyTorch's CUDA bicubic kernel loops over the 768
        channels per output pixel and took 5.3 ms of a 13.2 ms ViT-B 392^2
        bs8 forward on an H100. The matrices are built once per grid and
        device (a host-to-device copy inside every forward would stall it).
        """
        cfg = self.cfg
        base = cfg.base_img_size // cfg.patch_size
        if (gh, gw) == (base, base):
            return self.pos_embed.to(dtype)
        dev = self.pos_embed.device
        mats = self._pe_mats.get((gh, gw, dev))
        if mats is None:
            mats = tuple(
                torch.from_numpy(resize_matrix(base, g, "bicubic", False,
                                               (g + cfg.interpolate_offset) / base)).to(dev)
                for g in (gh, gw)
            )
            self._pe_mats[(gh, gw, dev)] = mats
        return interp_pos_embed(self.pos_embed, *mats, dtype)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        b, _, h, w = x.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} must be a multiple of patch {p}")
        gh, gw = h // p, w // p
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self._pos_embed(gh, gw, x.dtype)
        raw = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in cfg.out_indices:
                raw[i] = tokens
        taps, cls_tokens = [], []
        for i in cfg.out_indices:
            t = self.norm(raw[i])
            cls_tokens.append(t[:, 0])
            taps.append(t[:, 1:])
        return taps, cls_tokens
