"""Plain float32 windowed high-resolution ViT-B teacher: Distill-Any-Depth's
``DinoWindowVisionTransformer`` and the DAM teacher's DPT head.

Source: Distill-Any-Depth ``distillanydepth/modeling/backbones/vit/
ViT_DINO.py`` ``DinoWindowVisionTransformer`` (``:875``), built by
``vit_base`` (``:1349-1360``: patch 14, 12 blocks, 768 wide, 12 heads, MLP
ratio 4) and used as the DAM teacher with ``encoder='vitb'``
(``modeling/archs/dam/dam.py:361-362``: features 128, out channels 96, 192,
384, 768, no trailing ReLU in the head, the depth resized to the input and
then ReLU'd). Its position encoding is CPVT's PEG (Chu et al., arXiv
2102.10882; ``PosConv``, ``ViT_DINO.py:853-871``). The forward, with no cls
token and ``N = gh * gw`` patch tokens:

    t    = patch_embed(x)                                   [B, N, C]
    gpe  = dwconv37x37(t on the gh x gw grid) + t           PEG: depthwise,
                                                            padding 18, bias;
                                                            its stride-1 identity
    t    = t + gpe                                          past the PE -> GPE
                                                            schedule (coef 1)
    for each block:
      t = t + ls1 * proj(MHA_window(LN1(t)))
      t = t + ls2 * fc2(GELU(fc1(LN2(t))))
    taps = [LN(t)] * 4  ->  ``dinov2_dpt``'s head, resized to the input, ReLU

Key j is live for query i iff ``|cy_i - y_j| <= w // 2`` and ``|cx_i - x_j|
<= w // 2``, with ``c`` the query's row (column) clamped into ``[w // 2,
max(g - 1 - w // 2, w // 2)]``: a border query's window is moved inward,
not cut, so every query sees ``min(w, gh) * min(w, gw)`` keys (the
reference's ``prepare_attn_bias`` with its corner and edge completion,
``:1141-1178``). The mask is built here from that rule. Attention runs one
image at a time: a 1036^2 image's masked fp32 scores are 1.44 GB.

The patch embedding, attention projections, LayerNorm, exact GELU, the
final norm and the head are ``dinov2_dpt``'s helpers, called unchanged.

Departures from the published model: none in the arithmetic. The model is
run at inference, past its PE -> GPE schedule, where the interpolated
pos-embed has weight 0: it is drawn (``param_specs``) and not read. Weights
are the benchmark's draw (normal at 1/sqrt(fan_in), the PEG's fan-in 37^2;
LayerScale at ``layerscale_init``), not a checkpoint.

``quant="fp8"`` is ``dinov2_dpt``'s control: besides what that rounds, the
PEG conv's input (per pixel), weight (per channel) and output, ``gpe`` and
the sum after it are rounded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import dinov2_dpt
from portbench.reference.dinov2_dpt import (PATCH, _conv, _layer_norm, _linear, _q, _up,
                                            head_forward)

__all__ = ["READS", "REQUIRES", "IGNORES", "WEIGHT_KEYS", "OPTIONS", "PEG", "param_specs",
           "window_mask", "depth_forward", "encoder_forward"]

PEG = 37  # the PEG conv's kernel, padding PEG // 2

READS = ("embed_dim", "depth", "num_heads", "mlp_ratio", "base_img_size", "window_size",
         "use_cls_token", "use_pos_conv", "final_taps", "features", "out_channels",
         "trailing_head_relu", "interp_to_input")
REQUIRES = {k: v for k, v in dinov2_dpt.REQUIRES.items()
            if k not in ("window_size", "use_cls_token", "use_pos_conv", "final_taps")}
# besides dinov2_dpt's: the taps are the final layer whatever out_indices
# says, and past the PE schedule the pos-embed's resampling is not read
IGNORES = dinov2_dpt.IGNORES + ("out_indices", "interpolate_offset")
WEIGHT_KEYS = dinov2_dpt.WEIGHT_KEYS
OPTIONS = dinov2_dpt.OPTIONS
_COMPUTES = {"use_cls_token": False, "use_pos_conv": True, "final_taps": True}


def _check(m: dict) -> None:
    wrong = {k: m[k] for k, v in _COMPUTES.items() if m[k] != v}
    if wrong or not m["window_size"] or m["window_size"] % 2 == 0:
        raise ValueError(f"this reference computes an odd window_size and {_COMPUTES}, "
                         f"not {wrong or {'window_size': m['window_size']}}")


def param_specs(m: dict) -> list[tuple[str, tuple, str, float]]:
    """``dinov2_dpt.param_specs`` without the cls token, with the pos-embed
    of the base grid alone (``[1, base^2, d]``) and the PEG conv
    (``pos_conv.proj.0``: weight ``[d, 1, 37, 37]`` normal at 1/37, zero
    bias) after the patch embedding."""
    _check(m)
    d, base = m["embed_dim"], m["base_img_size"] // PATCH
    p = "pretrained"
    specs = []
    for spec in dinov2_dpt.param_specs(m):
        name = spec[0]
        if name == f"{p}.cls_token":
            continue
        if name == f"{p}.pos_embed":
            spec = (name, (1, base * base, d), *spec[2:])
        specs.append(spec)
        if name == f"{p}.patch_embed.proj.bias":
            specs.append((f"{p}.pos_conv.proj.0.weight", (d, 1, PEG, PEG), "normal", 1.0 / PEG))
            specs.append((f"{p}.pos_conv.proj.0.bias", (d,), "const", 0.0))
    return specs


def window_mask(gh: int, gw: int, window: int, device=None) -> torch.Tensor:
    """``[N, N]`` bool, True where key j (column) is live for query i (row)
    of the row-major ``gh x gw`` grid."""
    half = window // 2
    ys = torch.arange(gh, device=device).repeat_interleave(gw)
    xs = torch.arange(gw, device=device).repeat(gh)
    cy = ys.clamp(half, max(gh - 1 - half, half))
    cx = xs.clamp(half, max(gw - 1 - half, half))
    return (((cy[:, None] - ys[None, :]).abs() <= half)
            & ((cx[:, None] - xs[None, :]).abs() <= half))


def _window_attention(x, W, name, heads, dead, quant):
    b, n, c = x.shape
    qkv = _linear(x, W[f"{name}.qkv.weight"], W[f"{name}.qkv.bias"], quant)
    q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    out = []
    for i in range(b):
        s = (q[i] @ k[i].transpose(-1, -2)) * (c // heads) ** -0.5
        s.masked_fill_(dead, float("-inf"))
        out.append(_q(torch.softmax(s, dim=-1), quant) @ v[i])
    o = torch.stack(out).transpose(1, 2).reshape(b, n, c)
    return _linear(o, W[f"{name}.proj.weight"], W[f"{name}.proj.bias"], quant)


def _peg(W, t, gh, gw, quant):
    """``gpe = dwconv37x37(t) + t`` of tokens ``t [B, N, C]``."""
    b, n, c = t.shape
    grid = t.transpose(1, 2).reshape(b, c, gh, gw)
    y = _conv(grid, W["pretrained.pos_conv.proj.0.weight"], W["pretrained.pos_conv.proj.0.bias"],
              quant, padding=PEG // 2, groups=c)
    return _q(y.flatten(2).transpose(1, 2) + t, quant)


def encoder_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """Four normed taps ``[B, N, C]`` (the final layer's, four times) of
    ``x [B, 3, H, W]``."""
    _check(m)
    b, _, h, w = x.shape
    gh, gw = h // PATCH, w // PATCH
    p = "pretrained"
    t = _conv(x, W[f"{p}.patch_embed.proj.weight"], W[f"{p}.patch_embed.proj.bias"], quant,
              stride=PATCH).flatten(2).transpose(1, 2)
    t = _q(t + _peg(W, t, gh, gw, quant), quant)
    dead = ~window_mask(gh, gw, m["window_size"], x.device)
    for i in range(m["depth"]):
        blk = f"{p}.blocks.{i}"
        a = _window_attention(_layer_norm(t, W, f"{blk}.norm1", quant), W, f"{blk}.attn",
                              m["num_heads"], dead, quant)
        t = _q(t + W[f"{blk}.ls1.gamma"] * a, quant)
        y = _linear(_layer_norm(t, W, f"{blk}.norm2", quant), W[f"{blk}.mlp.fc1.weight"],
                    W[f"{blk}.mlp.fc1.bias"], quant)
        y = _linear(_q(F.gelu(y), quant), W[f"{blk}.mlp.fc2.weight"], W[f"{blk}.mlp.fc2.bias"],
                    quant)
        t = _q(t + W[f"{blk}.ls2.gamma"] * y, quant)
    return [_layer_norm(t, W, f"{p}.norm", quant)] * 4


def depth_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """``(depth [B, H, W], last tap [B, N, C])`` of normalized images ``x
    [B, 3, H, W]``."""
    h, w = x.shape[-2:]
    taps = encoder_forward(W, m, x, quant)
    depth = head_forward(W, m, taps, h // PATCH, w // PATCH, quant)
    if m["interp_to_input"] and tuple(depth.shape[-2:]) != (h, w):
        depth = _up(depth, (h, w), quant)
    return F.relu(depth)[:, 0], taps[3]
