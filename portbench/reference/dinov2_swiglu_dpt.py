"""Plain float32 Depth-Anything-V2-Giant: the DINOv2 ViT-g/14 encoder, whose
blocks carry DINOv2's fused SwiGLU FFN, and the DPT head.

Source: Depth-Anything-V2 ``run.py`` ``model_configs['vitg']`` (features 384,
out channels 1536 x 4), its encoder ``depth_anything_v2/dinov2.py``
``DINOv2('vitg')`` (DINOv2's ``vit_giant2`` with ``ffn_layer="swiglufused"``,
``init_values=1.0``, patch 14, the 518 pos-embed grid, ``interpolate_offset``
0.1) and its taps after blocks 9, 19, 29 and 39 (``dpt.py``
``intermediate_layer_idx['vitg']``). Each of the ``depth`` pre-norm blocks is

    x <- x + ls1 * proj(MHA(LN1(x)))
    [x1 | x2] = w12(LN2(x))                  halves of the packed output
    x <- x + ls2 * w3(silu(x1) * x2)

DINOv2's ``SwiGLUFFNFused``: with ``d * mlp_ratio`` as its hidden argument it
keeps ``h = (int(2/3 * d * mlp_ratio) + 7) // 8 * 8`` (4096 at d = 1536), so
``w12`` maps d to 2h and ``w3`` h to d; state-dict names ``mlp.w12.*`` and
``mlp.w3.*``. The rest (patch embedding, cls token, the bicubic pos-embed
resampling, softmax attention, the normed taps, the DPT head and the final
ReLU) is ``dinov2_dpt``'s, whose attention, pos-embed, head and rounding
helpers this module calls unchanged; the encoder's loop is its own.

Departures from the published model: none in the arithmetic. Weights are
the benchmark's draw (``param_specs``: normal at 1/sqrt(fan_in), ``w12``
and ``w3`` included; LayerScale at ``layerscale_init``), not the checkpoint.

``quant="fp8"`` is ``dinov2_dpt``'s control: besides what that rounds,
``x1``, ``x2``, ``silu(x1)`` and their product are each rounded per row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import dinov2_dpt
from portbench.reference.dinov2_dpt import (PATCH, _attention, _conv, _layer_norm, _linear,
                                            _pos_embed, _q, _up, head_forward)

__all__ = ["READS", "REQUIRES", "IGNORES", "WEIGHT_KEYS", "OPTIONS", "hidden_width",
           "param_specs", "depth_forward", "encoder_forward"]

READS = dinov2_dpt.READS + ("ffn",)
REQUIRES = {k: v for k, v in dinov2_dpt.REQUIRES.items() if k != "ffn"}
IGNORES = dinov2_dpt.IGNORES
WEIGHT_KEYS = dinov2_dpt.WEIGHT_KEYS
OPTIONS = dinov2_dpt.OPTIONS


def hidden_width(m: dict) -> int:
    """The SwiGLU hidden width h of the model entry ``m``."""
    if m["ffn"] != "swiglu":
        raise ValueError(f"this reference computes ffn 'swiglu' alone, not {m['ffn']!r}")
    return (int(int(m["embed_dim"] * m["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8


def param_specs(m: dict) -> list[tuple[str, tuple, str, float]]:
    """``dinov2_dpt.param_specs`` with each block's ``fc1``/``fc2`` in the
    draw's order replaced by ``w12`` [2h, d] and ``w3`` [d, h] (normal at
    1/sqrt(fan_in), zero biases)."""
    d, h = m["embed_dim"], hidden_width(m)
    ffn = {"fc1.weight": ("w12.weight", (2 * h, d), "normal", 1.0 / math.sqrt(d)),
           "fc1.bias": ("w12.bias", (2 * h,), "const", 0.0),
           "fc2.weight": ("w3.weight", (d, h), "normal", 1.0 / math.sqrt(h)),
           "fc2.bias": ("w3.bias", (d,), "const", 0.0)}
    specs = []
    for spec in dinov2_dpt.param_specs(m):
        block, _, leaf = spec[0].rpartition(".mlp.")
        specs.append((f"{block}.mlp.{ffn[leaf][0]}", *ffn[leaf][1:]) if block else spec)
    return specs


def _swiglu(x, W, name, quant):
    x1, x2 = _linear(x, W[f"{name}.w12.weight"], W[f"{name}.w12.bias"], quant).chunk(2, dim=-1)
    x1, x2 = _q(x1, quant), _q(x2, quant)
    gated = _q(_q(F.silu(x1), quant) * x2, quant)
    return _linear(gated, W[f"{name}.w3.weight"], W[f"{name}.w3.bias"], quant)


def encoder_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """Four normed taps ``[B, N, C]`` (patch tokens) of ``x [B, 3, H, W]``."""
    hidden_width(m)  # refuses an entry whose FFN is not SwiGLU
    b, _, h, w = x.shape
    gh, gw = h // PATCH, w // PATCH
    p = "pretrained"
    t = _conv(x, W[f"{p}.patch_embed.proj.weight"], W[f"{p}.patch_embed.proj.bias"], quant,
              stride=PATCH).flatten(2).transpose(1, 2)
    t = torch.cat([W[f"{p}.cls_token"].expand(b, -1, -1), t], dim=1)
    t = _q(t + _pos_embed(W, m, gh, gw), quant)
    taps = []
    for i in range(m["depth"]):
        blk = f"{p}.blocks.{i}"
        a = _attention(_layer_norm(t, W, f"{blk}.norm1", quant), W, f"{blk}.attn",
                       m["num_heads"], quant)
        t = _q(t + W[f"{blk}.ls1.gamma"] * a, quant)
        y = _swiglu(_layer_norm(t, W, f"{blk}.norm2", quant), W, f"{blk}.mlp", quant)
        t = _q(t + W[f"{blk}.ls2.gamma"] * y, quant)
        if i in m["out_indices"]:
            taps.append(_layer_norm(t, W, f"{p}.norm", quant)[:, 1:])
    return taps


def depth_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """``(depth [B, H, W], last tap [B, N, C])`` of normalized images ``x
    [B, 3, H, W]``."""
    h, w = x.shape[-2:]
    taps = encoder_forward(W, m, x, quant)
    depth = head_forward(W, m, taps, h // PATCH, w // PATCH, quant)
    if m["interp_to_input"] and tuple(depth.shape[-2:]) != (h, w):
        depth = _up(depth, (h, w), quant)
    return F.relu(depth)[:, 0], taps[3]
