"""The benchmark's counts of operations and bytes for the windowed model
(a configuration whose model entry has ``window_size`` and
``use_pos_conv``), beside ``flops.py``'s dense ones and on its peaks.

A query of a ``g``-token axis sees ``min(window, g)`` keys of it (the
window's centre is clamped inward, so no window is cut at a border), and
the 2-D window is the product of its two axes. Kernel 7 (the banded
attention forward) does 4 D operations per live (query, key) pair and head
and reads the packed qkv once and writes the output once, in bf16. The PEG
conv does 2 operations per tap, channel and pixel, and reads its input
and weights and writes its output once, in bf16. ``model_flops`` is
``flops.model_flops`` with the windowed blocks in place of the dense ones:
no cls token, QK^T and PV over the live pairs alone, and the PEG conv; the
patch embedding and the DPT head are counted as ``flops.model_flops``
counts them.
"""
from __future__ import annotations

from portbench import flops
from portbench.flops import HEAD_DIM, PATCH

__all__ = ["live_pairs", "banded_attention", "pos_conv", "model_flops"]

PEG = 37
BF16 = 2


def live_pairs(gh: int, gw: int, window: int) -> int:
    """Live (query, key) pairs of one image and head on a ``gh x gw`` grid."""
    return gh * min(window, gh) * gw * min(window, gw)


def banded_attention(b: int, gh: int, gw: int, heads: int, window: int) -> tuple[float, float]:
    """Kernel 7 on the packed qkv ``[b, gh * gw, 3 * heads * 64]``:
    operations and bytes."""
    c = heads * HEAD_DIM
    n = gh * gw
    return 4.0 * HEAD_DIM * b * heads * live_pairs(gh, gw, window), 4 * b * n * c * BF16


def pos_conv(b: int, c: int, gh: int, gw: int) -> tuple[float, float]:
    """The PEG conv, depthwise 37 x 37 with bias over ``[b, c, gh, gw]``:
    operations and bytes."""
    return 2.0 * b * c * PEG * PEG * gh * gw, (2 * b * c * gh * gw + c * PEG * PEG + c) * BF16


def model_flops(m: dict, res: int) -> float:
    """Matmul and convolution FLOPs of one ``res`` x ``res`` image through
    the windowed model ``m`` (a configuration's model entry)."""
    d, depth, g = m["embed_dim"], m["depth"], res // PATCH
    n = g * g
    hidden = int(d * m["mlp_ratio"])
    blocks = depth * (2.0 * n * (3 * d * d + d * d + 2 * d * hidden)
                      + 4.0 * live_pairs(g, g, m["window_size"]) * d)
    # flops.model_flops with no blocks: the patch embedding and the head
    return flops.model_flops({**m, "depth": 0}, res) + pos_conv(1, d, g, g)[0] + blocks
