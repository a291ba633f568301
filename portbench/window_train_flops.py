"""The benchmark's counts of operations and bytes for the windowed model's
training step (a training configuration whose student is windowed), beside
``window_flops.py``'s forward counts and on ``flops.py``'s peaks.

Kernel 8 (the banded attention backward) does 10 D operations per live
(query, key) pair and head (S and dP recomputed, dV, dQ, dK) and reads the
packed qkv, the forward's output and the output's cotangent once and writes
the packed d(qkv) once, in bf16: the arithmetic of the program's
``cli/kernel_bounds.py`` row 8, copied so that the program cannot move it.
The PEG conv's forward and its backward's two products, d(x) and
d(weight), each do the forward's 2 operations per tap, channel and pixel;
the three read their inputs and write their outputs once in bf16 (the
forward reads x and the weights and writes its output; d(x) reads the
cotangent and the weights and writes d(x); d(weight) reads x and the
cotangent and writes d(weight) and d(bias)). ``step_flops`` is a step's
needed FLOPs an image, as ``metrics/mfu.train`` counts a dense step: the
teacher's forward (``flops.model_flops``) and three times the student's
(``window_flops.model_flops``: forward, and the backward's two products;
no recompute).
"""
from __future__ import annotations

from portbench import flops, window_flops
from portbench.flops import HEAD_DIM
from portbench.window_flops import BF16, PEG

__all__ = ["banded_attention_backward", "pos_conv_step", "step_flops"]


def banded_attention_backward(b: int, gh: int, gw: int, heads: int,
                              window: int) -> tuple[float, float]:
    """Kernel 8 on the packed qkv ``[b, gh * gw, 3 * heads * 64]``:
    operations and bytes."""
    c = heads * HEAD_DIM
    n = gh * gw
    return (10.0 * HEAD_DIM * b * heads * window_flops.live_pairs(gh, gw, window),
            8 * b * n * c * BF16)


def pos_conv_step(b: int, c: int, gh: int, gw: int) -> tuple[float, float]:
    """The PEG conv's forward, d(x) and d(weight) over ``[b, c, gh, gw]``:
    operations and bytes."""
    ops, fwd_bytes = window_flops.pos_conv(b, c, gh, gw)
    maps, weights = b * c * gh * gw * BF16, (c * PEG * PEG + c) * BF16
    return 3 * ops, fwd_bytes + (2 * maps + weights) + (2 * maps + weights)


def step_flops(config: dict) -> float:
    """Matmul and convolution FLOPs an image of a training step of
    ``config`` (a training configuration with a windowed student)."""
    res = config["train"]["image_size"]
    return (flops.model_flops(config["teacher"], res)
            + 3 * window_flops.model_flops(config["student"], res))
