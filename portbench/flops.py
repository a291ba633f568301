"""The benchmark's counts of operations and bytes: the bounds of the kernels
and the FLOPs of a whole model.

The kernel bounds are the arithmetic of the program's
``cli/kernel_bounds.py``, copied so that a change to the program cannot
move the yardstick: a kernel's least time on an H100 is the larger of its
operations over the bf16 dense peak and its bytes (each input read once,
each output written once) over the HBM rate. ``model_flops`` counts the
matrix and convolution work a Depth-Anything-V2 forward needs, from a
configuration's model entry: the patch embedding, the encoder's four GEMMs
a block, QK^T and PV over every (query, key) pair, and the DPT head's
convolutions and transposed convolutions. Elementwise work, resizes and
normalizations are not counted.
"""
from __future__ import annotations

BF16_OPS, BYTES = 989e12, 3.35e12  # H100 SXM dense bf16 peak, HBM3 rate
PATCH, HEAD_DIM = 14, 64


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """Least seconds for ``ops`` bf16 operations and ``nbytes`` of traffic,
    and which side bounds it."""
    t_ops, t_bytes = ops / BF16_OPS, nbytes / BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention(b: int, n: int, h: int, backward: bool) -> tuple[float, float]:
    """Kernel 1 (forward) or 3 (backward) on the packed QKV: operations and
    bytes. Forward: 4 D per (query, key) pair and head, qkv read, out
    written. Backward: 10 D (S and dP recomputed, dV, dQ, dK); qkv, out and
    the cotangent read, d(qkv) written (bf16)."""
    c = h * HEAD_DIM
    per_pair = 10 if backward else 4
    return per_pair * b * h * n * n * HEAD_DIM, (8 if backward else 4) * b * n * c * 2


def dpt_tail(b: int, res: int, c: int) -> tuple[float, float]:
    """Kernel 2 at a ``res`` input: 2x upsample + conv1 (C -> C/2), resize
    to ``res``, conv2 (C/2 -> 32) + ReLU, the 1x1 head; bf16 in and out,
    fp32 weights."""
    ht = res // PATCH * 4
    hu = 2 * ht
    ops = (2.0 * b * hu * hu * 9 * c * c // 2 + 2.0 * b * res * res * 9 * (c // 2) * 32
           + 2.0 * b * res * res * 32)
    weights = (9 * c * c // 2 + c // 2 + 9 * (c // 2) * 32 + 32 + 32 + 1) * 4
    return ops, b * ht * ht * c * 2 + weights + b * res * res * 2


def kth_select(rows: int, cols: int) -> tuple[float, float]:
    """Kernel 4: int32 order bits read once, one index a row."""
    return 0.0, rows * cols * 4 + rows * 8


def tokens(res: int) -> int:
    """Tokens of a square ``res`` image: the patch grid and the cls token."""
    return (res // PATCH) ** 2 + 1


def model_flops(m: dict, res: int) -> float:
    """Matmul and convolution FLOPs of one ``res`` x ``res`` image through
    the model ``m`` (a configuration's model entry)."""
    d, depth, g = m["embed_dim"], m["depth"], res // PATCH
    n = g * g + 1
    hidden = int(d * m["mlp_ratio"])
    enc = 2.0 * g * g * 3 * PATCH * PATCH * d  # patch embedding
    enc += depth * (2.0 * n * (3 * d * d + d * d + 2 * d * hidden) + 4.0 * n * n * d)
    f, oc = m["features"], m["out_channels"]

    def conv(hw, cin, cout, k):
        return 2.0 * hw * cin * cout * k * k

    head = sum(conv(g * g, d, c, 1) for c in oc)  # projects
    head += conv(g * g, oc[0], oc[0], 4) + conv(g * g, oc[1], oc[1], 2)  # transposed, per input
    g4 = (g + 1) // 2  # the stride-2 conv's grid
    head += conv(g4 * g4, oc[3], oc[3], 3)
    grids = [4 * g, 2 * g, g, g4]  # layer1..4 resolutions
    head += sum(conv(s * s, c, f, 3) for s, c in zip(grids, oc))  # layer_rn
    for r, s in enumerate(grids):  # refinenet r+1 works at grid s
        units = 1 if r == 3 else 2
        # its 1x1 out_conv commutes with the bilinear upsample after it (the
        # rows of a bilinear resize sum to one): counted at the lower grid
        head += units * 2 * conv(s * s, f, f, 3) + conv(s * s, f, f, 1)
    head += conv((8 * g) ** 2, f, f // 2, 3)  # output_conv1
    head += conv(res * res, f // 2, 32, 3) + conv(res * res, 32, 1, 1)
    return enc + head
