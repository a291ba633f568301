"""Least times on an H100 for the ten TPU kernels' work, at their paths' shapes,
and for the PEG conv's (row 12: no TPU kernel), forward and backward.

Run anywhere (it computes, it measures nothing): ``python -m
distill_any_depth_tpu_torch.cli.kernel_bounds``. For each kernel of the JAX
package it prints the operations and the bytes the function needs (each
input read once, each output written once) and the bound: the larger of
operations over the card's peak rate for their type and bytes over its
memory rate. Masked attention counts the products of the live (query, key)
pairs that the window mask leaves (49 per row for a 7x7 window), not the
dense N^2 its loops could visit; both are printed. ``chip_smoke.py``
computes the same bounds for the ported kernels from the inputs of its run.
"""
from __future__ import annotations

import json

BF16_OPS, INT8_OPS, BYTES = 989e12, 1979e12, 3.35e12  # H100 SXM dense peaks, HBM3
D = 64


def _bound(ops: float, nbytes: float, rate: float = BF16_OPS) -> dict:
    t_ops, t_bytes = ops / rate, nbytes / BYTES
    return {"gop": ops / 1e9, "mb": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _attention(b: int, n: int, h: int, keys: int, backward: bool, bias_bytes: int = 0) -> dict:
    """Forward: 4*D flops per (query, key) pair and head, qkv in, out out.
    Backward: 10*D (S and dP recomputed, dV, dQ, dK), qkv, out and the
    cotangent in, d(qkv) out."""
    c = h * D
    per_pair = 10 if backward else 4
    nbytes = (8 if backward else 4) * b * n * c * 2 + bias_bytes
    out = _bound(per_pair * b * h * n * keys * D, nbytes)
    out["dense_gop"] = per_pair * b * h * n * n * D / 1e9
    return out


def _tail(b: int, res: int, c: int) -> dict:
    """DPT tail at a 4x-patch-grid input: 2x upsample + conv1 (C -> C/2),
    resize to res, conv2 (C/2 -> 32) + ReLU, 1x1 head."""
    ht = res // 14 * 4
    hu = 2 * ht
    ops = (2.0 * b * hu * hu * 9 * c * c // 2 + 2.0 * b * res * res * 9 * (c // 2) * 32
           + 2.0 * b * res * res * 32)
    weights = (9 * c * c // 2 + c // 2 + 9 * (c // 2) * 32 + 32 + 32 + 1) * 4
    return _bound(ops, b * ht * ht * c * 2 + weights + b * res * res * 2)


def _w8a8(m: int, k: int, n: int) -> tuple[float, float]:
    """x [M, K] bf16 read once, w [K, N] int8 with per-column fp32 scales,
    fp32 bias, out [M, N] bf16 written once: the function's bytes, whatever
    the kernels move between their launches."""
    return 2.0 * m * k * n, m * k * 2 + k * n + n * 8 + m * n * 2


def _peg(b: int, c: int, g: int, backward: bool) -> dict:
    """The PEG conv over ``[b, c, g, g]``: 2 * 37^2 operations per channel
    and pixel, the map and the weights read and the output written once in
    bf16. Backward: d(x) (the cotangent and the weights in, d(x) out) and
    d(weight) with d(bias) (x and the cotangent in, the weights' shape
    out), each the forward's operations."""
    ops, nbytes = 2.0 * b * c * 37 * 37 * g * g, (2 * b * c * g * g + c * 37 * 37 + c) * 2
    return _bound(2 * ops, 2 * nbytes) if backward else _bound(ops, nbytes)


def vit_gemms(dim: int, ffn: str = "mlp") -> dict:
    """A ViT block's four GEMMs, name -> (K, N): qkv, proj and the FFN's
    two (fc1 and fc2, or SwiGLU's packed w12 and w3, whose hidden width is
    2/3 of 4 dim rounded up to a multiple of 8)."""
    gemms = {"qkv": (dim, 3 * dim), "proj": (dim, dim)}
    if ffn == "swiglu":
        hidden = (int(4 * dim * 2 / 3) + 7) // 8 * 8
        return {**gemms, "w12": (dim, 2 * hidden), "w3": (hidden, dim)}
    return {**gemms, "fc1": (dim, 4 * dim), "fc2": (4 * dim, dim)}


def _w8a8_encoder(name: str, m: int, dim: int, depth: int, ffn: str = "mlp") -> dict:
    """Kernel 9 at each of a ViT's four block GEMMs (``vit_gemms`` at ``m``
    tokens) and over the whole encoder (4 * depth launches, the bound of
    their summed work)."""
    gemms = vit_gemms(dim, ffn)
    rows, ops, nbytes = {}, 0.0, 0.0
    for gemm, (k, n) in gemms.items():
        o, by = _w8a8(m, k, n)
        rows[f"9 W8A8 GEMM, {name} {gemm}"] = _bound(o, by, rate=INT8_OPS)
        ops, nbytes = ops + depth * o, nbytes + depth * by
    rows[f"9 W8A8 GEMMs, {name}, whole encoder ({4 * depth})"] = _bound(ops, nbytes,
                                                                       rate=INT8_OPS)
    return rows


def bounds() -> dict:
    n392, n518, n1036 = 28 * 28 + 1, 37 * 37, 74 * 74
    win = 49  # live keys per query row under the 7x7 clamped-centre window
    return {
        "1 packed attention fwd, ViT-B 392^2 bs8": _attention(8, n392, 12, n392, False),
        # ViT-g's 24 heads at 518^2 (path 7; with 4 registers N = 1374)
        "1 packed attention fwd, ViT-g 518^2 bs8": _attention(8, n518 + 1, 24, n518 + 1, False),
        "2 DPT tail v2, C=128 392^2 bs8": _tail(8, 392, 128),
        # kernel 2 at the other paths' shapes: the ViT-L teacher of path 2
        # (C 256 at 392^2), the windowed teacher (path 3), pseudo-labelling
        # (path 5) and the windowed student's ViT-L teacher chunks (path 4)
        "2 DPT tail v2, C=256 392^2 bs8": _tail(8, 392, 256),
        "2 DPT tail v2, C=128 518^2 bs8": _tail(8, 518, 128),
        "2 DPT tail v2, C=128 1036^2 bs8": _tail(8, 1036, 128),
        "2 DPT tail v2, C=256 518^2 bs8": _tail(8, 518, 256),
        "2 DPT tail v2, C=256 1036^2 bs8": _tail(8, 1036, 256),
        # ViT-g's DPT features (the giant presets, path 7)
        "2 DPT tail v2, C=384 392^2 bs8": _tail(8, 392, 384),
        "2 DPT tail v2, C=384 518^2 bs8": _tail(8, 518, 384),
        "3 packed attention bwd, ViT-B 392^2 bs16": _attention(16, n392, 12, n392, True),
        "4 kth select, [112, 153664] int32": _bound(0.0, 112 * 153664 * 4 + 112 * 8),
        # the windowed student's 1036^2 step (path 4)
        "4 kth select, [112, 1073296] int32": _bound(0.0, 112 * 1073296 * 4 + 112 * 8),
        "5 bias attention fwd, window 518^2 bs8": _attention(8, n518, 12, win, False,
                                                             n518 * n518 * 2),
        "6 bias attention bwd, window student 518^2 bs16": _attention(16, n518, 12, win, True,
                                                                      n518 * n518 * 2),
        "7 banded attention fwd, window 1036^2 bs8": _attention(8, n1036, 12, win, False),
        "8 banded attention bwd, window student 1036^2 bs16": _attention(16, n1036, 12, win,
                                                                         True),
        **_w8a8_encoder("ViT-L 518^2 bs8", 8 * (n518 + 1), 1024, 24),
        # the int8 teacher of the distillation step: ViT-L in bs8 chunks at 392^2
        **_w8a8_encoder("ViT-L 392^2 bs8", 8 * n392, 1024, 24),
        **_w8a8_encoder("ViT-B 392^2 bs8", 8 * n392, 768, 12),
        **_w8a8_encoder("ViT-g 518^2 bs8", 8 * (n518 + 1), 1536, 40, "swiglu"),
        "10 DPT tail v1, C=128 392^2 bs8": _tail(8, 392, 128),
        # the windowed teacher's forward and the windowed student's backward
        "12 PEG conv fwd, window 1036^2 bs8": _peg(8, 768, 74, False),
        "12 PEG conv bwd, d(x) + d(weight), window student 1036^2 bs16": _peg(16, 768, 74, True),
        "12 PEG conv bwd, d(x) + d(weight), window student 518^2 bs16": _peg(16, 768, 37, True),
    }


def main() -> dict:
    table = bounds()
    for name, row in table.items():
        print(json.dumps({"kernel": name, **row}))
    return table


if __name__ == "__main__":
    main()
