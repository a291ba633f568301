"""Resizing with PyTorch's ``F.interpolate`` coordinate semantics.

The plain paths call ``F.interpolate`` directly. ``resize_matrix`` is the
port's own copy of the JAX package's dense interpolation matrix
(distill_any_depth_tpu/ops/resize.py:64-127, numpy): the tests use it to
pin that ``F.interpolate`` and the matrices agree for the modes the model
uses (bilinear with ``align_corners=True``; bicubic with
``align_corners=False`` and an explicit scale factor). ``resize_1d`` is the
counterpart of the JAX ``resize_1d`` (one axis, torch 1-D interpolate), used
by the feature loss.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_matrix", "resize_nchw", "resize_1d"]


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel with PyTorch's a=-0.75."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def resize_matrix(
    in_size: int,
    out_size: int,
    method: str = "bilinear",
    align_corners: bool = False,
    scale: float | None = None,
) -> np.ndarray:
    """Dense ``[out_size, in_size]`` interpolation matrix.

    ``scale`` overrides the coordinate-mapping scale for
    ``align_corners=False``, as ``F.interpolate(scale_factor=...)`` does.
    """
    if method == "nearest":
        src = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
        src = np.clip(src, 0, in_size - 1)
        m = np.zeros((out_size, in_size), dtype=np.float32)
        m[np.arange(out_size), src] = 1.0
        return m

    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(dst) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        s = (in_size / out_size) if scale is None else (1.0 / scale)
        src = (dst + 0.5) * s - 0.5

    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    if method == "bilinear":
        if not align_corners:
            src = np.maximum(src, 0.0)
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        i0 = np.clip(i0, 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        np.add.at(m, (rows, i0), 1.0 - frac)
        np.add.at(m, (rows, i1), frac)
    elif method == "bicubic":
        # no clamp of the source coordinate for cubic; taps are clamped
        i = np.floor(src).astype(np.int64)
        t = src - i
        taps = np.clip(np.stack([i - 1, i, i + 1, i + 2], axis=1), 0, in_size - 1)
        w = np.stack(
            [_cubic_weight(t + 1.0), _cubic_weight(t), _cubic_weight(1.0 - t),
             _cubic_weight(2.0 - t)],
            axis=1,
        )
        for k in range(4):
            np.add.at(m, (rows, taps[:, k]), w[:, k])
    else:
        raise ValueError(f"unknown resize method: {method}")
    return m.astype(np.float32)


def resize_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of ``[B, C, H, W]`` — the DPT
    head's upsampling mode."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def resize_1d(x: torch.Tensor, out_size: int, method: str = "nearest",
              align_corners: bool = False, axis: int = -1) -> torch.Tensor:
    """Resize one axis of ``x`` to ``out_size`` with ``resize_matrix``'s
    weights. Nearest is a gather of the matrix's one source per output (the
    same values and gradient as the JAX package's one-hot product, without
    its dense GEMM); other methods multiply by the matrix."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = resize_matrix(in_size, out_size, method, align_corners)
    if method == "nearest":
        src = torch.from_numpy(m.argmax(axis=1)).to(x.device)
        return torch.index_select(x, axis, src)
    w = torch.from_numpy(m).to(device=x.device, dtype=x.dtype)
    return torch.movedim(torch.movedim(x, axis, -1) @ w.t(), -1, axis)
