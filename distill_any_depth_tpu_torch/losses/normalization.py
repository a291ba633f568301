"""Depth-map normalization strategies (global / hybrid / local / none).

Counterpart of distill_any_depth_tpu/losses/normalization.py, with its
reproduced quirks of the reference: segment boundaries overlap and later
segments overwrite earlier ones at shared boundary pixels; the hybrid
strategy's unused global normalization is not computed; the per-segment
statistic is a masked mean. Depth maps are ``[B, H, W]``.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.stats import median_all

__all__ = ["global_normalize", "hybrid_normalize", "normalize_depth"]


def global_normalize(depth: torch.Tensor) -> torch.Tensor:
    """(d - median) / (mean|d - median| + 1e-6), per image."""
    med = median_all(depth.reshape(depth.shape[0], -1))[:, None, None]
    mad = (depth - med).abs().mean(dim=(1, 2), keepdim=True)
    return (depth - med) / (mad + 1e-6)


def hybrid_normalize(depth: torch.Tensor, num_segments: int = 4) -> torch.Tensor:
    """Per-depth-range segment masked mean/MAD normalization."""
    flat = depth.reshape(depth.shape[0], -1)
    dmin = flat.amin(dim=-1)[:, None, None]
    dmax = flat.amax(dim=-1)[:, None, None]
    drange = dmax - dmin
    out = torch.zeros_like(depth)
    for i in range(num_segments):
        lo = dmin + (i / num_segments) * drange
        hi = dmin + ((i + 1) / num_segments) * drange
        mask = (depth >= lo) & (depth <= hi)
        maskf = mask.to(depth.dtype)
        seg = torch.where(mask, depth, 0.0)
        cnt = maskf.sum(dim=(1, 2), keepdim=True)
        mean = seg.sum(dim=(1, 2), keepdim=True) / (cnt + 1e-6)
        mad = ((seg - mean).abs() * maskf).sum(dim=(1, 2), keepdim=True) / (cnt + 1e-6)
        out = torch.where(mask, (seg - mean) / (mad + 1e-6), out)
    return out


def normalize_depth(depth: torch.Tensor, strategy: str, num_segments: int = 4) -> torch.Tensor:
    """Dispatcher; 'local' is an alias of 'hybrid'."""
    if strategy == "global":
        return global_normalize(depth)
    if strategy in ("hybrid", "local"):
        return hybrid_normalize(depth, num_segments)
    if strategy == "none":
        return depth
    raise ValueError(f"unknown normalization strategy: {strategy}")
