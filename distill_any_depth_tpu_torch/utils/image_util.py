"""Depth visualization helpers used by the inference CLI: the port's own
copy of ``normalize_disparity``, ``colorize_depth_maps`` and ``chw2hwc``
from distill_any_depth_tpu/utils/image_util.py."""
from __future__ import annotations

import numpy as np

__all__ = ["colorize_depth_maps", "chw2hwc", "normalize_disparity"]


def colorize_depth_maps(depth_map, min_depth: float, max_depth: float,
                        cmap: str = "Spectral_r") -> np.ndarray:
    """Colorize ``[H, W]``, ``[B, H, W]`` or ``[B, 1, H, W]`` depth as
    ``[B, 3, H, W]`` float in [0, 1]."""
    import matplotlib

    depth = np.asarray(depth_map).astype(np.float32)
    if depth.ndim == 2:
        depth = depth[None]
    elif depth.ndim == 4:
        depth = depth[:, 0]
    if depth.ndim != 3:
        raise ValueError(f"depth must be 2-, 3- or 4-D, got shape {depth.shape}")
    span = max(max_depth - min_depth, 1e-8)
    norm = np.clip((depth - min_depth) / span, 0, 1)
    colored = matplotlib.colormaps[cmap](norm, bytes=False)[:, :, :, 0:3]  # [B,H,W,3]
    return np.rollaxis(colored, 3, 1)


def chw2hwc(chw: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(chw), 0, -1)


def normalize_disparity(disp: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    disp = np.asarray(disp, np.float32)
    span = disp.max() - disp.min()
    return (disp - disp.min()) / (span + 1e-8)
