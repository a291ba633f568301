"""Device-side image preprocessing.

Counterpart of distill_any_depth_tpu/ops/preprocess.py: decoded uint8
images go to the device raw, and the square resize, /255 and the ImageNet
normalization run there. The output is NCHW, the model's layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["DEFAULT_BUCKETS", "snap_to_bucket", "preprocess_on_device"]

# multiple-of-14 sizes covering the reference's operating points
DEFAULT_BUCKETS = (196, 266, 392, 518, 700, 924)


def snap_to_bucket(size: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= size (the largest bucket if none)."""
    for b in buckets:
        if b >= size:
            return b
    return buckets[-1]


def preprocess_on_device(images: torch.Tensor, target: int, normalize: bool = True,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 or [0, 1] float ``[B, H, W, 3]`` -> ``[B, 3, target, target]``:
    fp32 bicubic resize (``align_corners=False``, no antialias), /255 for
    uint8, ImageNet normalize, then a cast to ``dtype``."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(target, target), mode="bicubic", align_corners=False)
    if images.dtype == torch.uint8:
        x = x / 255.0
    if normalize:
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.as_tensor(IMAGENET_STD, device=x.device)[:, None, None]
        x = (x - mean) / std
    return x.to(dtype)
