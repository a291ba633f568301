"""Plain float32 preprocessing of the benchmark's images: the program's
``ops/preprocess`` (uint8 frames, bicubic resize, ImageNet normalization)
and ``data/nyu``'s decode of an RGB file, written from their definitions."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess", "decode_nyu"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(image_u8: np.ndarray, res: int, device) -> torch.Tensor:
    """A uint8 RGB ``[H, W, 3]`` image -> ``[1, 3, res, res]`` float32: /255,
    bicubic resize (no antialias), ImageNet normalization."""
    x = torch.from_numpy(image_u8).to(device).permute(2, 0, 1)[None].float() / 255.0
    x = F.interpolate(x, size=(res, res), mode="bicubic", align_corners=False)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)[:, None, None]
    std = torch.from_numpy(IMAGENET_STD).to(device)[:, None, None]
    return (x - mean) / std


def decode_nyu(rgb_path: str, res: int) -> np.ndarray:
    """An NYU RGB file -> ``[res, res, 3]`` float32, normalized: cv2 decode,
    cubic resize, /255, ImageNet normalization (the dataset's transform)."""
    import cv2

    bgr = cv2.imread(rgb_path)
    if bgr is None:
        raise FileNotFoundError(rgb_path)
    rgb = cv2.resize(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), (res, res),
                     interpolation=cv2.INTER_CUBIC).astype(np.float32)
    return (rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
