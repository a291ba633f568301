"""Host-side image transforms (numpy/cv2) used by the inference CLI.

The port's own copy of the part of distill_any_depth_tpu/data/transforms.py
that the CLI and the evaluation registry use: ``Compose``, ``Resize`` (the
reference's lower-bound sizing rule and its ``get_size``), ``NormalizeImage``, ``PrepareForNet`` and ``standard_transform``.
``cv2`` is imported only where an image is resized.
"""
from __future__ import annotations

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "Compose", "Resize", "NormalizeImage",
           "PrepareForNet", "standard_transform"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class Resize:
    """Resize ``sample["image"]`` to at least (width, height), each side a
    multiple of ``ensure_multiple_of``: the reference's ``lower_bound``
    sizing, with the aspect ratio kept when ``keep_aspect_ratio`` (the
    registry's native-resolution protocol) and not otherwise (the CLI).
    ``interpolation`` is a cv2 flag name."""

    def __init__(self, width: int, height: int, ensure_multiple_of: int = 1,
                 interpolation: str = "INTER_AREA", keep_aspect_ratio: bool = False):
        self.width = width
        self.height = height
        self.multiple_of = ensure_multiple_of
        self.interpolation = interpolation
        self.keep_aspect_ratio = keep_aspect_ratio

    def _snap(self, x: float, min_val: int) -> int:
        """The nearest multiple, or the next one up if that falls below
        ``min_val``."""
        m = self.multiple_of
        y = int(np.round(x / m) * m)
        return y if y >= min_val else int(np.ceil(x / m) * m)

    def get_size(self, width: int, height: int) -> tuple[int, int]:
        """The ``(width, height)`` an image of that size is resized to."""
        scale_h, scale_w = self.height / height, self.width / width
        if self.keep_aspect_ratio:
            scale_h = scale_w = max(scale_w, scale_h)
        return (self._snap(scale_w * width, self.width),
                self._snap(scale_h * height, self.height))

    def __call__(self, sample: dict) -> dict:
        import cv2

        h, w = sample["image"].shape[:2]
        sample["image"] = cv2.resize(sample["image"], self.get_size(w, h),
                                     interpolation=getattr(cv2, self.interpolation))
        return sample


class NormalizeImage:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: dict) -> dict:
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class PrepareForNet:
    """fp32, contiguous, HWC (callers batch with a leading axis)."""

    def __call__(self, sample: dict) -> dict:
        sample["image"] = np.ascontiguousarray(sample["image"], dtype=np.float32)
        return sample


def standard_transform(size: int, multiple_of: int = 14) -> Compose:
    """The inference preprocessing chain: cubic resize + ImageNet normalize."""
    return Compose([
        Resize(size, size, ensure_multiple_of=multiple_of, interpolation="INTER_CUBIC"),
        NormalizeImage(),
        PrepareForNet(),
    ])
