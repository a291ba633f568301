"""Host-side image transforms (numpy/cv2) used by the inference CLI.

The port's own copy of the part of distill_any_depth_tpu/data/transforms.py
that the CLI uses: ``Compose``, ``Resize`` (the reference's lower-bound
sizing rule), ``NormalizeImage``, ``PrepareForNet`` and ``standard_transform``.
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
    sizing without aspect preservation, the one the CLI uses.
    ``interpolation`` is a cv2 flag name."""

    def __init__(self, width: int, height: int, ensure_multiple_of: int = 1,
                 interpolation: str = "INTER_AREA"):
        self.width = width
        self.height = height
        self.multiple_of = ensure_multiple_of
        self.interpolation = interpolation

    def _snap(self, x: int) -> int:
        """The nearest multiple, or the next one up if that falls below x."""
        m = self.multiple_of
        y = int(np.round(x / m) * m)
        return y if y >= x else int(np.ceil(x / m) * m)

    def __call__(self, sample: dict) -> dict:
        import cv2

        size = (self._snap(self.width), self._snap(self.height))
        sample["image"] = cv2.resize(sample["image"], size,
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
