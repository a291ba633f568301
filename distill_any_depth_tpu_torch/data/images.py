"""Unlabeled image folder for the paper's two-view distillation.

Counterpart of distill_any_depth_tpu/data/images.py (``ImagePairSample``,
``ImageFolderDataset``): every ``**/*.jpg`` and ``**/*.png`` under a
folder, sorted; a global view resized keeping its aspect (each side at
least ``global_size`` and a multiple of 14, cubic); a random square crop of
the global view as the local view, resized to ``local_size``; with
``square_global`` the global view resized to a square last. An unreadable
file gives the next index's sample.

One ``numpy.random.RandomState(seed)`` draws every crop, whichever split
asks for the sample, so the crops follow the order of access (as in the
JAX package): read samples in the step's order, on the thread that trains,
and never ahead of it. ``cv2`` is imported where an image is read.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob

import numpy as np

from distill_any_depth_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, Resize

__all__ = ["ImagePairSample", "ImageFolderDataset"]


@dataclass
class ImagePairSample:
    global_image: np.ndarray  # [Hg, Wg, 3] normalized float32
    local_image: np.ndarray  # [local_size, local_size, 3] normalized float32
    crop_box: tuple[int, int, int, int]  # (left, top, right, bottom) in the global view
    image_path: str


class ImageFolderDataset:
    def __init__(self, image_dir: str, global_size: int = 560, local_size: int = 560,
                 min_local_crop: int = 384, seed: int = 0,
                 image_paths: list[str] | None = None, square_global: bool = True):
        if image_paths is None:
            image_paths = sorted(glob(os.path.join(image_dir, "**/*.jpg"), recursive=True)
                                 + glob(os.path.join(image_dir, "**/*.png"), recursive=True))
        if not image_paths:
            raise ValueError(f"no images found in {image_dir}")
        self.image_paths = image_paths
        self.global_size = global_size
        self.local_size = local_size
        self.min_local_crop = min_local_crop
        self.square_global = square_global
        self.rng = np.random.RandomState(seed)
        self.global_resize = Resize(global_size, global_size, ensure_multiple_of=14,
                                    interpolation="INTER_CUBIC", keep_aspect_ratio=True)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> ImagePairSample:
        import cv2

        n = len(self.image_paths)
        idx %= n
        for _ in range(n):
            img = cv2.imread(self.image_paths[idx])
            if img is not None:
                break
            idx = (idx + 1) % n  # an unreadable file: the next index
        else:
            raise ValueError(f"no readable image among the {n} files")
        path = self.image_paths[idx]
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0

        g = self.global_resize({"image": img})["image"]
        gh, gw = g.shape[:2]
        min_crop = max(64, min(self.min_local_crop, gh - 2, gw - 2))
        max_crop = min(gh, gw)
        min_crop = min(min_crop, max_crop)  # stays valid for small global sizes
        crop = int(self.rng.randint(min_crop, max_crop + 1))
        left = int(self.rng.randint(0, max(0, gw - crop) + 1))
        top = int(self.rng.randint(0, max(0, gh - crop) + 1))
        right, bottom = min(left + crop, gw), min(top + crop, gh)

        local = cv2.resize(g[top:bottom, left:right], (self.local_size, self.local_size),
                           interpolation=cv2.INTER_CUBIC)
        if self.square_global:
            g = cv2.resize(g, (self.global_size, self.global_size),
                           interpolation=cv2.INTER_CUBIC)

        def norm(a):
            return ((a - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)

        return ImagePairSample(global_image=norm(g), local_image=norm(local),
                               crop_box=(left, top, right, bottom), image_path=path)
