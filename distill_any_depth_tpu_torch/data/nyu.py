"""NYU-Depth-V2 dataset (CSV rows of RGB/depth pairs) and its batches.

Counterpart of distill_any_depth_tpu/data/nyu.py (``epoch_order``,
``NYUDataset``, ``iterate_batches``), the Python loader: a square resize to
the target size (INTER_CUBIC for RGB, INTER_NEAREST for depth), uint8
depth /255 and uint16 /65535, ImageNet normalization, and a bounded retry
on unreadable files. ``raw_255=True`` feeds the unnormalized 0-255 images
(the reference loader's behaviour, for parity runs). Batches are NHWC
float32 numpy, as in the JAX package; the train step moves them to the
card. ``cv2`` is imported where an image is read. Not ported yet: the
multi-process shards of an epoch.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from distill_any_depth_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["NYUDataset", "iterate_batches", "epoch_order"]


def epoch_order(indices, seed: int = 0, shuffle: bool = True) -> np.ndarray:
    """The epoch order: ``indices`` (a list or a count), shuffled with
    ``seed`` when ``shuffle``."""
    idx = np.array(np.arange(indices) if np.isscalar(indices) else indices, dtype=np.int64)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    return idx


@dataclass
class NYUSample:
    image: np.ndarray  # [H, W, 3] float32
    depth: np.ndarray  # [H, W] float32 in [0, 1]
    rgb_path: str


class NYUDataset:
    MAX_ATTEMPTS = 10  # reads of other random rows after an unreadable one

    def __init__(self, mode: str, dataset_dir: str = "data/nyu", image_size: int = 392,
                 raw_255: bool = False, root_dir: str | None = None):
        self.mode = mode
        self.image_size = image_size
        self.raw_255 = raw_255
        self.root = os.path.abspath(root_dir or os.getcwd())
        csv_name = f"nyu2_{mode}.csv"
        candidates = [os.path.join(dataset_dir, csv_name), os.path.join("data", csv_name),
                      csv_name]
        csv_path = next((p for p in candidates if os.path.exists(p)), None)
        if csv_path is None:
            raise FileNotFoundError(f"CSV not found in any of {candidates}")
        with open(csv_path) as f:
            self.pairs = [row for row in csv.reader(f) if row]

    def __len__(self) -> int:
        return len(self.pairs)

    def _load(self, index: int) -> NYUSample:
        import cv2

        rgb_rel, depth_rel = self.pairs[index][0], self.pairs[index][1]
        rgb_path = os.path.join(self.root, rgb_rel)
        depth_path = os.path.join(self.root, depth_rel)
        size = (self.image_size, self.image_size)
        rgb = cv2.imread(rgb_path)
        if rgb is None:
            raise FileNotFoundError(rgb_path)
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
        rgb = cv2.resize(rgb, size, interpolation=cv2.INTER_CUBIC).astype(np.float32)
        depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise FileNotFoundError(depth_path)
        depth = cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST)
        depth = depth.astype(np.float32) / (65535.0 if depth.dtype == np.uint16 else 255.0)
        if depth.ndim == 3:
            depth = depth[..., 0]
        image = rgb if self.raw_255 else (rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return NYUSample(image=image, depth=depth, rgb_path=rgb_rel)

    def __getitem__(self, idx: int) -> NYUSample:
        rng = np.random.RandomState(idx)
        index = idx
        last_err: Exception | None = None
        for _ in range(self.MAX_ATTEMPTS):
            try:
                return self._load(index)
            except Exception as e:  # unreadable file -> bounded random retry
                last_err = e
                index = int(rng.randint(0, len(self.pairs)))
        raise RuntimeError(
            f"failed to load a valid sample after {self.MAX_ATTEMPTS} attempts") from last_err


PREFETCH = 2  # batches decoded ahead


def iterate_batches(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                    indices: list[int] | None = None):
    """Yield ``{'image': [B,H,W,3], 'depth': [B,H,W], 'rgb_path': [...]}``
    for every full batch of the epoch (the remainder is dropped). A daemon
    thread decodes ``PREFETCH`` batches ahead, so host IO overlaps the
    card's work.
    """
    idx = epoch_order(indices if indices is not None else len(dataset), seed=seed,
                      shuffle=shuffle)
    n = (len(idx) // batch_size) * batch_size

    def produce():
        for start in range(0, n, batch_size):
            chunk = [dataset[int(i)] for i in idx[start:start + batch_size]]
            yield {"image": np.stack([s.image for s in chunk]),
                   "depth": np.stack([s.depth for s in chunk]),
                   "rgb_path": [s.rgb_path for s in chunk]}

    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    sentinel = object()
    errors: list[BaseException] = []

    def put(item) -> None:
        # a bounded put with a stop check: an abandoned consumer must not
        # leave the thread blocked holding decoded batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for b in produce():
                put(b)
                if stop.is_set():
                    return
        except Exception as e:  # decode errors surface in the consumer
            errors.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True, name="nyu-prefetch").start()
    try:
        while True:
            b = q.get()
            if b is sentinel:
                if errors:
                    raise errors[0]
                return
            yield b
    finally:
        stop.set()
