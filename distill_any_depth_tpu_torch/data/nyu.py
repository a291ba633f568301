"""NYU-Depth-V2 dataset (CSV rows of RGB/depth pairs) and its batches.

Counterpart of distill_any_depth_tpu/data/nyu.py (``epoch_order``,
``NYUDataset``, ``iterate_batches``), the Python loader: a square resize to
the target size (INTER_CUBIC for RGB, INTER_NEAREST for depth), uint8
depth /255 and uint16 /65535, ImageNet normalization, and a bounded retry
on unreadable files. ``raw_255=True`` feeds the unnormalized 0-255 images
(the reference loader's behaviour, for parity runs). Batches are NHWC
float32 numpy, as in the JAX package; the train step moves them to the
card. With ``device_preprocess`` the image is the decoded uint8 RGB frame
at its native size (every frame of a batch must share it, as NYU's 640 x
480 do) and the Trainer resizes and normalizes it on the device
(``ops/preprocess``); the depth is still resized on the host. ``cv2`` is
imported where an image is read. Data parallelism shards an epoch
round-robin over the data ranks (``shard_index`` of ``num_shards``), after
the seeded shuffle that every rank draws alike, truncated so that every
shard yields the same number of batches (unequal counts would deadlock the
collectives): at step ``s`` the shards' rows of a local batch ``b`` are,
interleaved, the rows ``[s * b * num_shards, (s + 1) * b * num_shards)`` of
the single-process order.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from distill_any_depth_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["NYUDataset", "iterate_batches", "epoch_order"]


def epoch_order(indices, seed: int = 0, shuffle: bool = True, shard_index: int = 0,
                num_shards: int = 1) -> np.ndarray:
    """The epoch order: ``indices`` (a list or a count), shuffled with
    ``seed`` when ``shuffle``, then shard ``shard_index`` of ``num_shards``
    round-robin, truncated to ``len // num_shards`` entries."""
    idx = np.array(np.arange(indices) if np.isscalar(indices) else indices, dtype=np.int64)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    if num_shards > 1:
        idx = idx[shard_index::num_shards][:len(idx) // num_shards]
    return idx


@dataclass
class NYUSample:
    image: np.ndarray  # [H, W, 3] float32 (uint8 at its native size with device_preprocess)
    depth: np.ndarray  # [H, W] float32 in [0, 1]
    rgb_path: str


class NYUDataset:
    MAX_ATTEMPTS = 10  # reads of other random rows after an unreadable one

    def __init__(self, mode: str, dataset_dir: str = "data/nyu", image_size: int = 392,
                 raw_255: bool = False, root_dir: str | None = None,
                 device_preprocess: bool = False):
        self.mode = mode
        self.image_size = image_size
        self.raw_255 = raw_255
        self.device_preprocess = device_preprocess
        self.root = os.path.abspath(root_dir or os.getcwd())
        csv_name = f"nyu2_{mode}.csv"
        candidates = [os.path.join(dataset_dir, csv_name), os.path.join("data", csv_name),
                      csv_name]
        csv_path = next((p for p in candidates if os.path.exists(p)), None)
        if csv_path is None:
            raise FileNotFoundError(f"CSV not found in any of {candidates}")
        self.csv_path = csv_path
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
        if not self.device_preprocess:
            rgb = cv2.resize(rgb, size, interpolation=cv2.INTER_CUBIC).astype(np.float32)
        depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise FileNotFoundError(depth_path)
        depth = cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST)
        depth = depth.astype(np.float32) / (65535.0 if depth.dtype == np.uint16 else 255.0)
        if depth.ndim == 3:
            depth = depth[..., 0]
        if self.device_preprocess or self.raw_255:
            image = rgb  # uint8 at its native size, or unnormalized 0-255 floats
        else:
            image = (rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
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
                    indices: list[int] | None = None, shard_index: int = 0,
                    num_shards: int = 1):
    """Yield ``{'image': [B,H,W,3], 'depth': [B,H,W], 'rgb_path': [...]}``
    for every full batch of the epoch's shard ``shard_index`` of
    ``num_shards`` (``epoch_order``; the remainder is dropped). A daemon
    thread decodes ``PREFETCH`` batches ahead, so host IO overlaps the
    card's work.
    """
    idx = epoch_order(indices if indices is not None else len(dataset), seed=seed,
                      shuffle=shuffle, shard_index=shard_index, num_shards=num_shards)
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
