"""ctypes binding of the native C++ NYU loader.

Counterpart of distill_any_depth_tpu/data/native_loader.py, over the port's
own copy of the C++ source (``native/dad_loader.cpp``, the same C API,
reorder buffer and retry). ``g++`` builds it at first use against the
system OpenCV (``/usr/include/opencv4``, ``-lopencv_core
-lopencv_imgcodecs -lopencv_imgproc``) into ``build/`` at the repository
root, named by a hash of its source and renamed into place, so a
concurrent reader never sees a partial file and an edited source rebuilds.
Where the compiler or OpenCV's headers are missing, ``available()`` is
False with a logged warning, and ``train/loop.train_nyu`` takes the Python
loader.

The C++ side owns a thread pool and a bounded reorder buffer; Python
allocates NHWC float32 numpy buffers that the workers fill, and owns the
order: ``data/nyu.epoch_order``, the Python loader's seeded shuffle and
round-robin shard. So the two loaders yield the same epochs for the same
(CSV, seed, shards), and the same batches bit for bit where the system
OpenCV resizes as the ``cv2`` package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from distill_any_depth_tpu_torch.data.nyu import epoch_order
from distill_any_depth_tpu_torch.ops._build import BUILD_DIR

logger = logging.getLogger("distill_any_depth_tpu_torch.native")

__all__ = ["SOURCE", "OPENCV_INCLUDE", "build", "available", "NativeNYULoader"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "dad_loader.cpp"
OPENCV_INCLUDE = "/usr/include/opencv4"
_LIBS = ("-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # the failed build's log: one attempt per process


def _target() -> Path:
    sha = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdadloader_{sha}.so"


def build() -> Path:
    """The built library's path, compiling it first if needed; raises
    ``RuntimeError`` with the compiler's output if it cannot be built."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", f"-I{OPENCV_INCLUDE}",
           "-shared", "-o", str(tmp), str(SOURCE), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native loader build failed: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed:\n{proc.stderr or proc.stdout}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            logger.warning("%s", _error[-2000:])
            return None
        lib.dad_loader_create.restype = ctypes.c_void_p
        lib.dad_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.dad_loader_set_epoch.restype = None
        lib.dad_loader_set_epoch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ]
        lib.dad_loader_num_samples.restype = ctypes.c_long
        lib.dad_loader_num_samples.argtypes = [ctypes.c_void_p]
        lib.dad_loader_next_batch.restype = ctypes.c_int
        lib.dad_loader_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.dad_loader_destroy.restype = None
        lib.dad_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built or can be (one build attempt per
    process; a failure is logged as a warning)."""
    return _load() is not None


class NativeNYULoader:
    """A prefetched NYU batch stream from the C++ loader, with
    ``data/nyu.iterate_batches``'s dict contract (``image [B, H, W, 3]``,
    ``depth [B, H, W]``, float32).

    Each epoch's order is ``data/nyu.epoch_order`` of the CSV's rows (or of
    the rows ``indices``, a split of them) with ``seed + epoch``, sharded
    round-robin over ``num_shards``: the Python loader's order for the same
    arguments. The C++ workers decode it concurrently and deliver it in
    order. ``csv_path`` holds ``rgb,depth`` rows relative to ``root_dir``;
    a CSV with no row raises ``FileNotFoundError``."""

    def __init__(self, csv_path: str, root_dir: str, image_size: int = 392,
                 batch_size: int = 16, normalize: bool = True, raw_255: bool = False,
                 num_threads: int | None = None, queue_capacity: int = 64,
                 shuffle: bool = True, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, indices=None):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        if num_threads is None:
            num_threads = min(os.cpu_count() or 1, 8)
        self._lib = lib
        self._handle = lib.dad_loader_create(
            csv_path.encode(), root_dir.encode(), image_size, int(normalize), int(raw_255),
            num_threads, queue_capacity)
        if not self._handle:
            raise FileNotFoundError(f"no samples loadable from {csv_path}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = max(num_shards, 1)
        self.indices = None if indices is None else list(indices)
        self._stream = self._index_stream(0)
        self._remaining = 0
        self._images = np.empty((batch_size, image_size, image_size, 3), np.float32)
        self._depths = np.empty((batch_size, image_size, image_size), np.float32)

    def __len__(self) -> int:
        """The epoch's global sample count (the shards are cut per epoch):
        the CSV's rows, or ``indices``."""
        if self.indices is not None:
            return len(self.indices)
        return int(self._lib.dad_loader_num_samples(self._handle))

    def shard_len(self) -> int:
        return len(self) // self.num_shards

    def _index_stream(self, start_epoch: int):
        rows = len(self) if self.indices is None else self.indices
        for epoch in itertools.count(start_epoch):
            yield from epoch_order(rows, seed=self.seed + epoch, shuffle=self.shuffle,
                                   shard_index=self.shard_index, num_shards=self.num_shards)

    def _install(self, need: int) -> None:
        idx = np.fromiter(itertools.islice(self._stream, need), dtype=np.int64, count=need)
        self._lib.dad_loader_set_epoch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx))
        self._remaining = need

    def next_batch(self) -> dict:
        if self._remaining < self.batch_size:
            # installing resets the C++ delivery, so a new stretch goes in
            # only once the last is drained (batches() installs a whole
            # epoch at once, which lets the workers run ahead)
            if self._remaining:
                raise RuntimeError("native loader: a partial batch is left in the stream")
            self._install(self.batch_size)
        n = self._lib.dad_loader_next_batch(
            self._handle, self.batch_size,
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._depths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < self.batch_size:
            raise RuntimeError("native loader stream ended unexpectedly")
        self._remaining -= self.batch_size
        # copies: the next call refills the buffers
        return {"image": self._images.copy(), "depth": self._depths.copy()}

    def batches(self, steps: int, epoch: int | None = None):
        """Yield ``steps`` batches. With ``epoch`` the stream restarts at
        that epoch's order (a data-exact resume, a validation replay);
        otherwise it goes on where it stopped."""
        if epoch is not None:
            self._stream = self._index_stream(epoch)
            self._remaining = 0
        if self._remaining == 0 and steps > 0:
            self._install(steps * self.batch_size)
        for _ in range(steps):
            yield self.next_batch()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dad_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeNYULoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
