"""Profiling and step timing.

Counterpart of distill_any_depth_tpu/utils/profiling.py (``trace``,
``device_sync``, ``StepTimer``): a ``torch.profiler`` trace written as a
Chrome trace (``chrome://tracing`` or Perfetto read it), with the card's
kernels when the device is a card, and a rolling window of step times that
gives steps/s and images/s.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["TRACE_FILE", "trace", "device_sync", "StepTimer"]

TRACE_FILE = "trace.json"  # inside the trace directory


def device_sync(device: str | torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """Trace the host and, on a card, its kernels while the block runs, and
    write ``log_dir/trace.json``: ``with trace(out): step(...)``."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            device_sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclass
class StepTimer:
    """Rolling step timing over the last ``window`` steps: ``tick(batch)``
    after each step."""

    window: int = 50
    _times: list = field(default_factory=list)
    _images: list = field(default_factory=list)
    _last: float | None = None

    def tick(self, batch_size: int = 1) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._images.append(batch_size)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._images.pop(0)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def images_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return sum(self._images) / sum(self._times)
