"""Host spans and the reduction of a device trace.

Spans are ``(name, start_ns, end_ns)`` on the wall clock
(``time.time_ns``), the clock of ``torch.profiler``'s trace
(``baseTimeNanoseconds`` plus each event's ``ts``), so an idle gap of the
device can be named by the span that was open on the host. The kernel
classes are copied, and the union of intervals follows, the program's
``cli/profile_infer.py`` (``CLASSES``, ``classify``, ``busy_share``), so
that a change to the program cannot move them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from collections import defaultdict

__all__ = ["CLASSES", "classify", "Spans", "Trace", "profile", "from_chrome"]

CLASSES = (
    ("attention kernel", r"packed_attn_(wgmma|fp32)"),
    ("bias attention kernel", r"masked_attn_(wgmma|fp32)<.*BiasMask|bias_prep_kernel"),
    ("banded attention kernel", r"masked_attn_(wgmma|fp32)<.*WindowMask"),
    ("bias attention backward kernel", r"(masked_(dkdv|dq)_kernel|(dkdv|dq)_wgmma)<.*BiasMask"),
    ("banded attention backward kernel",
     r"(masked_(dkdv|dq)_kernel|(dkdv|dq)_wgmma)<.*WindowMask"),
    ("attention backward kernel (packed; all deltas)", r"(dkdv|dq)_(wgmma|fp32)|delta_kernel"),
    ("select kernel", r"kth_select_kernel"),
    ("w8a8 kernel (quantize pass, GEMM)", r"quantize_rows|gemm_wgmma|w8a8_kernel"),
    ("tail kernel", r"tail_conv_wgmma|tail_conv1_f32|tail_head_f32"),
    ("optimizer (fused Adam, norms)", r"fused_adam|FusedAdam|multi_tensor|foreach"),
    ("interpolate", r"upsample_|interp"),
    ("cast to bf16", r"bfloat16_copy_kernel"),
    ("copy / cat", r"direct_copy_kernel|CatArrayBatchedCopy"),
    ("layer norm", r"layer_norm_kernel"),
    ("depthwise conv (PEG, ATen)", r"conv_depthwise2d"),
    ("conv (cudnn)", r"cudnn"),
    ("int8 gemm (cublasLt, the int8 route)", r"imma|i8i8|s8s8|int8|i16832|i8816"),
    ("gemm (cublas)", r"nvjet|cublas|gemm"),
)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")  # the host's calls that enqueue device work
OTHER = "host: other"


def classify(name: str) -> str:
    for label, pattern in CLASSES:
        if re.search(pattern, name):
            return label
    return "other elementwise"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Spans:
    """Named host spans on the wall clock; off, it records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        if self.on:
            self.items.append((name, start_ns, end_ns))

    def mean_ms(self, name: str) -> float | None:
        d = [e - s for n, s, e in self.items if n == name]
        return sum(d) / len(d) / 1e6 if d else None


@dataclasses.dataclass
class Trace:
    """Device operations ``(name, start_ns, end_ns)`` of a traced window
    ``[start_ns, end_ns]`` that ran ``units`` calls or steps, with the host
    spans open in it and the host time at which each operation was enqueued
    (``launch_ns``, index for index with ``ops``; None where the trace has
    no launch for it)."""

    ops: list
    start_ns: int
    end_ns: int
    units: int
    spans: list
    launch_ns: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e9

    def _busy(self):
        return _union([(max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.ops
                       if e > self.start_ns and s < self.end_ns])

    def launched_in(self, span: str) -> float | None:
        """Seconds of device work (the union of the operations' intervals)
        that the host enqueued inside spans named ``span``; None where no
        operation was enqueued there."""
        spans = sorted((s, e) for n, s, e in self.spans if n == span)
        mine = [(s, e) for (_, s, e), t in zip(self.ops, self.launch_ns)
                if t is not None and any(a <= t <= b for a, b in spans)]
        if not mine:
            return None
        return sum(e - s for s, e in _union(mine)) / 1e9

    def class_seconds(self, label: str) -> float:
        return sum(e - s for n, s, e in self.ops if classify(n) == label) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by_name[n[:160]] += (e - s) / 1e9
        gaps: dict[str, float] = defaultdict(float)
        edges = [self.start_ns] + [x for iv in self._busy() for x in iv] + [self.end_ns]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_at(a, b)] += (b - a) / 1e9
        return {"device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top]}

    def _host_at(self, a: int, b: int) -> str:
        """The span that covers most of ``[a, b]`` on the host."""
        best, name = 0, OTHER
        for n, s, e in self.spans:
            overlap = min(b, e) - max(a, s)
            if overlap > best:
                best, name = overlap, n
        return name


def profile(run_units, units: int, spans: Spans) -> Trace:
    """Run ``run_units(units)`` under ``torch.profiler`` (CUDA activity
    alone: recording the host's operators too tripled the host time of a
    ViT-B forward) and return its device operations on the wall clock."""
    import torch

    first = len(spans.items)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.time_ns()
        run_units(units)
        torch.cuda.synchronize()
        end = time.time_ns()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return from_chrome(data, start, end, units, spans.items[first:])


def from_chrome(data: dict, start: int, end: int, units: int, spans: list) -> Trace:
    """A ``Trace`` of a chrome trace ``data`` (``torch.profiler``'s export)
    of the window ``[start, end]`` on the wall clock: its device operations,
    each with the host time of the call that enqueued it (matched by the
    trace's ``correlation`` id)."""
    base = int(data.get("baseTimeNanoseconds", 0))

    def ns(t):
        return base + int(t * 1000)

    events = [e for e in data["traceEvents"] if "dur" in e]
    launched = {e["args"]["correlation"]: ns(e["ts"]) for e in events
                if e.get("cat") in LAUNCHES and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_OPS]
    ops = [(e["name"], ns(e["ts"]), ns(e["ts"] + e["dur"])) for e in device]
    launch = [launched.get(e.get("args", {}).get("correlation")) for e in device]
    if ops and not any(start <= s <= end for _, s, _ in ops):
        # another clock: align the first operation with the window's start
        shift = start - min(s for _, s, _ in ops)
        ops = [(n, s + shift, e + shift) for n, s, e in ops]
        launch = [None if t is None else t + shift for t in launch]
    return Trace(ops=ops, start_ns=start, end_ns=end, units=units, spans=spans,
                 launch_ns=launch)
