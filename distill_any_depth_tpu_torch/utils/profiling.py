"""Profiling, program spans and step timing.

Counterpart of distill_any_depth_tpu/utils/profiling.py (``trace``,
``device_sync``, ``StepTimer``): a ``torch.profiler`` trace written as a
Chrome trace (``chrome://tracing`` or Perfetto read it), with the card's
kernels when the device is a card, and a rolling window of step times that
gives steps/s and images/s.

The program's own spans and counters: ``span(name)`` marks a phase of a
call or step on the host (``with span("train/backward"): ...``) and
``count(name, n)`` adds to a counter; ``backward_span(name, out, inp,
counter, n)`` marks the part of a backward that runs from ``out``'s
gradient to ``inp``'s and counts. All three record only inside a
``recording()`` block, which returns what was recorded; outside one, the
default, ``span`` hands back one shared no-op context and ``count`` returns
at once. Blocks nest: a count reaches every block open when it is made, and
a span every block open when it began, so a counted region that holds a
``trace()`` block still sees what the trace recorded. Times are
``time.time_ns()``, the clock of the profiler's Chrome export, so a span
lines up with the kernels its phase launched. A span never synchronizes the
device nor reads a device value.

Each launch of a hand-written kernel counts ``kernels/<name>`` once
(``ops/_build.Kernel``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

__all__ = ["TRACE_FILE", "Span", "Recording", "span", "count", "backward_span", "recording",
           "add_spans", "trace", "device_sync", "StepTimer"]

TRACE_FILE = "trace.json"  # inside the trace directory
SPANS_PID = 1 << 30  # the Chrome trace's process id of the "program spans" track


class Span(NamedTuple):
    """One phase on the host: ``parent`` is the name of the span open on the
    same thread when it began (None at the outermost), ``root`` the id of
    the outermost span of its call or step, shared by every span of that
    unit, and ``thread`` the thread's ident."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    root: int
    thread: int


@dataclass
class Recording:
    """What a ``recording()`` block recorded: ``spans`` in the order they
    ended, and ``counted``, each ``count`` call as ``(name, n, time_ns)``."""

    spans: list = field(default_factory=list)
    counted: list = field(default_factory=list)

    @property
    def counts(self) -> dict[str, int]:
        """Each counter's total."""
        totals: dict[str, int] = {}
        for name, n, _ in self.counted:
            totals[name] = totals.get(name, 0) + n
        return totals

    def between(self, start_ns: int, end_ns: int) -> Recording:
        """The spans that began, and the counts made, in ``[start_ns,
        end_ns]``."""
        return Recording([s for s in self.spans if start_ns <= s.start_ns <= end_ns],
                         [c for c in self.counted if start_ns <= c[2] <= end_ns])


_recording: tuple[Recording, ...] | None = None  # every open recording() block's
_OFF = contextlib.nullcontext()
_roots = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("recs", "name", "parent", "root", "start")

    def __init__(self, recs: tuple[Recording, ...], name: str):
        self.recs, self.name = recs, name

    def __enter__(self):
        stack = _open_spans()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.name
        self.root = next(_roots) if top is None else top.root
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _open_spans().pop()
        done = Span(self.name, self.start, end, self.parent, self.root, threading.get_ident())
        for rec in self.recs:
            rec.spans.append(done)
        return False


def span(name: str):
    """A context that records the block as the span ``name`` while a
    ``recording()`` block is open; otherwise a shared no-op."""
    recs = _recording
    if recs is None:
        return _OFF
    return _Open(recs, name)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host number) to the counter ``name`` while a
    ``recording()`` block is open."""
    recs = _recording
    if recs is not None:
        entry = (name, n, time.time_ns())
        for rec in recs:
            rec.counted.append(entry)


def backward_span(name: str, out: torch.Tensor, inp: torch.Tensor, counter: str, n: int) -> None:
    """While a ``recording()`` block is open, mark the backward of the
    operations from ``inp`` to ``out`` as the span ``name``: it opens when
    ``out``'s gradient is ready, and counts ``n`` to ``counter``, and it
    closes when ``inp``'s gradient is, on whichever thread runs the backward
    (on a card, autograd's device thread). Call it in the forward, after the
    operations; it registers the two gradient hooks only where a recording
    is open, both tensors need a gradient and nothing is being traced, and
    the span records only if a recording is open when the backward runs."""
    if (_recording is None or not torch.is_grad_enabled() or not out.requires_grad
            or not inp.requires_grad or torch.compiler.is_compiling()):
        return
    opened = []

    def open_(grad):
        s = span(name)
        if s is not _OFF:
            opened.append(s.__enter__())
            count(counter, n)

    def close(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(open_)
    inp.register_hook(close)


@contextlib.contextmanager
def recording():
    """Record spans and counts, from every thread, while the block runs:
    ``with recording() as rec: ...``, then ``rec.spans`` and ``rec.counts``.
    Blocks nest; every open one records."""
    global _recording
    outer, rec = _recording, Recording()
    _recording = (rec,) if outer is None else (*outer, rec)
    try:
        yield rec
    finally:
        _recording = outer


def add_spans(path: str, rec: Recording) -> None:
    """Write ``rec``'s spans into the Chrome trace ``path``
    (``torch.profiler``'s export) on a "program spans" track: each span a
    complete event, one row a thread, on the trace's clock (its
    ``baseTimeNanoseconds``)."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    rows = {t: i for i, t in enumerate(sorted({s.thread for s in rec.spans}))}
    events = [{"ph": "M", "name": "process_name", "pid": SPANS_PID,
               "args": {"name": "program spans"}}]
    for s in rec.spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPANS_PID,
                       "tid": rows[s.thread], "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"parent": s.parent, "root": s.root}})
    data["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(data, f)


def device_sync(device: str | torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """Trace the host and, on a card, its kernels while the block runs, and
    write ``log_dir/trace.json``: ``with trace(out): step(...)``. The
    program's spans of the block are recorded and written into the same
    file (``add_spans``)."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec, torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            device_sync(device)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    add_spans(path, rec)


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
