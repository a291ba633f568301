"""The program's own spans and counters over one run of a cell: the host's
enqueue and the device's idle time split by the phase the program was in.

    python3 -m portbench.phases --workload <name> --seed <n> --seconds <s> [--record 0|1]

from the root of a checkout, on the card. It runs the cell as
``portbench.run --trace 1`` does (set-up, the measured window, then the
traced window), with the program's span recording
(``distill_any_depth_tpu_torch.utils.profiling.recording``) open over the
whole run when ``--record 1``, the default; it skips the correctness check.
It prints one JSON line:

- ``harness``: the run's own ``step_enqueue_ms.train`` or
  ``fwd_enqueue_ms.infer`` (the harness's spans, measured window) and
  ``device_idle`` (%, traced window); with ``--record 0`` nothing else, so
  two runs give the cost of recording;
- ``metrics``, per step or per call (the program's root spans, ``train/step``
  or ``predict``, in the window): for training each phase's
  ``<phase>_enqueue_ms.train``, the host ms in its span over the measured
  window, and ``<phase>_idle_ms.train``, the device's idle ms while it was
  open in the traced window; ``launches.train``, kernels launched inside
  ``train/step``; ``upload_gb_s.train``, ``train/upload_bytes`` over the device
  time of the host-to-device copies launched in ``train/upload``. For
  inference ``upload_idle_ms.infer``, ``readback_idle_ms.infer``,
  ``concat_idle_ms.infer``, and ``upload_gb_s.infer`` and ``readback_gb_s.infer``
  from ``predict/upload_bytes`` and ``predict/readback_bytes`` and the copies
  launched in ``predict/upload`` and ``predict/readback``;
- ``host_ms`` and ``idle_ms``: the same two readings for every span name,
  ``host_ms_traced``: the host ms of each in the traced window (the
  profiler slows the host's launches), ``idle_uncovered_share``: the share
  of the traced idle time under no program span, and the counters' totals
  of each window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

__all__ = ["merge", "union", "idle_in", "launched_in", "launches", "copy_seconds", "split", "main"]

ROOTS = {"train": "train/step", "infer": "predict"}
TRAIN_PHASES = ("student_fwd", "teacher_fwd", "loss", "backward", "optimizer")
HARNESS_ENQUEUE = {"train": ("step_enqueue_ms.train", "step.enqueue"),
                   "infer": ("fwd_enqueue_ms.infer", "predict.forward")}
NOT_KERNELS = ("Memcpy", "Memset")  # the names the profiler gives copies and sets


def merge(intervals) -> list[tuple[int, int]]:
    """The union of ``intervals``, disjoint and sorted."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def union(spans, *names: str) -> list[tuple[int, int]]:
    """The union of the intervals of the spans called one of ``names``."""
    return merge((s.start_ns, s.end_ns) for s in spans if s.name in names)


def _inside(t: int | None, intervals: list[tuple[int, int]]) -> bool:
    if t is None:
        return False
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def idle_in(trace, intervals: list[tuple[int, int]]) -> float:
    """Seconds of the traced window inside ``intervals`` (disjoint, sorted)
    in which no device operation ran."""
    busy = trace._busy()
    idle = 0
    for a, b in intervals:
        a, b = max(a, trace.start_ns), min(b, trace.end_ns)
        if b <= a:
            continue
        idle += b - a
        for s, e in busy[max(0, bisect.bisect_left(busy, (a, a)) - 1):]:
            if s >= b:
                break
            idle -= max(0, min(b, e) - max(a, s))
    return idle / 1e9


def launched_in(trace, intervals: list[tuple[int, int]]) -> list[tuple[str, int, int]]:
    """The device operations whose launch (matched by correlation id) the
    host made inside ``intervals``."""
    return [op for op, t in zip(trace.ops, trace.launch_ns) if _inside(t, intervals)]


def launches(trace, intervals) -> int:
    """Kernels (not copies or sets) launched inside ``intervals``."""
    return sum(not n.startswith(NOT_KERNELS) for n, _, _ in launched_in(trace, intervals))


def copy_seconds(trace, intervals, direction: str) -> float:
    """Device seconds of the copies (``direction`` ``HtoD`` or ``DtoH``)
    launched inside ``intervals``."""
    return sum(e - s for n, s, e in launched_in(trace, intervals)
               if n.startswith("Memcpy") and direction in n) / 1e9


def _per_unit(value, units: int):
    return None if value is None or not units else value / units


def split(ctx, rec, kind: str) -> dict:
    """The readings of the docstring from the harness's context ``ctx`` of a
    ``--trace 1`` run and the program's recording ``rec`` of it (``kind``
    ``train`` or ``infer``)."""
    t = ctx.trace
    measured = rec.between(min(s for _, s, _ in ctx.spans.items), t.start_ns - 1)
    traced = rec.between(t.start_ns, t.end_ns)
    root = ROOTS[kind]
    units_m = sum(s.name == root for s in measured.spans)
    units_t = sum(s.name == root for s in traced.spans)
    names = sorted({s.name for s in rec.spans})

    def host_ms(window, units):
        return {n: _per_unit(sum((s.end_ns - s.start_ns) / 1e6 for s in window.spans
                                 if s.name == n), units) for n in names}

    host = host_ms(measured, units_m)
    idle = {n: _per_unit(1e3 * idle_in(t, union(traced.spans, n)), units_t) for n in names}
    idle_total = t.window_s - t.busy_s
    uncovered = idle_total - idle_in(t, union(traced.spans, *names))
    counts = traced.counts
    m: dict[str, float | None] = {}
    if kind == "train":
        for p in TRAIN_PHASES:
            m[f"{p}_enqueue_ms.train"] = host.get(f"train/{p}")
            m[f"{p}_idle_ms.train"] = idle.get(f"train/{p}")
        m["launches.train"] = _per_unit(launches(t, union(traced.spans, root)), units_t)
        m["upload_gb_s.train"] = _gb_s(counts.get("train/upload_bytes"),
                                       copy_seconds(t, union(traced.spans, "train/upload"),
                                                    "HtoD"))
    else:
        for p in ("upload", "readback", "concat"):
            m[f"{p}_idle_ms.infer"] = idle.get(f"predict/{p}")
        for p, direction in (("upload", "HtoD"), ("readback", "DtoH")):
            m[f"{p}_gb_s.infer"] = _gb_s(counts.get(f"predict/{p}_bytes"),
                                         copy_seconds(t, union(traced.spans, f"predict/{p}"),
                                                      direction))
    return {"units": {"measured": units_m, "traced": units_t}, "metrics": m, "host_ms": host,
            "host_ms_traced": host_ms(traced, units_t), "idle_ms": idle, "idle_ms_per_unit": _per_unit(1e3 * idle_total, units_t),
            "idle_uncovered_share": uncovered / idle_total if idle_total > 0 else None,
            "counts": {"measured": measured.counts, "traced": counts}}


def _gb_s(nbytes, seconds: float):
    return None if not nbytes or seconds <= 0 else nbytes / seconds / 1e9


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import contextlib

    import torch

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA device", file=sys.stderr)
        return 3
    from distill_any_depth_tpu_torch.utils import profiling

    kind = cell.traffic["driver"]
    with profiling.recording() if args.record else contextlib.nullcontext() as rec:
        _, ctx, _ = harness.run(cell, args.seed, args.seconds, True, "cuda", T_START)
    name, span = HARNESS_ENQUEUE[kind]
    t = ctx.trace
    out = {"workload": cell.name, "seed": args.seed, "record": args.record,
           "device": torch.cuda.get_device_name(0), "window_units": ctx.units,
           "harness": {name: ctx.spans.mean_ms(span),
                       "device_idle": 100.0 * (1.0 - t.busy_s / t.window_s)}}
    if args.record:
        out.update(split(ctx, rec, kind))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
