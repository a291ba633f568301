"""Run one cell of the benchmark once, on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets the cell up (the program built once,
weights and inputs made on the card from ``--seed``, every shape warmed
up), measures ``--seconds`` seconds, then checks what the timed path
produced against the plain reference. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` records host spans in the window, traces
a short window after it with ``torch.profiler`` and reports the per-layer
metrics, with ``device.busy_s``/``window_s`` and a ``breakdown``. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key. Without a card, or with ``jax``, ``jaxlib``, ``flax`` or the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "distill_any_depth_tpu")
CHIPS_ERROR, IMPORT_ERROR = 3, 4


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load, each
    compared whole (``distill_any_depth_tpu_torch`` is not the JAX
    package)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import check, harness, spec

    cell = spec.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return CHIPS_ERROR
    ctx, numbers = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                    T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return IMPORT_ERROR

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = check.judge(numbers, cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": correct, "attempted": ctx.units, "failed": ctx.failed,
              "metrics": metrics, "device": device}
    if args.trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    print("set-up, s: " + " ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items()),
          file=sys.stderr)
    print("window quarters, units/s: " + " ".join(f"{r:.3f}" for r in harness.quarters(ctx)),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
