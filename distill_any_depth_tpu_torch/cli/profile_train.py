"""Where the time of a distillation train step goes on the card.

Run on a machine with a CUDA card:

    python -m distill_any_depth_tpu_torch.cli.profile_train [--out DIR]
        [--student_arch ARCH] [--image_size RES] [--teacher_quant none]
        [--teacher ARCH] [--two_views] [--adapters]

It builds ``train.loop.Trainer`` at the configuration of the JAX package's
``bench.py`` train step by default (student ``depthanything-base``, teacher
``depthanything-large``, bs16 at 392^2, bf16 compute, the default loss
stack, shared views, the teacher in bs8 chunks); ``--student_arch
depthanything-base-window --image_size 518`` (or ``1036``) breaks down the
windowed student's step instead; ``--teacher_quant int8_pallas`` runs the
teacher's GEMMs through kernel 9; ``--teacher depthanything-giant-reg``
breaks down the step under the ViT-g register teacher; ``--two_views``
times the image-folder step (the student on a global and a local view);
``--adapters`` the adapter-only step of ``cli.train --lora_rank 8 --use_ssf
--adapter_only``. It reports, for whole steps of the real step function:

- the host time to enqueue a step and what the device still needs after,
  with the program's span recording off and on (its cost: medians of
  ``ROUNDS`` windows of ``ITERS`` steps each way, in turns);
- each program span's host ms a step (``train/step`` and its phases,
  ``utils/profiling.span``), recorded while a ``torch.profiler`` trace (CUDA
  activity only) runs;
- from that trace: device time per step by kernel class
  (``profile_infer.CLASSES``) and for the top kernels, launches per step,
  and the device's busy share. The trace is written with the spans on a
  "program spans" track (``utils/profiling.add_spans``).

The step's wall time and steps/s are ``chip_smoke.py``'s to measure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from collections import defaultdict

import torch

from distill_any_depth_tpu_torch.cli.profile_infer import busy_share, classify
from distill_any_depth_tpu_torch.utils.profiling import add_spans, recording

ITERS, WARMUP, TOP = 5, 2, 30  # steps timed and traced, warm-up steps, kernels listed
ROUNDS = 5  # windows timed with recording off and on, in turns
ADAPTER_RANK = 8  # --adapters: LoRA rank 8 and SSF, adapter-only
STUDENT, TEACHER, RES, BATCH = "depthanything-base", "depthanything-large", 392, 16


def main(argv=None) -> dict:
    from distill_any_depth_tpu_torch.configs import TrainConfig, model_config
    from distill_any_depth_tpu_torch.train.loop import Trainer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="chiprun_out/profile")
    p.add_argument("--student_arch", default=STUDENT)
    p.add_argument("--image_size", type=int, default=RES)
    p.add_argument("--teacher_quant", default="none", choices=["none", "int8", "int8_pallas"])
    p.add_argument("--teacher", default=TEACHER)
    p.add_argument("--two_views", action="store_true")
    p.add_argument("--adapters", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    arch, res, batch = args.student_arch, args.image_size, BATCH

    student_cfg = model_config(arch)
    if args.adapters:
        student_cfg = dataclasses.replace(student_cfg, encoder=dataclasses.replace(
            student_cfg.encoder, lora_rank=ADAPTER_RANK, use_ssf=True))
    cfg = TrainConfig(student=student_cfg, teachers=(args.teacher,),
                      batch_size=batch, image_size=res, log_interval=10 ** 6,
                      teacher_quant=args.teacher_quant, adapter_only=args.adapters,
                      output_dir=os.path.join(args.out, "train"))
    trainer = Trainer(cfg, "cuda")
    trainer._build_steps(views_shared=not args.two_views)
    state = trainer.state
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, 3, res, res, generator=gen, device="cuda")
    x_global = torch.randn(batch, 3, res, res, generator=gen, device="cuda")

    def step():
        trainer.train_step(state, 0, x_global if args.two_views else x, x)

    def enqueue_and_drain() -> tuple[float, float]:
        """Host ms a step to enqueue ``ITERS`` steps, and the device's ms
        after the last enqueue."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / ITERS * 1e3, (time.perf_counter() - t1) * 1e3

    for _ in range(WARMUP):
        step()
    off, on = [], []
    for _ in range(ROUNDS):
        off.append(enqueue_and_drain())
        with recording():
            on.append(enqueue_and_drain())
    enqueue_ms, drain_ms = (statistics.median(col) for col in zip(*off))
    enqueue_recorded_ms = statistics.median(e for e, _ in on)

    with recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
    span_ms: dict[str, float] = defaultdict(float)
    for s in rec.spans:
        span_ms[s.name] += (s.end_ns - s.start_ns) / 1e6 / ITERS
    os.makedirs(args.out, exist_ok=True)
    variant = ("_two_views" if args.two_views else "") + ("_adapters" if args.adapters else "")
    trace_path = os.path.join(
        args.out, f"train_{arch}_{args.teacher}_{res}_bs{batch}_{args.teacher_quant}{variant}.json")
    prof.export_chrome_trace(trace_path)
    add_spans(trace_path, rec)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise SystemExit("the trace holds no kernel events: device tracing did not work")
    by_class: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for e in kernels:
        by_class[classify(e["name"])] += e["dur"]
        by_name[e["name"]] += e["dur"]
        count[e["name"]] += 1
    busy, span = busy_share([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    per_step = ITERS * 1e3  # us -> ms per step
    report = {
        "device": torch.cuda.get_device_name(0),
        "student": arch, "teacher": args.teacher, "teacher_quant": args.teacher_quant, "res": res,
        "batch": batch, "two_views": args.two_views, "adapters": args.adapters,
        "host_enqueue_ms_per_step": enqueue_ms, "device_drain_ms_after_enqueue": drain_ms,
        "host_enqueue_ms_per_step_recording": enqueue_recorded_ms,
        "host_enqueue_ms_windows": {"off": [e for e, _ in off], "on": [e for e, _ in on]},
        "span_host_ms_per_step": dict(span_ms),
        "traced_kernel_ms_per_step": sum(by_class.values()) / per_step,
        "traced_span_ms_per_step": span / per_step,
        "device_busy_share": busy / span,
        "by_class_ms_per_step": {k: v / per_step for k, v in
                                 sorted(by_class.items(), key=lambda kv: -kv[1])},
        "kernels_per_step": len(kernels) / ITERS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "trace": trace_path,
    }
    print(json.dumps(report, indent=1))
    print(f"top {TOP} kernels by device time (ms per step, launches per step):")
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {dur / per_step:8.4f} ms  {count[name] / ITERS:6.1f}  "
              f"[{classify(name)}] {name[:110]}")
    return report


if __name__ == "__main__":
    main()
