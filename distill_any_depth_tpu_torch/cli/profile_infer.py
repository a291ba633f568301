"""Where the time of a depth forward goes on the card.

Run on a machine with a CUDA card:

    python -m distill_any_depth_tpu_torch.cli.profile_infer \
        [--arch_name depthanything-base] [--res 392] [--batch 8] [--quant none]

(the windowed teacher: ``--arch_name depthanything-base-window --res 518``
runs the bias kernel, ``--res 1036`` the banded one; path 5, the ViT-L
pseudo-labelling forward: ``--arch_name depthanything-large --res 518
--quant int8_pallas``, whose GEMMs are kernel 9).

Under ``torch.inference_mode()``, as ``cli/infer.predict`` runs the model,
it measures the host time to enqueue a forward and the time the device
still needs after that, then traces 10 forwards with ``torch.profiler`` and
prints, from the trace's kernel events: device time per forward by kernel
class and for the top kernels, and the device's busy share of the traced
window (the union of kernel intervals over the span from the first kernel's
start to the last one's end). The Chrome trace is written under ``--out``.
The forward's wall time and images/s are ``chip_smoke.py``'s to measure.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import time
from collections import defaultdict

import torch

ITERS, TOP = 10, 25  # forwards traced, kernels listed

# kernel name pattern -> class, first match wins. The patterns are the
# kernel names of torch 2.11 / CUDA 12.8: ATen's elementwise kernels carry
# their functor in the name (``gpu_kernel_impl_nocast<CUDAFunctor_add>``),
# cuDNN's (convs and their layout transposes) carry ``cudnn``, and cuBLAS's
# GEMMs are ``nvjet_*`` or ``*_cublas``.
CLASSES = (
    ("attention kernel", r"packed_attn_(wgmma|fp32)"),
    # the bias's tile marks and fp32 terms: kernel 5's first pass (kernel 6's
    # too when called without them, as the training path never does)
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


def classify(name: str) -> str:
    for label, pattern in CLASSES:
        if re.search(pattern, name):
            return label
    return "other elementwise"


def cuda_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 1) -> float:
    """Median over ``windows`` of the mean time of ``iters`` calls of
    ``fn``, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def busy_share(intervals: list[tuple[float, float]]) -> tuple[float, float]:
    """(union of the intervals, span from first start to last end), in us."""
    intervals = sorted(intervals)
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, intervals[-1][1] - intervals[0][0]


def main(argv=None) -> dict:
    from distill_any_depth_tpu_torch.models.factory import create_model

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch_name", default="depthanything-base")
    p.add_argument("--res", type=int, default=392)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8_pallas"])
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer needs a CUDA card")

    model = create_model(args.arch_name, dtype=torch.bfloat16, device="cuda", seed=0,
                         quant=args.quant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.batch, 3, args.res, args.res, generator=gen, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        # host time to enqueue a forward, and what the device still had queued
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue_ms, drain_ms = (t1 - t0) / ITERS * 1e3, (time.perf_counter() - t1) * 1e3

        # CUDA activity only: recording CPU ops too tripled the host time of a
        # forward (26 ms traced span against 9.6 ms untraced, ViT-B bs8 H100)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(ITERS):
                model(x)
            torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out,
                              f"{args.arch_name}_{args.res}_bs{args.batch}_{args.quant}.json")
    prof.export_chrome_trace(trace_path)
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
    kernel_total = sum(by_class.values())
    per_fwd = ITERS * 1e3  # us -> ms per forward
    report = {
        "device": torch.cuda.get_device_name(0),
        "arch": args.arch_name, "res": args.res, "batch": args.batch, "quant": args.quant,
        "host_enqueue_ms_per_forward": enqueue_ms,
        "device_drain_ms_after_enqueue": drain_ms,
        "traced_kernel_ms_per_forward": kernel_total / per_fwd,
        "traced_span_ms_per_forward": span / per_fwd,
        "device_busy_share": busy / span,
        "by_class_ms_per_forward": {k: v / per_fwd for k, v in
                                    sorted(by_class.items(), key=lambda kv: -kv[1])},
        "kernels_per_forward": len(kernels) / ITERS,
        "trace": trace_path,
    }
    print(json.dumps(report, indent=1))
    print(f"top {TOP} kernels by device time (ms per forward, launches per forward):")
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[: TOP]:
        print(f"  {dur / per_fwd:8.4f} ms  {count[name] / ITERS:6.1f}  "
              f"[{classify(name)}] {name[:110]}")
    return report


if __name__ == "__main__":
    main()
