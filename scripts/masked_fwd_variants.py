"""Time variants of the bf16 masked attention forward (kernels 5 and 7) on one card.

    python scripts/masked_fwd_variants.py scripts/masked_fwd_variants.json

The JSON names each variant and the text replacements that make it from
the port's ``csrc/``: ``{"name": {"file.cuh": [[old, new], ...]}, ...}``;
``{}`` is the tree as it stands. Each variant's copy of ``csrc/`` goes to
``build/variants/<name>/`` and its two libraries are built there (one
``nvcc`` for each, all started together). Kernel 5 runs with the window
bias at 518^2 (37 x 37 grid, N = 1369) and kernel 7 at 1036^2 (74 x 74,
N = 5476), 12 heads, at the windowed teacher's bs8 and with the lse at the
student's bs16. For each shape the variants are timed by CUDA events (50
calls) in the listed order and again in reverse (A B B A), and each
variant's out and lse are compared bit for bit with the first variant's.
The last line is one JSON object: each reading and their mean by variant
and shape, in ms.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.ops.flash_attention import (  # noqa: E402
    mha_banded_reference, mha_bias_reference)
from distill_any_depth_tpu_torch.ops.window import local_window_bias  # noqa: E402

LIBS = ("flash_attention_bias", "flash_attention_banded")
SHAPES = [("bias", 518, 8, False), ("bias", 518, 16, True),
          ("banded", 1036, 8, False), ("banded", 1036, 16, True)]
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build(variants: dict) -> dict:
    procs = {}
    for name, patches in variants.items():
        d = ROOT / "build" / "variants" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build._CSRC, d)
        for fname, reps in patches.items():
            text = (d / fname).read_text()
            for old, new in reps:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: {fname} holds {text.count(old)} of {old!r}")
                text = text.replace(old, new)
            (d / fname).write_text(text)
        for lib in LIBS:
            cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", str(d / f"{lib}.so"), str(d / f"{lib}.cu")]
            procs[name, lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {lib}: nvcc failed\n{log[-3000:]}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores" not in line]
        print(name, lib, "spills:", spills or "none")
        libs[name, lib] = ctypes.CDLL(str(ROOT / "build" / "variants" / name / f"{lib}.so"))
    return libs


def events_ms(fn, iters=50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    variants = json.loads(Path(sys.argv[1]).read_text())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    libs = build(variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = P(torch.cuda.current_stream().cuda_stream)
    readings = {}
    for kind, res, b, with_lse in SHAPES:
        g, h = res // 14, 12
        n = g * g
        qkv = torch.randn(b, n, 3 * h * 64, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.view(b, n, 3, h, 64).unbind(2)
        out = torch.empty(b, n, h, 64, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(b, h, n, device="cuda") if with_lse else None
        lse_ptr = P(lse.data_ptr() if with_lse else None)
        wb = local_window_bias(g, g, 7, 0, "cuda", torch.bfloat16)
        nt, tn = -(-n // 64), -(-n // 128) * 128
        live = torch.empty(nt * nt, dtype=torch.uint8, device="cuda")
        terms = torch.empty(tn, tn, device="cuda")
        qs = [P(x.data_ptr()) for x in (q, k, v)]
        strides = [L(q.stride(1)), L(q.stride(0))]
        calls = {}
        for name in variants:
            if kind == "bias":
                fn = libs[name, LIBS[0]].dad_bias_attention
                fn.argtypes = [P] * 8 + [I] * 4 + [L] * 2 + [I] * 2 + [ctypes.c_float, P]
                args = [*qs, P(wb.data_ptr()), P(live.data_ptr()), P(terms.data_ptr()),
                        P(out.data_ptr()), lse_ptr, b, n, h, 64, *strides, 0, 0, 0.125, stream]
            else:
                fn = libs[name, LIBS[1]].dad_banded_attention
                fn.argtypes = [P] * 5 + [I] * 4 + [L] * 2 + [I] * 4 + [ctypes.c_float, P]
                args = [*qs, P(out.data_ptr()), lse_ptr, b, n, h, 64, *strides, g, g, 7, 0,
                        0.125, stream]
            calls[name] = (lambda fn=fn, args=args: fn(*args))
        ref = (mha_bias_reference(q[:1], k[:1], v[:1], wb) if kind == "bias"
               else mha_banded_reference(q[:1], k[:1], v[:1], (g, 7))).float()
        first = None
        for name, call in calls.items():
            if call():
                raise SystemExit(f"{name} {kind} {res} bs{b}: launch failed")
            torch.cuda.synchronize()
            got = (out.clone(), lse.clone() if with_lse else None)
            first = first or got
            same = torch.equal(got[0], first[0]) and (not with_lse or torch.equal(got[1], first[1]))
            err = ((got[0][:1].float() - ref).abs() / (1 + ref.abs())).max().item()
            print(f"{name} kernel {5 if kind == 'bias' else 7} {res}^2 bs{b}: "
                  f"same_as_first={same} err_vs_plain={err:.2e}", flush=True)
            if not same:
                raise SystemExit(f"{name} differs from {next(iter(calls))}")
        names = list(calls)
        for name in names + names[::-1]:
            key = f"{name} {kind} {res}^2 bs{b}"
            readings.setdefault(key, []).append(events_ms(calls[name]))
        for name in names:
            key = f"{name} {kind} {res}^2 bs{b}"
            print(f"{key}: {readings[key]} ms", flush=True)
        del qkv, q, k, v, out, lse
    print(json.dumps({key: {"readings": r, "mean": sum(r) / len(r)}
                      for key, r in readings.items()}))


if __name__ == "__main__":
    main()
