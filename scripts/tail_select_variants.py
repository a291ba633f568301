"""Where the time of kernels 2 and 4 goes, from variants of their sources, on one card.

    python scripts/tail_select_variants.py scripts/tail_select_variants.json

The JSON holds text replacements in the port's ``csrc/``: ``"tail"`` and
``"select"`` name variants of ``dpt_tail.cu`` and ``kth_select.cu`` (``[]``
is the source as it stands; others skip a part, as the products or the fill
of kernel 2, or change a choice), and ``"tail_phases"`` instruments
``dpt_tail.cu`` with ``clock64`` counters: block 0's first fill thread and
first consumer thread add each phase's cycles to a device array that a C
function copies out. Each variant's copy of ``csrc/`` goes to
``build/variants/<name>/`` and is built there (one ``nvcc`` for each, all
started together). Kernel 2 runs its two launches on bs8 inputs at path 4's
C = 256 1036^2 chunk, path 3's C = 128 1036^2 and path 1's C = 128 392^2
(device time of each launch by the profiler; the phases' cycles summed over
block 0's tiles); kernel 4 at [112, 392^2] and [112, 1036^2] rows (dense,
25%-masked, and with ties) by device time, each variant's indices checked
against the plain version. One JSON line per measurement.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.ops import dpt_tail as dt  # noqa: E402
from distill_any_depth_tpu_torch.ops import stats  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
PHASES = ("fill: barrier before the patch", "fill: patch TMA issue", "fill: patch wait",
          "fill: interpolation", "fill: wait for a free halo buffer",
          "fill: whole chunk", "consumers: wait for the halo", "consumers: a chunk's taps",
          "consumers: drain at a tile's end", "consumers: weight-stage waits")


def build(source: str, variants: dict) -> dict:
    procs = {}
    for name, reps in variants.items():
        d = ROOT / "build" / "variants" / re.sub(r"[^a-z0-9]+", "_", f"{source} {name}".lower())
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build._CSRC, d)
        text = (d / source).read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {source} holds {text.count(old)} of {old!r}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(d / "k.so"), str(d / source)]
        procs[name] = d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(d / "k.so"))
    return libs


def device_ms(fn, iters: int = 5) -> dict:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


def tail_libs(libs: dict) -> None:
    for lib in libs.values():
        lib.dad_tail_conv1.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.dad_tail_conv1.restype = I
        lib.dad_tail_head.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        lib.dad_tail_head.restype = I


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    tails = build("dpt_tail.cu", {**spec["tail"], "phases": spec["tail_phases"]})
    selects = build("kth_select.cu", spec["select"])
    tail_libs(tails)
    for lib in selects.values():
        lib.dad_kth_select.argtypes = [P, P, P, I, I, P]
        lib.dad_kth_select.restype = I
    phases = tails.pop("phases")
    phases.dad_dbg_read.argtypes = [P]
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, c, res in (("path 4 C=256 1036^2", 256, 1036), ("path 3 C=128 1036^2", 128, 1036),
                          ("path 1 C=128 392^2", 128, 392)):
        g4, cm = res // 14 * 4, c // 2
        t = torch.randn(8, g4, g4, c, generator=gen, device="cuda").to(torch.bfloat16)
        w = [torch.randn(3, 3, c, cm, generator=gen, device="cuda") * (9 * c) ** -0.5,
             torch.randn(cm, generator=gen, device="cuda") * 0.1,
             torch.randn(3, 3, cm, 32, generator=gen, device="cuda") * (9 * cm) ** -0.5,
             torch.randn(32, generator=gen, device="cuda") * 0.1,
             torch.randn(32, 1, generator=gen, device="cuda") * 32 ** -0.5,
             torch.randn(1, generator=gen, device="cuda") * 0.1]
        prep = dt.prepare_weights(*w, torch.bfloat16)
        v = torch.empty(8, 2 * g4, 2 * g4, cm, dtype=torch.bfloat16, device="cuda")
        out = torch.empty(8, res, res, dtype=torch.bfloat16, device="cuda")
        st = torch.cuda.current_stream().cuda_stream

        def conv1(lib):
            return lib.dad_tail_conv1(t.data_ptr(), prep.w1.data_ptr(), prep.b1.data_ptr(),
                                      v.data_ptr(), 8, g4, g4, c, 0, st)

        def head(lib):
            return lib.dad_tail_head(v.data_ptr(), prep.w2.data_ptr(), prep.b2.data_ptr(),
                                     prep.kd.data_ptr(), prep.bd.data_ptr(), out.data_ptr(), 8,
                                     2 * g4, 2 * g4, cm, res, res, 0, 0, st)

        row = {"kernel": 2, "shape": label}
        for name, lib in tails.items():
            row[name] = {"conv1_ms": sum(device_ms(lambda: conv1(lib)).values()),
                         "head_ms": sum(device_ms(lambda: head(lib)).values())}
        for launch, call in (("conv1", conv1), ("head", head)):
            buf = (ctypes.c_ulonglong * 16)()
            for _ in range(2):  # the second call's counters, after a warm-up
                phases.dad_dbg_zero()
                call(phases)
                torch.cuda.synchronize()
            phases.dad_dbg_read(ctypes.cast(buf, P))
            row[f"{launch} block-0 cycles"] = dict(zip(PHASES, buf[:len(PHASES)]))
        print(json.dumps(row), flush=True)
        del t, v, out
        torch.cuda.empty_cache()

    for n in (392 * 392, 1036 * 1036):
        for kind in ("dense", "masked", "ties"):
            g = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn(112, n, generator=g, device="cuda")
            mask = torch.rand(112, n, generator=g, device="cuda") < (2.0 if kind == "dense" else 0.25)
            if kind == "ties":
                x[0::4] = torch.round(x[0::4] * 4) / 4
                x[1::4] = torch.relu(x[1::4])
            u = stats._order_bits(x, mask)
            k = ((mask.sum(-1) - 1).clamp(min=0) // 2).to(torch.int32)
            ref = stats.kth_select_reference(u, k).to(torch.int32)
            row = {"kernel": 4, "rows": [112, n], "kind": kind}
            for name, lib in selects.items():
                got = torch.empty(112, dtype=torch.int32, device="cuda")

                def call():
                    err = lib.dad_kth_select(u.data_ptr(), k.data_ptr(), got.data_ptr(), 112, n,
                                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")

                ms = sum(v for key, v in device_ms(call, 10).items() if "kth_select" in key)
                call()
                row[name] = {"ms": ms, "equal": bool(torch.equal(got, ref))}
            print(json.dumps(row), flush=True)
            del x, mask, u
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
