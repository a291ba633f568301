"""What the port's CUDA kernels compiled to, and the device time of each
launch of kernels 2 and 4-9 at their main paths' shapes.

    python scripts/kernel_report.py [ROOT] [--libs a,b] [--iters N]

Imports ``distill_any_depth_tpu_torch`` from ROOT (default: this checkout)
and builds the libraries ``--libs`` (default: the masked forwards and
backwards, the W8A8 GEMM, the DPT tail and the select) there. For each
kernel function it prints ptxas's registers, spills and shared memory, its
SASS instruction count (``cuobjdump -sass``) and the count of the opcodes
that say how its products and loads run: ``HGMMA``/``IGMMA`` (warpgroup
MMA), ``HMMA``/``IMMA`` (``mma.sync``), ``LDSM`` (ldmatrix), ``UTMALDG``
(TMA loads), ``SYNCS`` (mbarrier), ``BAR``, ``BRA``, ``MUFU``, ``LDG``,
``LDS``, ``STS``, ``STG``, ``LDGSTS`` (cp.async), ``LDL``/``STL`` (local
memory: spills). Then it traces (CUDA activity only) kernels 5 (with the
window bias) and 7 at the windowed teacher's bs8 (518^2, 1036^2) and the
windowed student's bs16 shapes (the latter with the log-sum-exp, as path 4
runs them), kernel 8 at the windowed student's 1036^2 bs16 shape (also on
separate contiguous q, k, v, and kernel 6 with the window bias on the same
tiles), kernel 6 at its 518^2 bs16 shape with the window bias (from kernel
5's tile marks and terms, as the training path calls it), kernel 9 at the
four ViT-L GEMMs at M = 10960 (518^2 bs8) and 6280 (392^2 bs8), kernel 2
(its two launches) at each path's shape (C = 128 at 392^2, 518^2, 1036^2;
C = 256 at 392^2, 518^2, 1036^2; bs8) and kernel 4 at the HDN loss's
[112, 392^2] and [112, 1036^2] rows, and prints the device time per call of
every kernel each launch starts, by name. One JSON line at the end; run it
on a card, with ``nvcc`` and ``cuobjdump`` on the machine. With ROOT an
unpacked parent tree, the same on the parent's kernels, for a comparison
inside one call.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
p.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
p.add_argument("--libs", default="flash_attention_bias,flash_attention_banded,"
                                 "flash_attention_bias_bwd,flash_attention_banded_bwd,"
                                 "w8a8_matmul,dpt_tail,kth_select")
p.add_argument("--iters", type=int, default=10)
args = p.parse_args()
sys.path.insert(0, args.root)

import torch  # noqa: E402

from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.ops import dpt_tail as dt  # noqa: E402
from distill_any_depth_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distill_any_depth_tpu_torch.ops import stats  # noqa: E402
from distill_any_depth_tpu_torch.ops.quant_matmul import quantize_weight, w8a8_matmul  # noqa: E402
from distill_any_depth_tpu_torch.ops.window import local_window_bias  # noqa: E402

OPCODES = ("HGMMA", "IGMMA", "HMMA", "IMMA", "LDSM", "UTMALDG", "SYNCS", "BAR", "BRA", "MUFU",
           "LDG", "LDS", "STS", "STG", "LDGSTS", "LDL", "STL")
CUDA_BIN = Path("/usr/local/cuda/bin")


def tool(name: str) -> str:
    return shutil.which(name) or str(CUDA_BIN / name)


def demangle(names: list[str]) -> list[str]:
    out = subprocess.run([tool("cu++filt")], input="\n".join(names), capture_output=True,
                         text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def short(name: str) -> str:
    """A demangled kernel name without its argument list."""
    name = name.replace("(anonymous namespace)", "anon")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut]


def ptxas(log: str) -> dict:
    """Function -> its ptxas resource lines."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = []
        elif current and ("registers" in line or "spill" in line or "smem" in line):
            out[current].append(line.split(":", 1)[-1].strip())
    return out


def ptxas_log(name: str) -> str:
    """ptxas's resource report for library ``name``'s source (a cubin built
    aside, for a library that was built before this run)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                              "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
                              f"{tmp}/lib.cubin", str(_build._CSRC / _build.SOURCES[name])],
                             capture_output=True, text=True)
    return out.stdout + out.stderr


def sass(lib: Path) -> dict:
    """Function -> its instruction count and the counts of ``OPCODES``."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and current is not None:
            op = m.group(1)
            current["instructions"] += 1
            if op in OPCODES:
                current[op] += 1
    return {k: dict(v) for k, v in out.items()}


def device_ms(fn, iters: int) -> dict:
    """Device time (ms) per call by kernel name, from a CUDA-only trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return {short(e.key)[:120]: e.self_device_time_total / iters / 1e3 for e in rows}


def bias_forward(q, k, v, bias):
    """Kernel 5 with the log-sum-exp: out, lse, the tile marks and the
    kept terms (None from a tree whose kernel 6 writes its own copy)."""
    r = fa._bias_forward(q, k, v, bias, with_lse=True)
    return (*r, None) if len(r) == 3 else r


def bias_backward(q, k, v, bias, out, lse, go, marks, terms):
    """Kernel 6 as the training path calls it."""
    kept = () if terms is None else (terms,)
    return fa.bias_attention_backward(q, k, v, bias, out, lse, go, marks, *kept)


report = {"root": args.root, "device": torch.cuda.get_device_name(0), "libraries": {}}
names = args.libs.split(",")
logs = _build.build_all(names)
for name in names:
    res = ptxas(logs.get(name) or ptxas_log(name))
    ops = sass(_build._target(name))
    funcs = sorted(set(res) | set(ops))
    lib = {}
    for mangled, pretty in zip(funcs, demangle(funcs)):
        lib[short(pretty)[:160]] = {"ptxas": res.get(mangled, []), "sass": ops.get(mangled, {})}
    report["libraries"][name] = lib
    for fn_name, row in lib.items():
        print(f"[{name}] {fn_name}: {row['ptxas']} {row['sass']}", flush=True)

gen = torch.Generator(device="cuda").manual_seed(0)
bf16, h, d = torch.bfloat16, 12, 64
times = {}
for res, b in ((518, 8), (518, 16), (1036, 8), (1036, 16)):
    g = res // 14
    n = g * g
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(bf16)
    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    with_lse = b == 16  # the training forward writes the log-sum-exp
    if res == 518:
        wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
        times[f"kernel 5, {res}^2 bs{b}"] = device_ms(
            lambda: fa._bias_forward(q, k, v, wb, with_lse), args.iters)
        del wb
    else:
        times[f"kernel 7, {res}^2 bs{b}"] = device_ms(
            lambda: fa._banded_forward(q, k, v, (g, 7), with_lse), args.iters)
    del qkv, q, k, v
for res, b in ((1036, 16), (518, 16)):
    g = res // 14
    n = g * g
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(bf16)
    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    go = torch.randn(b, n, h, d, generator=gen, device="cuda").to(bf16)
    if res == 1036:
        out, lse = fa._banded_forward(q, k, v, (g, 7), with_lse=True)
        times[f"kernel 8, {res}^2 bs{b}"] = device_ms(
            lambda: fa.banded_attention_backward(q, k, v, (g, 7), out, lse, go), args.iters)
        # the same on separate contiguous q, k, v, and kernel 6 with the window
        # bias on the same tiles
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        times[f"kernel 8, {res}^2 bs{b}, contiguous q, k, v"] = device_ms(
            lambda: fa.banded_attention_backward(qc, kc, vc, (g, 7), out, lse, go), args.iters)
        del qc, kc, vc
        wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
        marks, terms = bias_forward(q, k, v, wb)[2:]
        times[f"kernel 6 with the window bias, {res}^2 bs{b}"] = device_ms(
            lambda: bias_backward(q, k, v, wb, out, lse, go, marks, terms), args.iters)
        del wb, marks, terms
    else:
        wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
        out, lse, marks, terms = bias_forward(q, k, v, wb)
        times[f"kernel 6, {res}^2 bs{b}"] = device_ms(
            lambda: bias_backward(q, k, v, wb, out, lse, go, marks, terms), args.iters)
    del qkv, q, k, v, go, out, lse
    torch.cuda.empty_cache()
for m in (10960, 6280):
    for gemm, (k, n) in (("qkv", (1024, 3072)), ("proj", (1024, 1024)), ("fc1", (1024, 4096)),
                         ("fc2", (4096, 1024))):
        x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
        w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
        bias = torch.randn(n, generator=gen, device="cuda")
        qw = quantize_weight(w)
        times[f"kernel 9, M={m} {gemm}"] = device_ms(
            lambda: w8a8_matmul(x, w, bias, quantized=qw), args.iters)
# kernel 2 (its two launches) at the paths' shapes, the weights prepared
# once where the tree has a cache for them; kernel 4 at the HDN rows
for c, res in ((128, 392), (256, 392), (128, 518), (128, 1036), (256, 518), (256, 1036)):
    g4, cm = res // 14 * 4, c // 2
    t = torch.randn(8, g4, g4, c, generator=gen, device="cuda").to(bf16)
    w = dict(k1=torch.randn(3, 3, c, cm, generator=gen, device="cuda") * (9 * c) ** -0.5,
             b1=torch.zeros(cm, device="cuda"),
             k2=torch.randn(3, 3, cm, 32, generator=gen, device="cuda") * (9 * cm) ** -0.5,
             b2=torch.zeros(32, device="cuda"), kd=torch.full((32, 1), 0.1, device="cuda"),
             bd=torch.zeros(1, device="cuda"))
    extra = ({"weights": dt.prepare_weights(*w.values(), bf16)}
             if hasattr(dt, "prepare_weights") else {})
    times[f"kernel 2, C={c} {res}^2 bs8"] = device_ms(
        lambda: dt.fused_dpt_tail(t, (res, res), trailing_relu=False, **w, **extra), args.iters)
    del t
    torch.cuda.empty_cache()
for n in (392 * 392, 1036 * 1036):
    x = torch.randn(112, n, generator=gen, device="cuda")
    mask = torch.rand(112, n, generator=gen, device="cuda") < 0.25
    u = stats._order_bits(x, mask)
    k = (mask.sum(-1) - 1).clamp(min=0) // 2
    times[f"kernel 4, [112, {n}]"] = device_ms(lambda: stats.kth_select(u, k), args.iters)
    del x, mask, u
    torch.cuda.empty_cache()
for label, row in times.items():
    print(f"[time] {label}: {json.dumps(row)}", flush=True)
report["device_ms"] = times
print(json.dumps(report), flush=True)
