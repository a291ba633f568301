"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``, and fails (non-zero exit, no result line) without them.

Phases, each of which fails the run if it fails:

1. build every CUDA kernel from ``distill_any_depth_tpu_torch/csrc``;
2. hold the packed attention kernel against its plain version;
3. hold the DPT-head tail kernel against its plain version;
4. run the main path, ``cli.infer.predict`` with ``depthanything-base`` at
   392^2, bs8, bf16 and seeded random weights, check its output and the
   kernels' launch counts, and hold one image against the port's CPU fp32
   forward of the same weights;
5. time each kernel, its plain version and its PyTorch library yardstick
   with CUDA events, and the end-to-end forward.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from distill_any_depth_tpu_torch.cli.infer import predict  # noqa: E402
from distill_any_depth_tpu_torch.models.factory import create_model  # noqa: E402
from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.ops.dpt_tail import fused_dpt_tail, tail_reference  # noqa: E402
from distill_any_depth_tpu_torch.ops.flash_attention import (  # noqa: E402
    mha_flash_packed,
    mha_packed_reference,
)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

ARCH, RES, BATCH = "depthanything-base", 392, 8

BF16_ATTN_TOL = 6e-3  # max |err| / (1 + |ref|), bf16 kernel 1 against its plain version
# card bf16 against CPU fp32, min-max-normalized depth of one image, over the
# pixels where either depth is positive (the rest are ReLU zeros in both):
# about 3x the readings on an H100 (max 0.0352, mean 0.0062, 1 - corr 0.0012)
E2E_MAX, E2E_MEAN, E2E_CORR = 0.1, 0.02, 0.996


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for bf16 work of ``flops`` moving ``nbytes``, and which bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- phase 1
def phase_build() -> None:
    t0 = time.time()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel libraries built in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2
def attention_case(name, b, n, h, dtype, tol, gen, negative=False):
    c = h * 64
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda", dtype=torch.float32)
    if negative:
        # every real logit of every row below -60: q along +u, keys along -u
        u = torch.full((64,), 0.125, device="cuda")
        qkv[:, :, :c] = 0.01 * qkv[:, :, :c] + (80 * u).repeat(h)
        qkv[:, :, c:2 * c] = 0.01 * qkv[:, :, c:2 * c] - (10 * u).repeat(h)
    qkv = qkv.to(dtype)
    got = mha_flash_packed(qkv, h)
    ref = mha_packed_reference(qkv, h)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite output")
    if negative:
        s = (qkv[:, :, :64].float() @ qkv[:, :, c:c + 64].float().transpose(1, 2)) * 0.125
        log(f"[attention] {name}: max real logit {s.max().item():.1f}")
        check(s.max().item() < -60, f"attention {name}: logits not below -60")
    abs_err, rel_err = errors(got, ref)
    reading = ((got.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()
    ok = reading <= tol
    log(f"[attention] {name}: B={b} N={n} H={h} {str(dtype)[6:]} max_abs_err={abs_err:.3e} "
        f"max_rel_err={rel_err:.3e} max|err|/(1+|ref|)={reading:.3e} tol={tol:g} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"attention {name} outside tolerance")
    return abs_err


def phase_attention(gen) -> float:
    # bf16: P is rounded against the running max (online softmax) where the
    # plain version rounds against the row max, and the output is rounded
    # to bf16 (half an ulp is 2^-9 relative). The limit is 2.3x the largest
    # reading over the bf16 cases on an H100 (0.0026, ragged N).
    err = attention_case("slice shape", 8, 785, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    attention_case("ragged N", 2, 197, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    # fp32: only the summation order differs
    attention_case("fp32", 2, 197, 12, torch.float32, 1e-5, gen)
    attention_case("logits < -60 fp32", 2, 197, 4, torch.float32, 1e-5, gen, negative=True)
    attention_case("logits < -60 bf16", 2, 197, 4, torch.bfloat16, BF16_ATTN_TOL, gen,
                   negative=True)
    return err


# ---------------------------------------------------------------- phase 3
def tail_inputs(b, ht, wt, c, dtype, gen):
    cm = c // 2

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    t = rnd(b, ht, wt, c, scale=1.0).to(dtype)
    weights = dict(
        k1=rnd(3, 3, c, cm, scale=(9 * c) ** -0.5), b1=rnd(cm, scale=0.1),
        k2=rnd(3, 3, cm, 32, scale=(9 * cm) ** -0.5), b2=rnd(32, scale=0.1),
        kd=rnd(32, 1, scale=32 ** -0.5), bd=rnd(1, scale=0.1),
    )
    return t, weights


def tail_case(name, b, ht, wt, c, dtype, out_hw, trailing, tol, gen):
    t, w = tail_inputs(b, ht, wt, c, dtype, gen)
    got = fused_dpt_tail(t, out_hw, trailing_relu=trailing, **w)
    ref = tail_reference(t, out_hw, trailing_relu=trailing, **w)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (b, *out_hw) and got.dtype == dtype, f"tail {name}: bad output")
    check(bool(torch.isfinite(got).all()), f"tail {name}: non-finite output")
    abs_err, rel_err = errors(got, ref)
    ok = rel_err <= tol
    log(f"[tail] {name}: t={list(t.shape)} -> {list(out_hw)} {str(dtype)[6:]} "
        f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
        f"tol=max|err|/max|ref|<={tol:g} {'ok' if ok else 'FAIL'}")
    check(ok, f"tail {name} outside tolerance")
    return abs_err


def phase_tail(gen) -> float:
    # fp32: summation order only. bf16: the plain version rounds the conv2
    # output and the 1x1 head to bf16 where the kernel keeps fp32, and the
    # output is bf16 (2^-8 relative).
    tail_case("fp32 C=128", 1, 112, 112, 128, torch.float32, (RES, RES), True, 1e-5, gen)
    err = tail_case("slice shape", BATCH, 112, 112, 128, torch.bfloat16, (RES, RES), True,
                    2e-2, gen)
    for c in (64, 256):
        tail_case(f"fp32 C={c}", 1, 112, 112, c, torch.float32, (RES, RES), True, 1e-5, gen)
        tail_case(f"bf16 C={c}", 1, 112, 112, c, torch.bfloat16, (RES, RES), True, 2e-2, gen)
    tail_case("teacher tail, ragged", 2, 13, 9, 128, torch.bfloat16, (98, 70), False, 2e-2, gen)
    tail_case("teacher tail, ragged fp32", 2, 13, 9, 128, torch.float32, (98, 70), False,
              1e-5, gen)
    return err


# ---------------------------------------------------------------- phase 4
def synthetic_images(n: int) -> list[np.ndarray]:
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    ims = []
    for _ in range(n):
        f = rng.uniform(0.005, 0.03, size=3)
        base = np.stack([np.sin(f[i] * (xx + rng.uniform(0, 300)) + f[(i + 1) % 3] * yy)
                         for i in range(3)], -1)
        noise = rng.normal(0, 0.1, size=base.shape)
        ims.append(np.clip((base + noise + 1) * 127.5, 0, 255).astype(np.uint8))
    return ims


def phase_main_path(model, images) -> dict:
    mha_flash_packed.launches = 0
    fused_dpt_tail.launches = 0
    t0 = time.time()
    depth = predict(model, images, RES, batch_size=BATCH)
    torch.cuda.synchronize()
    counts = {"attention": mha_flash_packed.launches, "tail": fused_dpt_tail.launches}
    log(f"[main] predict({ARCH}, {len(images)} images, {RES}, bf16) in {time.time() - t0:.2f} s "
        f"(first call); launches {counts}")
    check(depth.shape == (len(images), RES, RES), f"main: depth shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), "main: non-finite depth")
    check(bool((depth >= 0).all()), "main: negative depth")
    forwards = -(-len(images) // BATCH)
    depth_blocks = model.cfg.encoder.depth
    check(counts["attention"] == depth_blocks * forwards,
          f"main: {counts['attention']} attention launches, expected {depth_blocks * forwards}")
    check(counts["tail"] == forwards, f"main: {counts['tail']} tail launches, expected {forwards}")
    log(f"[main] depth: min {depth.min():.4g} max {depth.max():.4g} "
        f"positive share {(depth > 0).mean():.3f}")

    # the same weights in fp32 on the CPU, one image
    cpu = create_model(ARCH, dtype=torch.float32, device="cpu", seed=0)
    ref = predict(cpu, images[:1], RES, batch_size=1)[0]

    def norm(d):
        return (d - d.min()) / (d.max() - d.min() + 1e-8)

    live = (depth[0] > 0) | (ref > 0)
    check(live.mean() > 0.05, f"main: only {live.mean():.3f} of the pixels have depth > 0")
    a, r = norm(depth[0])[live], norm(ref)[live]
    diff = np.abs(a - r)
    corr = float(np.corrcoef(a, r)[0, 1])
    ok = diff.max() <= E2E_MAX and diff.mean() <= E2E_MEAN and corr >= E2E_CORR
    log(f"[main] card bf16 vs CPU fp32, min-max-normalized depth of image 0 over the "
        f"{live.mean():.3f} of pixels where either is positive: max_abs {diff.max():.4f} "
        f"mean_abs {diff.mean():.5f} corr {corr:.5f} (tol max<={E2E_MAX}, mean<={E2E_MEAN}, "
        f"corr>={E2E_CORR}) {'ok' if ok else 'FAIL'}")
    check(ok, "main: card output disagrees with the CPU fp32 forward")
    return counts


# ---------------------------------------------------------------- phase 5
def phase_timing(model, images, counts, errs, gen) -> None:
    # kernel 1 at the main path's shape
    b, n, h, d = BATCH, (RES // 14) ** 2 + 1, 12, 64
    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (x.contiguous() for x in qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
    attn_ms = cuda_ms(lambda: mha_flash_packed(qkv, h), iters=50)
    attn_plain = cuda_ms(lambda: mha_packed_reference(qkv, h))
    attn_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
    attn_bound, attn_by = bound(4.0 * b * h * n * n * d, 4 * b * n * c * 2)

    # kernel 2 at the main path's shape
    t, w = tail_inputs(BATCH, RES // 14 * 4, RES // 14 * 4, 128, torch.bfloat16, gen)
    hu, wu = 2 * t.shape[1], 2 * t.shape[2]
    out_bytes = BATCH * RES * RES * 2
    w_bytes = sum(x.numel() for x in w.values()) * 4
    flops = (2.0 * BATCH * hu * wu * 9 * 128 * 64 + 2.0 * BATCH * RES * RES * 9 * 64 * 32
             + 2.0 * BATCH * RES * RES * 32)
    tail_ms = cuda_ms(lambda: fused_dpt_tail(t, (RES, RES), trailing_relu=True, **w))
    tail_plain = cuda_ms(lambda: tail_reference(t, (RES, RES), trailing_relu=True, **w))
    tail_bound, tail_by = bound(flops, t.numel() * 2 + w_bytes + out_bytes)

    kernels = [
        {"name": "packed_attention_fwd", "route": "cuda",
         "source": "distill_any_depth_tpu_torch/csrc/flash_attention.cu",
         "replaces": "distill_any_depth_tpu/ops/flash_attention.py:537",
         "launches": counts["attention"], "max_abs_err": errs["attention"],
         "ms": attn_ms, "plain_ms": attn_plain, "bound_ms": attn_bound, "bound_by": attn_by,
         "library_ms": attn_lib},
        {"name": "dpt_tail", "route": "cuda",
         "source": "distill_any_depth_tpu_torch/csrc/dpt_tail.cu",
         "replaces": "distill_any_depth_tpu/ops/dpt_tail.py:362",
         "launches": counts["tail"], "max_abs_err": errs["tail"],
         "ms": tail_ms, "plain_ms": tail_plain, "bound_ms": tail_bound, "bound_by": tail_by,
         "library_ms": None},
    ]
    for kd in kernels:
        log(f"[timing] {kd['name']}: kernel {kd['ms']:.4f} ms, plain {kd['plain_ms']:.4f} ms, "
            f"library {kd['library_ms']}, bound {kd['bound_ms']:.4f} ms ({kd['bound_by']}), "
            f"{kd['launches']} launch(es) per forward")

    # end to end: the bs8 forward alone, and predict() with preprocessing
    from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device

    raw = torch.from_numpy(np.stack(images[:BATCH])).cuda()
    x = preprocess_on_device(raw, RES, dtype=model.dtype)
    # the forward is bound by the host's launch overhead, which is noisy:
    # report the median of several windows and the windows themselves
    with torch.no_grad():
        windows = [cuda_ms(lambda: model(x), iters=10) for _ in range(5)]
    fwd_ms = statistics.median(windows)
    t0 = time.perf_counter()
    for _ in range(3):
        predict(model, images[:BATCH], RES, batch_size=BATCH)
    predict_s = (time.perf_counter() - t0) / 3
    e2e = {"arch": ARCH, "res": RES, "batch": BATCH, "dtype": "bfloat16",
           "forward_ms": fwd_ms, "forward_ms_windows": windows,
           "forward_images_per_s": BATCH / fwd_ms * 1e3,
           "predict_images_per_s": BATCH / predict_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"end_to_end": e2e}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a card")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    # fp32 comparisons on the card in full fp32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_build()
    errs = {"attention": phase_attention(gen), "tail": phase_tail(gen)}
    model = create_model(ARCH, dtype=torch.bfloat16, device="cuda", seed=0)
    images = synthetic_images(BATCH)
    counts = phase_main_path(model, images)
    phase_timing(model, images, counts, errs, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
