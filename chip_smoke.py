"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``, and fails (non-zero exit, no result line) without them.

Phases, each of which fails the run if it fails:

1. build every CUDA kernel from ``distill_any_depth_tpu_torch/csrc``;
2. hold the packed attention kernel (kernel 1) and its backward (kernel 3)
   against their plain versions (autograd of the plain attention for the
   backward), across the tile edges (N = 128, 129), and kernel 3 against
   itself: two calls give d(qkv) equal bit for bit;
3. hold the DPT-head tail kernel (kernel 2) against its plain version, at
   every path's shape (C = 128 at 392^2, 518^2 and 1036^2 and at path 6's
   KITTI native 392 x 1358 in bf16 and fp32; C = 256 at 392^2, 518^2 and
   path 4's 1036^2 teacher chunk) and at ragged shapes
   across its tile edges for each C in bf16 and fp32, and in bf16 against
   its own second call, bit for bit;
4. hold the order-statistic select (kernel 4) against its plain version,
   bit for bit, at the HDN loss's [112, 392^2] and [112, 1036^2] rows (ties,
   +-0, an all-masked and an all-valid row, k at both ends, rows whose
   chosen first-digit bin overfills the candidate buffers);
5. hold the biased attention kernel (kernel 5) and the banded window
   attention kernel (kernel 7) against their plain versions, and kernel 7
   against kernel 5 with the window bias bit for bit, at the windowed
   model's shapes, at edge grids and with every logit below -60 (kernel 5
   with the window bias); at the path-3 shapes, each kernel against itself:
   two calls give out and lse equal bit for bit;
6. main path 1: ``cli.infer.predict`` with ``depthanything-base`` at 392^2,
   bs8, bf16 and seeded random weights; check its output and the kernels'
   launch counts, and hold one image against the port's CPU fp32 forward of
   the same weights;
7. main path 2: ``train.loop.Trainer`` with the ViT-L teacher and the ViT-B
   student at bs16 392^2 in bf16 (the default loss stack, NYU shared views,
   teacher in two bs8 chunks) on seeded synthetic images; per step, the
   launch counts of the kernels, finite losses and gradient norm, and
   moved parameters; then two steps of ``cli.train`` over ``data/smoke``,
   saving the student and the train state every step (path 6 reads them);
8. one fp32 step of the same pair at bs2 on the card against the CPU;
9. main path 3: ``cli.infer.predict`` with the windowed teacher
   ``depthanything-base-window`` at 518^2 (kernel 5) and 1036^2 (kernel 7),
   bs8, bf16; launch counts per forward, and one image of each against the
   port's CPU fp32 forward;
10. hold the biased attention backward (kernel 6) and the banded one
   (kernel 8) against their plain versions on the same forward output and
   log-sum-exp, the autograd path (kernels 5 + 6, 7 + 8) against autograd
   of the plain forwards, and kernel 8 against kernel 6 with the window
   bias, at the windowed student's shapes and at edge grids; at the 1036^2
   grid, kernels 6 and 8 against themselves: two calls give d(qkv) equal
   bit for bit;
11. main path 4: ``train.loop.Trainer`` with the windowed student
   ``depthanything-base-window`` and the ViT-L teacher at bs16 bf16, 3
   steps at 518^2 (kernels 5 + 6) and 3 at 1036^2 (kernels 7 + 8): launch
   counts, finite losses and gradient norm, moved parameters, peak memory
   and step time; then two steps of ``cli.train --student_arch
   depthanything-base-window`` over ``data/smoke``;
12. one fp32 step of the windowed student (``depthanything-small``
   teacher) on the card against the CPU: bs2 at 518^2 (kernel 6) and bs1
   at 784^2 (a 56 x 56 grid, kernel 8);
13. hold the W8A8 GEMM (kernel 9) against its plain version, bit for bit:
   bf16 and fp32, with and without bias, at the ViT-L 518^2 bs8, ViT-L
   392^2 bs8 (the int8 teacher) and ViT-B 392^2 bs8 encoder GEMM shapes and
   at edge shapes (M in {1, 100, 129, 257}, N in {200, 264}, K in {96,
   4096}), on rows holding exact rounding ties and all-zero rows;
14. main path 5: ``cli.pseudo_label.label_batches`` with
   ``depthanything-large`` at 518^2, bs8, bf16, ``quant="int8_pallas"``
   over 10 images (the second batch padded): launch counts per forward,
   one image against the port's CPU fp32 forward with the same weights and
   quant, the depth against the card's own unquantized forward; then
   ``cli.pseudo_label.main`` over a folder of 10 PNGs;
15. main path 2 with the int8 teacher (``teacher_quant="int8_pallas"``):
   3 ``Trainer`` steps at bs16 392^2 with kernel 9's launches per step,
   then two steps of ``cli.train --teacher_quant int8_pallas``;
16. time each kernel, its plain version and its PyTorch library yardstick
   with CUDA events (kernels 1, 3, 5 and 7 and their SDPA yardsticks also
   by the profiler's device time, with the SDPA backend's kernel names;
   kernel 2 by events and device time at each path's shape, kernel 4 at
   [112, 392^2] and [112, 1036^2] beside ``torch.kthvalue``;
   kernels 5 and 7 also at path 4's bs16 with the log-sum-exp; kernels 5-9
   also by the device time of each kernel a call starts; kernel 9 also
   beside bf16 ``F.linear``), the
   end-to-end forwards (the ViT-L 518^2 forward with each quant mode) and
   the bs16 train steps (bf16 and int8 teacher); kernel 2 also at path 6's
   KITTI native shape;
17. path 6, checkpoints and evaluation (run between phases 15 and 16):
   phase 7's ``student_final`` read back through the port's own
   safetensors reader and held bit for bit against the saved fp32
   parameters; ``cli.infer --checkpoint`` with it over ``data/smoke/imgs``;
   the train state restored into phase 7's trainer (parameters, Adam
   moments and counts bit for bit, on the card); ``cli.train --resume`` for
   steps 3 and 4 (launches per step, finite losses; bit-exact continuation
   is a CPU test, since cuDNN's backward may pick non-deterministic
   algorithms here); path 5's seeded ViT-L saved with ``save_safetensors``,
   renamed by ``cli.convert`` and loaded as a ``Trainer``'s teacher
   (parameters and a bs8 392^2 forward bit for bit); ``cli.evaluate`` with
   ``student_final`` over 64 synthetic NYU pairs at 392^2 bs8 in fp32 and
   bf16, and over 16 synthetic KITTI pairs at their native resolution (KB
   crop, eigen mask; kernel 1 at N = 2717 and kernel 2 at 392 x 1358, the
   prediction upsampled to 352 x 1216): kernels 1 and 2 per batch, finite
   metrics, the report files, images/s with the decode, and the metrics of
   2 images against the port's CPU fp32 ``evaluate_model`` of the same
   weights; save and load times.

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
from distill_any_depth_tpu_torch.cli.profile_infer import cuda_ms  # noqa: E402
from distill_any_depth_tpu_torch.configs import (  # noqa: E402
    LossConfig,
    TrainConfig,
    model_config,
)
from distill_any_depth_tpu_torch.data.transforms import Resize  # noqa: E402
from distill_any_depth_tpu_torch.models.factory import create_model  # noqa: E402
from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.ops.dpt_tail import (  # noqa: E402
    fused_dpt_tail,
    prepare_weights,
    tail_reference,
)
from distill_any_depth_tpu_torch.ops.flash_attention import (  # noqa: E402
    _banded_forward,
    _bias_forward,
    _forward,
    banded_attention_backward,
    banded_attention_backward_reference,
    banded_eligible,
    bias_attention_backward,
    bias_attention_backward_reference,
    mha_banded_reference,
    mha_bias_reference,
    mha_flash_banded,
    mha_flash_bias,
    mha_flash_packed,
    mha_flash_qkv,
    mha_packed_reference,
    packed_attention_backward,
)
from distill_any_depth_tpu_torch.ops.quant import (  # noqa: E402
    int8_matmul,
    quantize_rows,
    quantize_weight,
)
from distill_any_depth_tpu_torch.ops.quant_matmul import w8a8_matmul, w8a8_reference  # noqa: E402
from distill_any_depth_tpu_torch.ops.stats import (  # noqa: E402
    _order_bits,
    kth_select,
    kth_select_reference,
)
from distill_any_depth_tpu_torch.ops.window import local_window_bias, segment_bias  # noqa: E402
from distill_any_depth_tpu_torch.train.loop import Trainer  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

ARCH, RES, BATCH = "depthanything-base", 392, 8
TEACHER, TRAIN_BATCH, TRAIN_STEPS = "depthanything-large", 16, 3
WINDOW_ARCH, WINDOW_RES = "depthanything-base-window", (518, 1036)  # kernel 5, kernel 7
WINDOW_TRAIN_BATCH = {518: 16, 1036: 16}  # main path 4: kernels 5 + 6, kernels 7 + 8
HDN_ROWS = 7 * TRAIN_BATCH  # the dr/3 HDN contexts folded with the batch
# main path 5: ViT-L pseudo-labelling at 518^2 bs8 with int8 encoder GEMMs
QUANT_ARCH, QUANT_RES, QUANT_BATCH, QUANT_IMAGES = "depthanything-large", 518, 8, 10
# kernel 9's shapes: (M, the (K, N) of qkv, proj, fc1, fc2) of each encoder
VIT_L_GEMMS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
W8A8_SHAPES = {
    "ViT-L 518^2 bs8": (8 * ((518 // 14) ** 2 + 1), VIT_L_GEMMS),
    # the int8 teacher's bs8 chunks of the 392^2 distillation step
    "ViT-L 392^2 bs8": (8 * ((392 // 14) ** 2 + 1), VIT_L_GEMMS),
    "ViT-B 392^2 bs8": (8 * ((392 // 14) ** 2 + 1), ((768, 2304), (768, 768), (768, 3072),
                                                     (3072, 768))),
}
GEMMS = ("qkv", "proj", "fc1", "fc2")
# path 6: evaluation on NYU (64 480x640 pairs, the real test set has 654) and
# on KITTI at its native resolution (16 375x1242 pairs): the KB crop 352x1216
# goes in keeping its aspect, 392 high and a multiple of 14 wide
NYU_EVAL_IMAGES, KITTI_EVAL_IMAGES, EVAL_BATCH = 64, 16, 8
KITTI_RAW_HW, KITTI_CROP_HW = (375, 1242), (352, 1216)
KITTI_IN_HW = Resize(RES, RES, ensure_multiple_of=14,
                     keep_aspect_ratio=True).get_size(*KITTI_CROP_HW[::-1])[::-1]
# kernel 2's shapes on the paths: (label, batch, C, output size, trailing
# ReLU); t is [batch, oh/14*4, ow/14*4, C] (oh = ow for a single number)
TAIL_SHAPES = (("path 1 ViT-B 392^2", BATCH, 128, RES, True),
               ("path 2 ViT-L teacher 392^2", 8, 256, RES, False),
               ("path 3 518^2", BATCH, 128, 518, False),
               ("path 3 1036^2", BATCH, 128, 1036, False),
               ("path 5 ViT-L 518^2", 8, 256, 518, False),
               ("path 4 ViT-L teacher 1036^2", 8, 256, 1036, False),
               ("path 6 ViT-B KITTI native", BATCH, 128, KITTI_IN_HW, True))

BF16_ATTN_TOL = 6e-3  # max |err| / (1 + |ref|), bf16 kernel 1 against its plain version
# max |err| / (1 + |ref|), bf16 kernels 1 + 3 against autograd of the plain
# version: about 3x the readings on an H100 (7.7e-3 slice shape, 6.3e-3 N = 197)
BF16_GRAD_TOL = 2.5e-2
# relative L2 of the whole d(qkv), bf16 kernels 1 + 3 with every logit
# below -60: about 3x the reading on an H100 (9.95e-3)
BF16_NEG_GRAD_L2_TOL = 3e-2
# fp32 step of the ViT-L -> ViT-B pair at bs2, card against CPU: relative
# errors of the loss components and the gradient norm, the relative L2 error
# of the whole (clipped) gradient, and the parameters after the first Adam
# update in units of lr. About 3x the readings on an H100 (components
# <= 1.4e-7, grad norm 6.7e-5, gradient 3.4e-4, mean param 2.5e-4 lr), except
# the max param difference: Adam's first update is about +-lr per element,
# so an element whose gradient is near zero may flip it, a difference of 2 lr.
FP32_STEP_TOL = {"sc rel": 5e-7, "lg rel": 5e-7, "feat rel": 5e-7, "grad rel": 5e-7,
                 "hdn rel": 5e-7, "total rel": 5e-7, "grad_norm rel": 2e-4,
                 "grad rel L2": 1e-3, "param mean |diff|/lr": 1e-3, "param max |diff|/lr": 2.01}
OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"  # run outputs (gitignored)
# card bf16 against CPU fp32, min-max-normalized depth of one image, over the
# pixels where either depth is positive (the rest are ReLU zeros in both):
# about 3x the readings on an H100 (max 0.0352, mean 0.0062, 1 - corr 0.0012)
E2E_MAX, E2E_MEAN, E2E_CORR = 0.1, 0.02, 0.996
# the same for the windowed teacher at 518^2 and 1036^2: about 3x the readings
# on an H100 (max 0.0132 / 0.0138, mean 0.00232 / 0.00227, 1 - corr 1.0e-4 /
# 1.2e-4)
WINDOW_E2E_MAX, WINDOW_E2E_MEAN, WINDOW_E2E_CORR = 0.04, 0.007, 0.9996
# path 5, the same with int8_pallas GEMMs on both sides (the CPU runs kernel
# 9's plain version) at ViT-L 518^2: about 3x the readings on an H100 (max
# 0.0136, mean 0.00291, 1 - corr 7e-5)
QUANT_E2E_MAX, QUANT_E2E_MEAN, QUANT_E2E_CORR = 0.04, 0.009, 0.9998
# path 5's int8 depth against the card's own unquantized bf16 depth, all
# pixels of the 10 images: the JAX package's bound for int8 against fp32
QUANT_VS_PLAIN_CORR = 0.99
# max |err| / (1 + |ref|) of dq, dk, dv, kernels 6 and 8 against their plain
# versions on the same out and lse: bf16 differs by the flips of roundings
# placed alike, fp32 by summation order. About 3x the readings on an H100
# (bf16 3.9e-3; fp32 6.6e-7, and 1.24e-6 with every logit below -60; bf16
# below -60 3.3e-5 in relative L2, where a zero output reads 1)
BF16_MASKED_GRAD_TOL, FP32_MASKED_GRAD_TOL = 1.2e-2, 2e-6
FP32_NEG_MASKED_GRAD_TOL, BF16_NEG_MASKED_GRAD_L2_TOL = 4e-6, 1e-4
# the autograd path (kernels 5 + 6, 7 + 8) against autograd of the plain
# forward, fp32: about 3x the readings (7.4e-7, 1.2e-6); bf16 is held at
# kernel 3's BF16_GRAD_TOL (readings 9.2e-3, 1.44e-2)
FP32_MASKED_AUTOGRAD_TOL = 4e-6
# fp32 step of the windowed student, card against CPU, as FP32_STEP_TOL, with
# the relative L2 error of the blocks' qkv weight gradients (what kernels 6
# and 8 feed) beside the whole gradient's: about 3x the readings on an H100
# at 518^2 / 784^2 (components <= 2.3e-7, grad norm 3.4e-5 / 2.9e-5,
# gradient 1.9e-4 / 9.1e-5, qkv gradient 2.2e-4 / 9.2e-5, mean param 1.5e-5
# / 8.9e-6 lr), and the max param difference as FP32_STEP_TOL
WINDOW_FP32_STEP_TOL = {"sc rel": 7e-7, "lg rel": 7e-7, "feat rel": 7e-7, "grad rel": 7e-7,
                        "total rel": 7e-7, "grad_norm rel": 1e-4, "grad rel L2": 6e-4,
                        "qkv grad rel L2": 7e-4, "param mean |diff|/lr": 5e-5,
                        "param max |diff|/lr": 2.01}


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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


def bound(flops: float, nbytes: float, rate: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time (ms) for work of ``flops`` at peak ``rate`` (bf16 by
    default) moving ``nbytes``, and which bounds it."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tail_work(b: int, gh: int, gw: int, c: int, oh: int, ow: int) -> tuple[float, float]:
    """Kernel 2's operations and bytes (t read once, the weights, the depth
    written once) for t [b, gh, gw, c] -> [b, oh, ow] in bf16."""
    cm = c // 2
    flops = (2.0 * b * (2 * gh) * (2 * gw) * 9 * c * cm + 2.0 * b * oh * ow * 9 * cm * 32
             + 2.0 * b * oh * ow * 32)
    weights = (9 * c * cm + cm + 9 * cm * 32 + 32 + 32 + 1) * 4
    return flops, b * gh * gw * c * 2 + weights + b * oh * ow * 2


def device_ms(fn, iters: int = 20) -> tuple[float, list[str]]:
    """Device time (ms) per call of ``fn`` from the profiler's CUDA trace
    (the sum of the self times of the kernels and memsets it launched, over
    ``iters`` calls), and their names: the host's enqueue time, which event
    times of back-to-back calls include where the host sets the pace, is
    left out."""
    split = device_split(fn, iters)
    return sum(split.values()), sorted(split)


def device_split(fn, iters: int = 20) -> dict:
    """Device time (ms) per call of ``fn`` by kernel name, from the
    profiler's CUDA trace over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


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
def attention_inputs(b, n, h, dtype, gen, negative=False):
    c = h * 64
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda", dtype=torch.float32)
    if negative:
        # every real logit of every row below -60: q along +u, keys along -u
        u = torch.full((64,), 0.125, device="cuda")
        qkv[:, :, :c] = 0.01 * qkv[:, :, :c] + (80 * u).repeat(h)
        qkv[:, :, c:2 * c] = 0.01 * qkv[:, :, c:2 * c] - (10 * u).repeat(h)
        s = (qkv[:, :, :64] @ qkv[:, :, c:c + 64].transpose(1, 2)) * 0.125
        check(s.max().item() < -60, f"attention inputs: max real logit {s.max().item():.1f}")
    return qkv.to(dtype)


def reading_of(got, ref) -> float:
    """max |err| / (1 + |ref|)"""
    return ((got.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()


def attention_case(name, b, n, h, dtype, tol, gen, negative=False):
    qkv = attention_inputs(b, n, h, dtype, gen, negative)
    got = mha_flash_packed(qkv, h)
    ref = mha_packed_reference(qkv, h)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite output")
    abs_err, rel_err = errors(got, ref)
    reading = reading_of(got, ref)
    ok = reading <= tol
    log(f"[attention] {name}: B={b} N={n} H={h} {str(dtype)[6:]} max_abs_err={abs_err:.3e} "
        f"max_rel_err={rel_err:.3e} max|err|/(1+|ref|)={reading:.3e} tol={tol:g} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"attention {name} outside tolerance")
    return abs_err


def attention_grad_case(name, b, n, h, dtype, tol, gen, negative=False, l2_tol=None):
    """d(qkv) through ``mha_flash_packed`` (kernels 1 + 3) against autograd
    of the plain version, on the same inputs and output cotangent: max
    |err| / (1 + |ref|) within ``tol``, or, with ``l2_tol``, the relative
    L2 error of the whole d(qkv) within it."""
    qkv = attention_inputs(b, n, h, dtype, gen, negative)
    g = torch.randn(b, n, h * 64, generator=gen, device="cuda").to(dtype)
    x = qkv.clone().requires_grad_()
    before = packed_attention_backward.launches
    mha_flash_packed(x, h).backward(g)
    check(packed_attention_backward.launches == before + 1,
          f"attention grad {name}: the backward kernel did not run")
    xr = qkv.clone().requires_grad_()
    mha_packed_reference(xr, h).backward(g)
    torch.cuda.synchronize()
    got, ref = x.grad, xr.grad
    check(got.dtype == dtype and got.shape == qkv.shape, f"attention grad {name}: bad output")
    check(bool(torch.isfinite(got).all()), f"attention grad {name}: non-finite d(qkv)")
    abs_err, rel_err = errors(got, ref)
    reading = reading_of(got, ref)
    l2 = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
    ok = l2 <= l2_tol if l2_tol is not None else reading <= tol
    limit = f"rel L2 tol={l2_tol:g}" if l2_tol is not None else f"tol={tol:g}"
    log(f"[attention grad] {name}: B={b} N={n} H={h} {str(dtype)[6:]} "
        f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} max|err|/(1+|ref|)={reading:.3e} "
        f"rel L2={l2:.3e} {limit} {'ok' if ok else 'FAIL'}")
    check(ok, f"attention grad {name} outside tolerance")
    return abs_err


def phase_attention(gen) -> float:
    # bf16: P is rounded against the running max (online softmax) where the
    # plain version rounds against the row max, and the output is rounded
    # to bf16 (half an ulp is 2^-9 relative). The limit is 2.3x the largest
    # reading over the bf16 cases on an H100 (0.0026, ragged N).
    err = attention_case("slice shape", 8, 785, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    attention_case("teacher shape", 8, 785, 16, torch.bfloat16, BF16_ATTN_TOL, gen)
    attention_case("ragged N", 2, 197, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    # the bf16 forward's 128-row q tiles and 128-key stages: one full tile,
    # and one more row and key
    attention_case("N = 128", 2, 128, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    attention_case("N = 129", 2, 129, 12, torch.bfloat16, BF16_ATTN_TOL, gen)
    # fp32: only the summation order differs
    attention_case("fp32", 2, 197, 12, torch.float32, 1e-5, gen)
    # path 6's shapes: NYU 392^2 in fp32 (bf16 is the slice shape above) and
    # KITTI at its native grid (a ragged last q tile) in both dtypes
    attention_case("path 6 NYU fp32", EVAL_BATCH, 785, 12, torch.float32, 1e-5, gen)
    kn = 1 + (KITTI_IN_HW[0] // 14) * (KITTI_IN_HW[1] // 14)
    attention_case("path 6 KITTI native fp32", EVAL_BATCH, kn, 12, torch.float32, 1e-5, gen)
    attention_case("path 6 KITTI native bf16", EVAL_BATCH, kn, 12, torch.bfloat16,
                   BF16_ATTN_TOL, gen)
    attention_case("logits < -60 fp32", 2, 197, 4, torch.float32, 1e-5, gen, negative=True)
    attention_case("logits < -60 bf16", 2, 197, 4, torch.bfloat16, BF16_ATTN_TOL, gen,
                   negative=True)
    return err


def attention_determinism(gen) -> None:
    """Kernel 3 writes every gradient once, without atomics: two calls on the
    same inputs at the student's training shape give d(qkv) equal bit for
    bit."""
    b, n, h = TRAIN_BATCH, 785, 12
    qkv = attention_inputs(b, n, h, torch.bfloat16, gen)
    g = torch.randn(b, n, h * 64, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = _forward(qkv, h, with_lse=True)
    first = packed_attention_backward(qkv, out, lse, g, h)
    same = torch.equal(first, packed_attention_backward(qkv, out, lse, g, h))
    log(f"[attention grad] determinism: B={b} N={n} H={h} bf16, two calls bit-equal: {same}")
    check(same, "attention backward: two calls on the same inputs differ")


def phase_attention_grad(gen) -> float:
    # bf16: P and T = P (dP - delta) are rounded to bf16 before their
    # products in the kernel; autograd of the plain version rounds at other
    # places (the forward's exp, the cast of its output), and the kernel's
    # delta comes from the bf16 output.
    err = attention_grad_case("slice shape", TRAIN_BATCH, 785, 12, torch.bfloat16,
                              BF16_GRAD_TOL, gen)
    attention_grad_case("ragged N", 2, 197, 12, torch.bfloat16, BF16_GRAD_TOL, gen)
    attention_grad_case("N = 128", 2, 128, 12, torch.bfloat16, BF16_GRAD_TOL, gen)
    attention_grad_case("N = 129", 2, 129, 12, torch.bfloat16, BF16_GRAD_TOL, gen)
    attention_determinism(gen)
    # fp32: summation order only (readings 5.7e-7, and 7.0e-6 below -60)
    attention_grad_case("fp32", 2, 197, 12, torch.float32, 1e-5, gen)
    attention_grad_case("logits < -60 fp32", 2, 197, 4, torch.float32, 2e-5, gen,
                        negative=True)
    # bf16 below -60: d(qkv) must be finite and agree in relative L2. dQ
    # there is a sum over near-equal keys of T = P (dP - delta), which nearly
    # cancels, so the bf16 rounding of T (kernel) and of the forward (plain)
    # dominate its elementwise error (max |err| / (1 + |ref|) read 8.5e-2);
    # over the whole of d(qkv), which dV dominates, a zero or wrong output
    # reads about 1.
    attention_grad_case("logits < -60 bf16", 2, 197, 4, torch.bfloat16, None, gen,
                        negative=True, l2_tol=BF16_NEG_GRAD_L2_TOL)
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


def tail_case(name, b, ht, wt, c, dtype, out_hw, trailing, tol, gen, twice=False):
    """Kernel 2 against its plain version (and, with ``twice``, against its own
    second call, bit for bit); returns the max abs error."""
    t, w = tail_inputs(b, ht, wt, c, dtype, gen)
    got = fused_dpt_tail(t, out_hw, trailing_relu=trailing, **w)
    ref = tail_reference(t, out_hw, trailing_relu=trailing, **w)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (b, *out_hw) and got.dtype == dtype, f"tail {name}: bad output")
    check(bool(torch.isfinite(got).all()), f"tail {name}: non-finite output")
    abs_err, rel_err = errors(got, ref)
    ok = rel_err <= tol
    same = ""
    if twice:
        equal = bool(torch.equal(got, fused_dpt_tail(t, out_hw, trailing_relu=trailing, **w)))
        same = f" second call bit-equal={equal}"
        ok = ok and equal
    log(f"[tail] {name}: t={list(t.shape)} -> {list(out_hw)} {str(dtype)[6:]} "
        f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
        f"tol=max|err|/max|ref|<={tol:g}{same} {'ok' if ok else 'FAIL'}")
    check(ok, f"tail {name} outside tolerance or not deterministic")
    return abs_err


# Ragged shapes across the bf16 kernel's tile edges (64 output columns, 4
# or 8 output rows a tile; a source patch of up to 5-8 rows and 35-40
# columns behind each tile): (b, ht, wt, (oh, ow)) for each C
TAIL_RAGGED = [(1, 1, 1, (14, 14)), (2, 1, 9, (15, 65)), (2, 9, 1, (63, 14)),
               (1, 33, 32, (129, 70)), (2, 37, 33, (131, 200))]


def phase_tail(gen) -> float:
    # fp32: summation order only. bf16: the plain version rounds the conv2
    # output and the 1x1 head to bf16 where the kernel keeps fp32, and the
    # output is bf16 (2^-8 relative).
    tail_case("fp32 C=128", 1, 112, 112, 128, torch.float32, (RES, RES), True, 1e-5, gen)
    err = tail_case("slice shape", BATCH, 112, 112, 128, torch.bfloat16, (RES, RES), True,
                    2e-2, gen, twice=True)
    for c in (64, 256):
        tail_case(f"fp32 C={c}", 1, 112, 112, c, torch.float32, (RES, RES), True, 1e-5, gen)
        tail_case(f"bf16 C={c}", 1, 112, 112, c, torch.bfloat16, (RES, RES), True, 2e-2, gen)
    # the ViT-L teacher's tail in the train step: bs8 chunks, no trailing ReLU
    tail_case("teacher tail", 8, 112, 112, 256, torch.bfloat16, (RES, RES), False, 2e-2, gen)
    tail_case("teacher tail, ragged", 2, 13, 9, 128, torch.bfloat16, (98, 70), False, 2e-2, gen)
    tail_case("teacher tail, ragged fp32", 2, 13, 9, 128, torch.float32, (98, 70), False,
              1e-5, gen)
    # the windowed teacher's tails: odd 37-patch grid at 518^2, 74 at 1036^2
    for res in WINDOW_RES:
        g4 = res // 14 * 4
        tail_case(f"window {res} tail", BATCH, g4, g4, 128, torch.bfloat16, (res, res), False,
                  2e-2, gen)
    # path 6's ViT-B tail at KITTI's native 392 x 1358 (t 112 x 388)
    kh, kw = KITTI_IN_HW
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        tail_case(f"KITTI native {str(dtype)[6:]}", BATCH, kh // 14 * 4, kw // 14 * 4, 128, dtype,
                  (kh, kw), True, tol, gen, twice=True)
    # path 5's ViT-L tail at 518^2 and path 4's teacher chunk at 1036^2 (C = 256)
    for res in WINDOW_RES:
        g4 = res // 14 * 4
        tail_case(f"ViT-L {res} tail", 8, g4, g4, 256, torch.bfloat16, (res, res), False, 2e-2,
                  gen, twice=True)
    # no trailing ReLU here: where it clips most of a small output, max |ref|
    # is tiny and the relative error of any bf16 chain (the plain version's
    # own, against fp32) passes 2e-2
    for c in (64, 128, 256):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            for b, ht, wt, hw in TAIL_RAGGED:
                tail_case(f"ragged C={c}", b, ht, wt, c, dtype, hw, False, tol, gen,
                          twice=dtype == torch.bfloat16)
    return err


# ---------------------------------------------------------------- phase 4
def select_inputs(gen, n=RES * RES):
    """Order bits ``[112, n]`` as the HDN loss's SSI medians see them, with
    ties, +-0, ReLU zeros, a 25%-valid mask, an all-masked and an all-valid
    row, k at the median and at both ends of the valid entries, and two rows
    whose median's first-digit bin overfills the kernel's candidate buffers
    with distinct values (uniform in [1, 1.25), all valid; the second with k
    at its end)."""
    r = HDN_ROWS
    x = torch.randn(r, n, generator=gen, device="cuda")
    x[0::4] = torch.round(x[0::4] * 4) / 4  # heavy ties
    x[1::4] = torch.relu(x[1::4])  # ReLU zeros
    x[2, : n // 2] = -0.0
    x[2, n // 2:] = 0.0
    x[8:10] = 1.0 + 0.25 * torch.rand(2, n, generator=gen, device="cuda")
    mask = torch.rand(r, n, generator=gen, device="cuda") < 0.25
    mask[3] = False
    mask[4:10] = True
    u = _order_bits(x, mask)
    count = mask.sum(dim=-1)
    k = (count - 1).clamp(min=0) // 2
    k[5], k[6], k[7], k[9] = 0, count[6] - 1, n - 1, n - 1
    return u, k


def phase_select(gen) -> int:
    """Kernel 4 bit for bit against its plain version at the HDN loss's
    392^2 rows (each block's slice whole in shared memory) and 1036^2 rows
    (a third of it: the later sweeps also read device memory); returns the
    largest difference of a selected index from the plain version's."""
    worst = 0
    for n in (RES * RES, WINDOW_RES[1] ** 2):
        u, k = select_inputs(gen, n)
        ref = kth_select_reference(u, k)
        got = kth_select(u, k)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, ref))
        err = int((got.long() - ref.long()).abs().max())
        worst = max(worst, err)
        log(f"[select] u={list(u.shape)} int32 order bits: {int((got != ref).sum())} of "
            f"{u.shape[0]} rows differ from the plain version, by up to {err} positions "
            f"(exact equality required) {'ok' if same else 'FAIL'}")
        check(same, "select kernel disagrees with its plain version")
        del u, k, ref, got
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------- phase 5
def masked_inputs(b, n, h, dtype, gen, negative=False):
    """q, k, v ``[B, N, H, 64]`` viewed in place in one packed qkv, as the
    encoder hands them to the biased and banded kernels (every logit below
    -60 if asked)."""
    return attention_inputs(b, n, h, dtype, gen, negative).view(b, n, 3, h, 64).unbind(2)


def held(name, got, refs: dict, tol, exact=(), l2_tol=None, tag="masked attention") -> float:
    """Check ``got`` (a tensor, or a tuple such as (dq, dk, dv)) against
    each reference of the same form: max |err| / (1 + |ref|) within ``tol``
    (or, with ``l2_tol``, the relative L2 error of all its tensors within
    it), and equal to those named in ``exact``; returns the max abs error
    against the first (the plain version)."""
    torch.cuda.synchronize()

    def parts(x):
        return tuple(x) if isinstance(x, (tuple, list)) else (x,)

    got, refs = parts(got), {k: parts(v) for k, v in refs.items()}
    first = next(iter(refs.values()))
    for a, b in zip(got, first):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{name}: bad output")
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
    readings, l2 = {}, {}
    for label, ref in refs.items():
        if label in exact:
            continue
        readings[label] = max(reading_of(a, b) for a, b in zip(got, ref))
        if l2_tol is not None:
            diff = sum(((a.float() - b.float()) ** 2).sum() for a, b in zip(got, ref))
            l2[label] = (diff / sum((b.float() ** 2).sum() for b in ref)).sqrt().item()
    same = all(torch.equal(a, b) for x in exact for a, b in zip(got, refs[x]))
    if l2_tol is None:
        ok, limit = same and all(r <= tol for r in readings.values()), f"tol={tol:g}"
    else:
        ok, limit = same and all(v <= l2_tol for v in l2.values()), f"rel L2 tol={l2_tol:g}"
    abs_err = max(errors(a, b)[0] for a, b in zip(got, first))
    log(f"[{tag}] {name}: max_abs_err={abs_err:.3e} max|err|/(1+|ref|) "
        + " ".join(f"vs {k}={v:.3e}" for k, v in readings.items())
        + "".join(f" rel L2 vs {k}={v:.3e}" for k, v in l2.items())
        + f" {limit}" + "".join(f", {k} exactly" for k in exact) + f" {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} outside tolerance")
    return abs_err


def bias_case(name, b, n, h, dtype, bias, tol, gen, negative=False) -> float:
    q, k, v = masked_inputs(b, n, h, dtype, gen, negative)
    before = mha_flash_bias.launches
    got = mha_flash_bias(q, k, v, bias)
    check(mha_flash_bias.launches == before + 1, f"bias {name}: the kernel did not run")
    btype = "none" if bias is None else str(bias.dtype)[6:]
    return held(f"bias {name}: B={b} N={n} H={h} {str(dtype)[6:]} bias {btype}", got,
                {"plain": mha_bias_reference(q, k, v, bias)}, tol)


def banded_case(name, b, gh, gw, window, h, dtype, tol, gen, dense_plain=False,
                negative=False) -> float:
    """Kernel 7 against its plain version, and kernel 5 with the window bias
    bit for bit (the two visit the same live tiles with the same arithmetic);
    if asked, against the dense plain version with that bias too."""
    q, k, v = masked_inputs(b, gh * gw, h, dtype, gen, negative)
    before = mha_flash_banded.launches
    got = mha_flash_banded(q, k, v, (gw, window))
    check(mha_flash_banded.launches == before + 1, f"banded {name}: the kernel did not run")
    wb = local_window_bias(gh, gw, window, 0, "cuda", dtype)
    refs = {"plain": mha_banded_reference(q, k, v, (gw, window)),
            "kernel 5": mha_flash_bias(q, k, v, wb)}
    if dense_plain:
        refs["dense plain"] = mha_bias_reference(q, k, v, wb)
    return held(f"banded {name}: B={b} grid {gh}x{gw} window {window} H={h} "
                f"{str(dtype)[6:]}", got, refs, tol, exact=("kernel 5",))


def phase_window_attention(gen) -> tuple[float, float]:
    """Kernels 5 and 7; returns their max abs errors at the slice shapes.
    Limits as kernel 1's: bf16 P is rounded against the running max where the
    plain version of kernel 5 rounds against the row max; fp32 differs by
    summation order only."""
    bf16, f32 = torch.bfloat16, torch.float32
    g = WINDOW_RES[0] // 14  # 37: N = 1369, not a multiple of 64
    n = g * g
    err5 = bias_case("slice shape, window", BATCH, n, 12, bf16,
                     local_window_bias(g, g, 7, 0, "cuda", bf16), BF16_ATTN_TOL, gen)
    bias_case("window", 2, n, 12, f32, local_window_bias(g, g, 7, 0, "cuda", f32), 1e-5, gen)
    rb = torch.randn(n, n, generator=gen, device="cuda")
    bias_case("random", 2, n, 12, bf16, rb.to(bf16), BF16_ATTN_TOL, gen)
    bias_case("random", 2, n, 12, f32, rb, 1e-5, gen)
    ids = torch.repeat_interleave(torch.arange(5), torch.tensor([300, 1, 500, 68, 500]))
    sb = segment_bias(ids).cuda()  # a 1-token segment: one live key in its row
    bias_case("segment", 2, n, 12, bf16, sb.to(bf16), BF16_ATTN_TOL, gen)
    bias_case("segment", 2, n, 12, f32, sb, 1e-5, gen)
    # a cls-prefixed 14x14 window (N = 197) and no bias at all
    bias_case("window + prefix", 2, 197, 12, bf16,
              local_window_bias(14, 14, 7, 1, "cuda", f32), BF16_ATTN_TOL, gen)
    bias_case("no bias", 2, 197, 12, f32, None, 1e-5, gen)

    g = WINDOW_RES[1] // 14  # 74: N = 5476, q tiles straddle grid rows
    err7 = banded_case("slice grid", 2, g, g, 7, 12, bf16, BF16_ATTN_TOL, gen, dense_plain=True)
    banded_case("slice grid", 2, g, g, 7, 12, f32, 1e-5, gen, dense_plain=True)
    for gh, gw, window in ((50, 110, 7), (3, 1000, 7), (9, 9, 3), (3, 5, 7), (13, 29, 5)):
        banded_case("edge grid", 2, gh, gw, window, 4, bf16, BF16_ATTN_TOL, gen)
        banded_case("edge grid", 2, gh, gw, window, 4, f32, 1e-5, gen)

    # every logit below -60 (phase 2's inputs): the exponentials of scores
    # far below 0, taken against the running max
    g = WINDOW_RES[0] // 14
    wb = local_window_bias(g, g, 7, 0, "cuda", f32)
    bias_case("logits < -60, window", 2, g * g, 4, f32, wb, 1e-5, gen, negative=True)
    bias_case("logits < -60, window", 2, g * g, 4, bf16, wb.to(bf16), BF16_ATTN_TOL, gen,
              negative=True)
    g = WINDOW_RES[1] // 14
    banded_case("logits < -60", 2, g, g, 7, 4, f32, 1e-5, gen, negative=True)
    banded_case("logits < -60", 2, g, g, 7, 4, bf16, BF16_ATTN_TOL, gen, negative=True)

    # two calls at path 3's shapes, with the row log-sum-exp: out and lse
    # equal bit for bit
    for res in WINDOW_RES:
        g = res // 14
        q, k, v = masked_inputs(BATCH, g * g, 12, bf16, gen)
        if res == WINDOW_RES[0]:
            wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
            deterministic(f"kernel 5 with the window bias B={BATCH} grid {g}x{g} bf16",
                          lambda: _bias_forward(q, k, v, wb, with_lse=True)[:2],
                          tag="masked attention")
        else:
            deterministic(f"kernel 7 B={BATCH} grid {g}x{g} bf16",
                          lambda: _banded_forward(q, k, v, (g, 7), with_lse=True),
                          tag="masked attention")
    return err5, err7


# ---------------------------------------------------------------- phase 10
def masked_grad_inputs(b, n, h, dtype, gen, negative=False):
    """q, k, v viewed in one packed qkv (every logit below -60 if asked) and
    an output cotangent ``[B, N, H, 64]``."""
    qkv = attention_inputs(b, n, h, dtype, gen, negative)
    g = torch.randn(b, n, h, 64, generator=gen, device="cuda").to(dtype)
    return (*qkv.view(b, n, 3, h, 64).unbind(2), g)


def bias_grad_case(name, b, n, h, dtype, bias, tol, gen, negative=False, l2_tol=None) -> float:
    """Kernel 6 against its plain version from kernel 5's out and lse."""
    q, k, v, g = masked_grad_inputs(b, n, h, dtype, gen, negative)
    out, lse, live, terms = _bias_forward(q, k, v, bias, with_lse=True)
    before = bias_attention_backward.launches
    got = bias_attention_backward(q, k, v, bias, out, lse, g, live, terms)
    check(bias_attention_backward.launches == before + 1, f"bias grad {name}: no kernel launch")
    btype = "none" if bias is None else str(bias.dtype)[6:]
    return held(f"bias grad {name}: B={b} N={n} H={h} {str(dtype)[6:]} bias {btype}", got,
                {"plain": bias_attention_backward_reference(q, k, v, bias, out, lse, g)},
                tol, l2_tol=l2_tol, tag="masked grad")


def deterministic(name, call, tag="masked grad") -> None:
    """Two calls give their outputs (a tuple: d(qkv), or out and lse) equal
    bit for bit."""
    first, second = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[{tag}] {name}: two calls {'equal bit for bit, ok' if same else 'differ, FAIL'}")
    check(same, f"{name} is not deterministic")


def banded_grad_case(name, b, gh, gw, window, h, dtype, tol, gen, negative=False,
                     l2_tol=None) -> float:
    """Kernel 8 against its plain version from kernel 7's out and lse, and
    kernel 6 with the window bias bit for bit; at the slice grid, kernels 6
    and 8 each twice, bit for bit."""
    band = (gw, window)
    q, k, v, g = masked_grad_inputs(b, gh * gw, h, dtype, gen, negative)
    out, lse = _banded_forward(q, k, v, band, with_lse=True)
    before = banded_attention_backward.launches
    got = banded_attention_backward(q, k, v, band, out, lse, g)
    check(banded_attention_backward.launches == before + 1,
          f"banded grad {name}: no kernel launch")
    wb = local_window_bias(gh, gw, window, 0, "cuda", dtype)
    refs = {"plain": banded_attention_backward_reference(q, k, v, band, out, lse, g),
            "kernel 6": bias_attention_backward(q, k, v, wb, out, lse, g)}
    if name == "slice grid":
        deterministic(f"kernel 8 B={b} grid {gh}x{gw} {str(dtype)[6:]}",
                      lambda: banded_attention_backward(q, k, v, band, out, lse, g))
        deterministic(f"kernel 6 with the window bias B={b} grid {gh}x{gw} {str(dtype)[6:]}",
                      lambda: bias_attention_backward(q, k, v, wb, out, lse, g))
    return held(f"banded grad {name}: B={b} grid {gh}x{gw} window {window} H={h} "
                f"{str(dtype)[6:]}", got, refs, tol, exact=("kernel 6",), l2_tol=l2_tol,
                tag="masked grad")


def autograd_case(name, b, gh, gw, h, dtype, tol, gen, banded) -> None:
    """The training path: ``mha_flash_qkv`` on a packed qkv that requires a
    gradient (kernel 5 or 7 with lse, then kernel 6 or 8 writing d(qkv)
    packed) against autograd of the plain forward with the window bias."""
    n = gh * gw
    qkv = torch.randn(b, n, 3 * h * 64, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, n, h * 64, generator=gen, device="cuda").to(dtype)
    wb = local_window_bias(gh, gw, 7, 0, "cuda", dtype)
    counter = banded_attention_backward if banded else bias_attention_backward
    before = counter.launches
    x = qkv.clone().requires_grad_()
    mha_flash_qkv(x, h, None if banded else wb, (gw, 7)).backward(g)
    check(counter.launches == before + 1, f"autograd {name}: the backward kernel did not run")
    xr = qkv.clone().requires_grad_()
    q, k, v = xr.view(b, n, 3, h, 64).unbind(2)
    mha_bias_reference(q, k, v, wb).reshape(b, n, h * 64).backward(g)
    held(f"autograd {name}: B={b} grid {gh}x{gw} H={h} {str(dtype)[6:]} d(qkv) against "
         f"autograd of the plain forward", x.grad, {"plain": xr.grad}, tol, tag="masked grad")


def phase_window_grad(gen) -> tuple[float, float]:
    """Kernels 6 and 8; returns their max abs errors at the slice shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    tb, tf = BF16_MASKED_GRAD_TOL, FP32_MASKED_GRAD_TOL
    g = WINDOW_RES[0] // 14  # 37: N = 1369
    n = g * g
    b = WINDOW_TRAIN_BATCH[WINDOW_RES[0]]
    err6 = bias_grad_case("slice shape, window", b, n, 12, bf16,
                          local_window_bias(g, g, 7, 0, "cuda", bf16), tb, gen)
    bias_grad_case("window", 2, n, 12, f32, local_window_bias(g, g, 7, 0, "cuda", f32), tf, gen)
    rb = torch.randn(n, n, generator=gen, device="cuda")
    bias_grad_case("random", 2, n, 12, bf16, rb.to(bf16), tb, gen)
    bias_grad_case("random", 2, n, 12, f32, rb, tf, gen)
    ids = torch.repeat_interleave(torch.arange(5), torch.tensor([300, 1, 500, 68, 500]))
    sb = segment_bias(ids).cuda()  # a 1-token segment: one live key in its row
    bias_grad_case("segment", 2, n, 12, bf16, sb.to(bf16), tb, gen)
    bias_grad_case("segment", 2, n, 12, f32, sb, tf, gen)
    bias_grad_case("window + prefix", 2, 197, 12, bf16,
                   local_window_bias(14, 14, 7, 1, "cuda", f32), tb, gen)
    bias_grad_case("window + prefix", 2, 197, 12, f32,
                   local_window_bias(14, 14, 7, 1, "cuda", f32), tf, gen)
    bias_grad_case("no bias", 2, 197, 12, f32, None, tf, gen)
    # every logit below -60: p from the lse stays finite. dK sums nearly
    # cancelling terms, so bf16 is held in relative L2, as kernel 3
    wb = local_window_bias(g, g, 7, 0, "cuda", f32)
    bias_grad_case("logits < -60", 2, n, 4, f32, wb, FP32_NEG_MASKED_GRAD_TOL, gen,
                   negative=True)
    bias_grad_case("logits < -60", 2, n, 4, bf16, wb.to(bf16), None, gen, negative=True,
                   l2_tol=BF16_NEG_MASKED_GRAD_L2_TOL)

    g = WINDOW_RES[1] // 14  # 74: N = 5476
    b = WINDOW_TRAIN_BATCH[WINDOW_RES[1]]
    err8 = banded_grad_case("slice grid", b, g, g, 7, 12, bf16, tb, gen)
    banded_grad_case("slice grid", 2, g, g, 7, 12, f32, tf, gen)
    for gh, gw, window in ((50, 110, 7), (3, 1000, 7), (9, 9, 3), (3, 5, 7), (13, 29, 5)):
        banded_grad_case("edge grid", 2, gh, gw, window, 4, bf16, tb, gen)
        banded_grad_case("edge grid", 2, gh, gw, window, 4, f32, tf, gen)
    banded_grad_case("logits < -60", 2, g, g, 7, 4, f32, FP32_NEG_MASKED_GRAD_TOL, gen,
                     negative=True)
    banded_grad_case("logits < -60", 2, g, g, 7, 4, bf16, None, gen, negative=True,
                     l2_tol=BF16_NEG_MASKED_GRAD_L2_TOL)

    # the autograd Function on the packed qkv, as the encoder runs it
    for banded, (gh, gw) in ((False, (37, 37)), (True, (74, 74))):
        tag = "kernels 7 + 8" if banded else "kernels 5 + 6"
        autograd_case(tag, 2, gh, gw, 4, f32, FP32_MASKED_AUTOGRAD_TOL, gen, banded)
        autograd_case(tag, 2, gh, gw, 4, bf16, BF16_GRAD_TOL, gen, banded)
    return err6, err8


# ---------------------------------------------------------------- phase 6
def synthetic_images(n: int, hw: tuple[int, int] = (480, 640), seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    ims = []
    for _ in range(n):
        f = rng.uniform(0.005, 0.03, size=3)
        base = np.stack([np.sin(f[i] * (xx + rng.uniform(0, 300)) + f[(i + 1) % 3] * yy)
                         for i in range(3)], -1)
        noise = rng.normal(0, 0.1, size=base.shape)
        ims.append(np.clip((base + noise + 1) * 127.5, 0, 255).astype(np.uint8))
    return ims


def depth_vs_cpu(tag: str, arch: str, res: int, depth0: np.ndarray, images, limits) -> dict:
    """Hold the card's bf16 depth of image 0 against the port's CPU fp32
    forward of the same weights: min-max normalized over the pixels where
    either depth is positive, max abs / mean abs / correlation ``limits``."""
    cpu = create_model(arch, dtype=torch.float32, device="cpu", seed=0)
    t0 = time.time()
    ref = predict(cpu, images[:1], res, batch_size=1)[0]
    return compare_depth(tag, depth0, ref, limits, time.time() - t0)


def compare_depth(tag: str, depth0: np.ndarray, ref: np.ndarray, limits, cpu_s: float) -> dict:
    """``depth_vs_cpu``'s comparison of the card's depth of one image with
    the CPU fp32 forward's ``ref``, which took ``cpu_s``."""

    def norm(d):
        return (d - d.min()) / (d.max() - d.min() + 1e-8)

    live = (depth0 > 0) | (ref > 0)
    check(live.mean() > 0.05, f"{tag}: only {live.mean():.3f} of the pixels have depth > 0")
    a, r = norm(depth0)[live], norm(ref)[live]
    diff = np.abs(a - r)
    corr = float(np.corrcoef(a, r)[0, 1])
    max_tol, mean_tol, corr_tol = limits
    ok = diff.max() <= max_tol and diff.mean() <= mean_tol and corr >= corr_tol
    log(f"[{tag}] card bf16 vs CPU fp32 ({cpu_s:.1f} s), min-max-normalized depth of image 0 "
        f"over the {live.mean():.3f} of pixels where either is positive: max_abs "
        f"{diff.max():.4f} mean_abs {diff.mean():.5f} corr {corr:.5f} (tol max<={max_tol}, "
        f"mean<={mean_tol}, corr>={corr_tol}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: card output disagrees with the CPU fp32 forward")
    return {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()), "corr": corr}


def run_predict(tag, model, images, res, expected) -> tuple[np.ndarray, dict]:
    """``predict`` at ``res`` bs8 with every launch count set to 0 just before
    and read just after; the counts must be ``expected`` per forward."""
    reset_counts()
    t0 = time.time()
    depth = predict(model, images, res, batch_size=BATCH)
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = -(-len(images) // BATCH)
    log(f"[{tag}] predict({model.cfg.arch_name}, {len(images)} images, {res}, bf16) in "
        f"{time.time() - t0:.2f} s (first call); launches {counts}")
    check(depth.shape == (len(images), res, res), f"{tag}: depth shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), f"{tag}: non-finite depth")
    check(bool((depth >= 0).all()), f"{tag}: negative depth")
    want = {k: expected.get(k, 0) * forwards for k in COUNTERS}
    check(counts == want, f"{tag}: launches {counts}, expected {want}")
    log(f"[{tag}] depth: min {depth.min():.4g} max {depth.max():.4g} "
        f"positive share {(depth > 0).mean():.3f}")
    return depth, counts


def phase_main_path(model, images) -> dict:
    blocks = model.cfg.encoder.depth
    depth, counts = run_predict("main", model, images, RES, {"attention": blocks, "tail": 1})
    depth_vs_cpu("main", ARCH, RES, depth[0], images, (E2E_MAX, E2E_MEAN, E2E_CORR))
    return counts


# ---------------------------------------------------------------- phase 7
def train_images(n: int, seed: int, res: int = RES) -> np.ndarray:
    """Seeded smooth synthetic images, ImageNet-normalized, NHWC fp32."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    out = np.empty((n, res, res, 3), np.float32)
    for i in range(n):
        f = rng.uniform(2, 12, size=(3, 2))
        ph = rng.uniform(0, 6.3, size=3)
        rgb = np.stack([0.5 + 0.4 * np.sin(f[c, 0] * xx + f[c, 1] * yy + ph[c])
                        for c in range(3)], -1)
        rgb += rng.normal(0, 0.05, size=rgb.shape)
        out[i] = (rgb - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
    return out


COUNTERS = {"attention": mha_flash_packed, "tail": fused_dpt_tail,
            "attention_bwd": packed_attention_backward, "select": kth_select,
            "attention_bias": mha_flash_bias, "attention_banded": mha_flash_banded,
            "attention_bias_bwd": bias_attention_backward,
            "attention_banded_bwd": banded_attention_backward, "w8a8": w8a8_matmul}


def read_counts() -> dict:
    return {k: fn.launches for k, fn in COUNTERS.items()}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def expected_step_counts(batch: int, chunk: int = 8, teacher_quant: str = "none") -> dict:
    """Per step of the ViT-B student under the ViT-L teacher; an int8
    teacher adds kernel 9 four times per teacher block and chunk."""
    s, t = model_config(ARCH).encoder.depth, model_config(TEACHER).encoder.depth
    chunks = batch // chunk if batch > chunk and batch % chunk == 0 else 1
    return {"attention": s + chunks * t, "tail": chunks, "attention_bwd": s, "select": 2,
            "attention_bias": 0, "attention_banded": 0, "attention_bias_bwd": 0,
            "attention_banded_bwd": 0,
            "w8a8": 4 * chunks * t if teacher_quant == "int8_pallas" else 0}


def phase_train(teacher_quant: str = "none") -> tuple[Trainer, dict]:
    """Main path 2 at the tentpole's configuration (with the teacher's
    GEMMs as ``teacher_quant`` sets them), then the CLI over data/smoke.
    Returns the trainer and the per-step launch counts."""
    tag = "train" if teacher_quant == "none" else f"train, teacher {teacher_quant}"
    cfg = TrainConfig(student=model_config(ARCH), teachers=(TEACHER,), batch_size=TRAIN_BATCH,
                      image_size=RES, log_interval=10 ** 6, teacher_quant=teacher_quant,
                      output_dir=str(OUT / f"train_{teacher_quant}"))
    t0 = time.time()
    trainer = Trainer(cfg, "cuda")
    log(f"[{tag}] Trainer({ARCH} <- {TEACHER}, bs{TRAIN_BATCH} {RES}^2 bf16) built in "
        f"{time.time() - t0:.1f} s")
    images = train_images(TRAIN_BATCH * TRAIN_STEPS, seed=1)
    watched = trainer.student.pretrained.blocks[0].attn.qkv.weight
    before = watched.detach().clone()
    want = expected_step_counts(TRAIN_BATCH, cfg.teacher_chunk, teacher_quant)
    seen: list[dict] = []
    last = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = read_counts()
        per = {k: now[k] - last.get(k, 0) for k in now}
        last.update(now)
        vals = {k: float(v) for k, v in metrics.items() if k != "teacher_idx"}
        seen.append(per)
        log(f"[{tag}] step {step}: {json.dumps({k: round(v, 5) for k, v in vals.items()})} "
            f"launches {per}")
        check(per == want, f"{tag} step {step}: launches {per}, expected {want}")
        check(all(np.isfinite(v) for v in vals.values()), f"{tag} step {step}: non-finite")

    def batches(epoch):
        for i in range(TRAIN_STEPS):
            yield {"image": images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]}

    reset_counts()
    t0 = time.time()
    trainer.run(batches, max_steps=TRAIN_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    log(f"[{tag}] {TRAIN_STEPS} steps in {time.time() - t0:.1f} s (first includes set-up)")
    check(len(seen) == TRAIN_STEPS, f"{tag}: {len(seen)} steps ran")
    moved = (watched.detach() - before).abs().max().item()
    log(f"[{tag}] block 0 qkv weight moved by up to {moved:.3e}")
    check(moved > 0, f"{tag}: the student's parameters did not move")

    # the CLI over the repository's smoke data, at a batch it holds; with the
    # bf16 teacher it saves every step (path 6 reads the files)
    from distill_any_depth_tpu_torch.cli import train as train_cli

    out = OUT / f"train_cli_{teacher_quant}"
    reset_counts()
    history = train_cli.main([
        "--device", "cuda", "--dataset_dir", "data/smoke", "--output_dir", str(out),
        "--batch_size", "2", "--num_iterations", "2", "--image_size", str(RES),
        "--use_hdn_loss", "--log_interval", "1", "--teacher_quant", teacher_quant,
        "--checkpoint_interval", "1" if teacher_quant == "none" else "0",
    ])
    torch.cuda.synchronize()
    counts, want = read_counts(), expected_step_counts(2, teacher_quant=teacher_quant)
    log(f"[{tag}] cli.train over data/smoke, bs2, 2 steps: history {history}, launches {counts}")
    check(counts == {k: 2 * v for k, v in want.items()}, f"cli.train: launches {counts}")
    check((out / "history.json").exists(), "cli.train: no history.json")
    check(all(np.isfinite(history["train_loss"])), "cli.train: non-finite loss")
    return trainer, seen[-1]


# ---------------------------------------------------------------- phase 8
def phase_train_vs_cpu() -> dict:
    """One fp32 step of the ViT-L -> ViT-B pair at bs2 on the card and on
    the CPU, from the same weights (``step_vs_cpu``)."""
    cfg = TrainConfig(student=model_config(ARCH), teachers=(TEACHER,), batch_size=2,
                      image_size=RES, student_compute_dtype="float32", teacher_dtype="float32",
                      log_interval=10 ** 6, output_dir=str(OUT / "train_fp32"))
    return step_vs_cpu("fp32 step", cfg, train_images(2, seed=2), FP32_STEP_TOL)


# ---------------------------------------------------------------- phase 9
def phase_window_path(images) -> tuple[torch.nn.Module, dict]:
    """Main path 3: the windowed teacher at 518^2 (bias kernel) and 1036^2
    (banded kernel). Returns the model and each resolution's launch counts."""
    model = create_model(WINDOW_ARCH, dtype=torch.bfloat16, device="cuda", seed=0)
    blocks = model.cfg.encoder.depth
    kernel = dict(zip(WINDOW_RES, ("attention_bias", "attention_banded")))
    counts = {}
    for res in WINDOW_RES:
        depth, counts[res] = run_predict(f"window {res}", model, images, res,
                                         {kernel[res]: blocks, "tail": 1})
        depth_vs_cpu(f"window {res}", WINDOW_ARCH, res, depth[0], images,
                     (WINDOW_E2E_MAX, WINDOW_E2E_MEAN, WINDOW_E2E_CORR))
    return model, counts


# ---------------------------------------------------------------- phase 11
def expected_window_step_counts(res: int, batch: int, chunk: int = 8) -> dict:
    """Per step of the windowed student under the ViT-L teacher: kernel 1 in
    the teacher only, kernels 5 + 6 below the banded threshold, 7 + 8 above
    it, no kernel 3."""
    s, t = model_config(WINDOW_ARCH).encoder.depth, model_config(TEACHER).encoder.depth
    chunks = batch // chunk if batch > chunk and batch % chunk == 0 else 1
    g = res // 14
    banded = banded_eligible(g * g, (g, model_config(WINDOW_ARCH).encoder.window_size))
    return {"attention": chunks * t, "tail": chunks, "attention_bwd": 0, "select": 2,
            "attention_bias": 0 if banded else s, "attention_banded": s if banded else 0,
            "attention_bias_bwd": 0 if banded else s, "attention_banded_bwd": s if banded else 0,
            "w8a8": 0}


def phase_window_train() -> dict:
    """Main path 4: one Trainer (windowed student, ViT-L teacher, bf16), 3
    steps at each of the two sizes, then its step time on a device-resident
    batch; then the CLI over data/smoke. Returns, per size, the launch
    counts of the last step, the step time and the peak memory."""
    cfg = TrainConfig(student=model_config(WINDOW_ARCH), teachers=(TEACHER,),
                      batch_size=WINDOW_TRAIN_BATCH[WINDOW_RES[0]], image_size=WINDOW_RES[0],
                      log_interval=10 ** 6, output_dir=str(OUT / "window_train"))
    t0 = time.time()
    trainer = Trainer(cfg, "cuda")
    log(f"[window train] Trainer({WINDOW_ARCH} <- {TEACHER}, bf16) built in "
        f"{time.time() - t0:.1f} s")
    watched = trainer.student.pretrained.blocks[0].attn.qkv.weight
    results = {}
    for res in WINDOW_RES:
        batch = WINDOW_TRAIN_BATCH[res]
        images = train_images(batch * TRAIN_STEPS, seed=4, res=res)
        want = expected_window_step_counts(res, batch, cfg.teacher_chunk)
        before = watched.detach().clone()
        seen: list[dict] = []
        last = {}

        def on_step(step, metrics):
            torch.cuda.synchronize()
            now = read_counts()
            per = {k: now[k] - last.get(k, 0) for k in now}
            last.update(now)
            vals = {k: float(v) for k, v in metrics.items() if k != "teacher_idx"}
            seen.append(per)
            log(f"[window train] {res}^2 bs{batch} step {step}: "
                f"{json.dumps({k: round(v, 5) for k, v in vals.items()})} launches {per}")
            check(per == want, f"window train {res} step {step}: launches {per}, expected {want}")
            check(all(np.isfinite(v) for v in vals.values()),
                  f"window train {res} step {step}: non-finite")

        def batches(epoch):
            for i in range(TRAIN_STEPS):
                yield {"image": images[i * batch:(i + 1) * batch]}

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        trainer.run(batches, max_steps=int(trainer.state.step) + TRAIN_STEPS, on_step=on_step)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        moved = (watched.detach() - before).abs().max().item()
        log(f"[window train] {res}^2: {TRAIN_STEPS} steps in {time.time() - t0:.1f} s, block 0 "
            f"qkv weight moved by up to {moved:.3e}, peak memory {peak:.2f} GB")
        check(len(seen) == TRAIN_STEPS, f"window train {res}: {len(seen)} steps ran")
        check(moved > 0, f"window train {res}: the student's parameters did not move")
        xs = torch.from_numpy(train_images(batch, seed=5, res=res)).cuda().permute(0, 3, 1, 2)
        windows = [cuda_ms(lambda: trainer.train_step(trainer.state, 0, xs, xs), iters=2,
                           warmup=1) for _ in range(3)]
        step_ms = statistics.median(windows)
        log(f"[window train] {res}^2 bs{batch} step {step_ms:.1f} ms (windows {windows})")
        results[res] = {"counts": seen[-1], "step_ms": step_ms, "step_ms_windows": windows,
                        "steps_per_s": 1e3 / step_ms, "images_per_s": batch * 1e3 / step_ms,
                        "batch": batch, "peak_memory_gb": peak}
        del xs
    del trainer
    torch.cuda.empty_cache()

    # the CLI over the repository's smoke data: kernels 5 + 6 at 518^2
    from distill_any_depth_tpu_torch.cli import train as train_cli

    out = OUT / "window_train_cli"
    reset_counts()
    history = train_cli.main([
        "--device", "cuda", "--dataset_dir", "data/smoke", "--output_dir", str(out),
        "--student_arch", WINDOW_ARCH, "--batch_size", "2", "--num_iterations", "2",
        "--image_size", str(WINDOW_RES[0]), "--use_hdn_loss", "--log_interval", "1",
    ])
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 2 * v for k, v in expected_window_step_counts(WINDOW_RES[0], 2).items()}
    log(f"[window train] cli.train --student_arch {WINDOW_ARCH} over data/smoke, bs2 "
        f"{WINDOW_RES[0]}^2, 2 steps: history {history}, launches {counts}")
    check(counts == want, f"cli.train windowed: launches {counts}, expected {want}")
    check(all(np.isfinite(history["train_loss"])), "cli.train windowed: non-finite loss")
    return results


# ---------------------------------------------------------------- phase 12
def step_vs_cpu(tag: str, cfg: TrainConfig, x: np.ndarray, tol: dict, want=None) -> dict:
    """One fp32 step of ``cfg`` on the card (kernels on their fp32 paths, no
    TF32) and on the CPU from the same weights: relative errors of the loss
    components and the gradient norm, the relative L2 error of the whole
    (clipped) gradient, and the parameters after the first Adam update in
    units of lr, each within ``tol``; on the card, the launch counts of the
    kernels in ``want`` if given."""
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        trainer = Trainer(cfg, dev)
        metrics = {}
        reset_counts()
        trainer.run(lambda epoch: iter([{"image": x}]), max_steps=1,
                    on_step=lambda step, m: metrics.update(m))
        if dev == "cuda" and want is not None:
            got = {k: read_counts()[k] for k in want}
            check(got == want, f"{tag}: launches {got}, expected {want}")
        params = trainer.state.params
        qkv = [p for name, p in trainer.student.named_parameters() if ".attn.qkv." in name]
        runs[dev] = ({k: float(v) for k, v in metrics.items() if k != "teacher_idx"},
                     torch.cat([p.detach().reshape(-1).cpu() for p in params]),
                     torch.cat([p.grad.reshape(-1).cpu() for p in params]),
                     torch.cat([p.grad.reshape(-1).cpu() for p in qkv]))
        log(f"[{tag}] {dev}: {json.dumps({k: round(v, 6) for k, v in runs[dev][0].items()})}"
            f" in {time.time() - t0:.1f} s")
        del trainer
    (mc, pc, gc, qc), (mr, pr, gr, qr) = runs["cuda"], runs["cpu"]
    readings = {f"{k} rel": abs(mc[k] - mr[k]) / max(abs(mr[k]), 1e-12) for k in mr}
    readings["grad rel L2"] = ((gc - gr).norm() / gr.norm()).item()
    if "qkv grad rel L2" in tol:
        readings["qkv grad rel L2"] = ((qc - qr).norm() / qr.norm()).item()
    lr = cfg.optimizer.lr
    readings["param mean |diff|/lr"] = (pc - pr).abs().mean().item() / lr
    readings["param max |diff|/lr"] = (pc - pr).abs().max().item() / lr
    bad = {k: (v, tol[k]) for k, v in readings.items() if not v <= tol[k]}
    log(f"[{tag}] card vs CPU: {json.dumps(readings)} tol {json.dumps(tol)} "
        f"{'ok' if not bad else 'FAIL'}")
    check(not bad, f"{tag}: card disagrees with the CPU: {bad}")
    return readings


def phase_window_train_vs_cpu() -> dict:
    """The windowed student's fp32 step under a ViT-S teacher, card against
    CPU: bs2 at 518^2 (kernels 5 + 6) and bs1 at 784^2 (56 x 56 = 3136
    tokens: kernels 7 + 8). The loss stack has no order statistic (no
    depth normalization, no HDN: SC L1, feature cosine, Sobel gradient):
    a median or quantile puts its whole derivative on the one pixel it
    selects, and at random init this model's depth has near-ties that fp32
    reordering resolves differently on the card and the CPU, which moved
    4-6% of the gradient (hybrid or global normalization) with the
    attention kernels and with plain attention on the card alike, while
    the model's own backward agreed to 1e-5. Phase 8 holds the default
    stack."""
    readings = {}
    for res, batch, seed in ((WINDOW_RES[0], 2, 6), (784, 1, 7)):
        cfg = TrainConfig(student=model_config(WINDOW_ARCH), teachers=("depthanything-small",),
                          loss=LossConfig(normalization="none", use_hdn=False),
                          batch_size=batch, image_size=res, student_compute_dtype="float32",
                          teacher_dtype="float32", log_interval=10 ** 6,
                          output_dir=str(OUT / f"window_fp32_{res}"))
        g = res // 14
        banded = banded_eligible(g * g, (g, 7))
        s = model_config(WINDOW_ARCH).encoder.depth
        want = {"attention": model_config("depthanything-small").encoder.depth,
                "attention_bwd": 0, "attention_bias": 0 if banded else s,
                "attention_bias_bwd": 0 if banded else s, "attention_banded": s if banded else 0,
                "attention_banded_bwd": s if banded else 0}
        readings[res] = step_vs_cpu(f"window fp32 step {res}", cfg,
                                    train_images(batch, seed=seed, res=res),
                                    WINDOW_FP32_STEP_TOL, want)
    return readings


# ---------------------------------------------------------------- phase 13
def w8a8_inputs(m, k, n, dtype, gen, with_bias=True):
    """x ``[M, K]`` whose row 0 has amax 127 (scale exactly 1) and holds the
    ties +-0.5, 2.5, -3.5, 1.5, and whose row 1 is zero; an fp32 ``[N, K]``
    weight and bias as a Linear holds them."""
    x = torch.randn(m, k, generator=gen, device="cuda") * 2
    x[0, :6] = torch.tensor([127.0, 0.5, -0.5, 2.5, -3.5, 1.5], device="cuda")
    if m > 1:
        x[1] = 0.0
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    b = torch.randn(n, generator=gen, device="cuda") * 0.1 if with_bias else None
    return x.to(dtype), w, b


def w8a8_case(name, m, k, n, dtype, with_bias, gen) -> float:
    """Kernel 9 against its plain version on the same quantized weight:
    equal bit for bit (the same true divisions, an exact integer product,
    the same separately rounded dequant). Returns the max abs error."""
    x, w, b = w8a8_inputs(m, k, n, dtype, gen, with_bias)
    wq, ws = quantize_weight(w)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, w, b, quantized=(wq, ws))
    check(w8a8_matmul.launches == before + 1, f"w8a8 {name}: the kernel did not run")
    ref = w8a8_reference(x, wq, ws, b, dtype)
    torch.cuda.synchronize()
    check(got.shape == (m, n) and got.dtype == dtype, f"w8a8 {name}: bad output")
    check(bool(torch.isfinite(got).all()), f"w8a8 {name}: non-finite output")
    same = bool(torch.equal(got, ref))
    abs_err = errors(got, ref)[0]
    log(f"[w8a8] {name}: M={m} K={k} N={n} {str(dtype)[6:]} {'bias' if with_bias else 'no bias'}"
        f": {int((got != ref).sum())} outputs differ, max_abs_err={abs_err:.3e} "
        f"(exact equality required) {'ok' if same else 'FAIL'}")
    check(same, f"w8a8 {name} disagrees with its plain version")
    return abs_err


def phase_w8a8(gen) -> float:
    """Kernel 9 at every encoder GEMM shape of paths 5 and 1 and of the int8
    teacher, and at edge shapes (a single row; M, K, N off the 128 x 256
    output tiles and the 128-byte K chunks); returns the max abs error at
    the slice shapes."""
    err = 0.0
    for label, (m, gemms) in W8A8_SHAPES.items():
        for gemm, (k, n) in zip(GEMMS, gemms):
            for dtype in (torch.bfloat16, torch.float32):
                for with_bias in (True, False):
                    err = max(err, w8a8_case(f"{label} {gemm}", m, k, n, dtype, with_bias, gen))
    for m in (1, 100, 129, 257):
        for n in (200, 264):
            for k in (96, 4096):
                for dtype in (torch.bfloat16, torch.float32):
                    for with_bias in (True, False):
                        w8a8_case("edge", m, k, n, dtype, with_bias, gen)
    return err


# ---------------------------------------------------------------- phase 14
def quant_images(n: int) -> np.ndarray:
    """The synthetic images resized on the host to the 518 bucket, as
    ``cli.pseudo_label.main`` resizes them."""
    import cv2

    return np.stack([cv2.resize(im, (QUANT_RES, QUANT_RES), interpolation=cv2.INTER_CUBIC)
                     for im in synthetic_images(n)])


def phase_pseudo_label():
    """Main path 5: ViT-L at 518^2 bs8 bf16 with int8_pallas GEMMs over 10
    images (two forwards, the second padded with zero images), then the CLI
    over a folder of PNGs. Returns the int8_pallas model, the unquantized
    one, the launch counts and the images."""
    import cv2

    from distill_any_depth_tpu_torch.cli import pseudo_label

    bf16 = torch.bfloat16
    model = create_model(QUANT_ARCH, dtype=bf16, device="cuda", seed=0, quant="int8_pallas")
    ims = quant_images(QUANT_IMAGES)
    blocks = model.cfg.encoder.depth
    forwards = -(-QUANT_IMAGES // QUANT_BATCH)
    per_forward = {"w8a8": 4 * blocks, "attention": blocks, "tail": 1}
    want = {k: per_forward.get(k, 0) * forwards for k in COUNTERS}
    reset_counts()
    t0 = time.time()
    depth = pseudo_label.label_batches(model, ims, QUANT_RES, QUANT_BATCH)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[pseudo-label] label_batches({QUANT_ARCH}, {QUANT_IMAGES} images, {QUANT_RES}, bs"
        f"{QUANT_BATCH}, bf16, int8_pallas) in {time.time() - t0:.2f} s (first call); "
        f"launches {counts}")
    check(counts == want, f"pseudo-label: launches {counts}, expected {want}")
    check(depth.shape == (QUANT_IMAGES, QUANT_RES, QUANT_RES) and depth.dtype == np.float32,
          f"pseudo-label: depth {depth.shape} {depth.dtype}")
    check(bool(np.isfinite(depth).all()) and bool((depth >= 0).all()),
          "pseudo-label: non-finite or negative depth")

    cpu = create_model(QUANT_ARCH, dtype=torch.float32, device="cpu", seed=0, quant="int8_pallas")
    t0 = time.time()
    ref = pseudo_label.label_batches(cpu, ims[:1], QUANT_RES, 1)[0]
    compare_depth("pseudo-label", depth[0], ref, (QUANT_E2E_MAX, QUANT_E2E_MEAN, QUANT_E2E_CORR),
                  time.time() - t0)
    del cpu

    plain = create_model(QUANT_ARCH, dtype=bf16, device="cuda", seed=0)
    unquantized = pseudo_label.label_batches(plain, ims, QUANT_RES, QUANT_BATCH)
    corr = float(np.corrcoef(depth.ravel(), unquantized.ravel())[0, 1])
    ok = corr >= QUANT_VS_PLAIN_CORR
    log(f"[pseudo-label] int8_pallas depth against the unquantized bf16 depth, {QUANT_IMAGES} "
        f"images: corr {corr:.5f} (tol >= {QUANT_VS_PLAIN_CORR}) {'ok' if ok else 'FAIL'}")
    check(ok, "pseudo-label: int8 depth does not follow the unquantized depth")

    inp, out = OUT / "pseudo_label_in", OUT / "pseudo_label_out"
    inp.mkdir(parents=True, exist_ok=True)
    for i, im in enumerate(synthetic_images(QUANT_IMAGES)):
        cv2.imwrite(str(inp / f"im{i:02d}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    reset_counts()
    written = pseudo_label.main(["--input", str(inp), "--output_dir", str(out),
                                 "--quant", "int8_pallas", "--device", "cuda"])
    torch.cuda.synchronize()
    cli_counts = read_counts()
    log(f"[pseudo-label] cli.pseudo_label over {QUANT_IMAGES} PNGs: {len(written)} depth maps, "
        f"launches {cli_counts}")
    check(cli_counts == want, f"cli.pseudo_label: launches {cli_counts}, expected {want}")
    check(len(written) == QUANT_IMAGES, f"cli.pseudo_label wrote {len(written)} maps")
    for path in written:
        d = np.load(path)
        check(d.shape == (QUANT_RES, QUANT_RES) and d.dtype == np.float32
              and bool(np.isfinite(d).all()), f"cli.pseudo_label: bad map {path}")
    return model, plain, counts, ims


# ---------------------------------------------------------------- phase 17
# path 6, the card's evaluation against the port's CPU fp32 evaluate_model
# with the same weights on 2 images: the largest relative difference of
# abs_rel, abs_diff, sq_rel, rmse and rmse_log, and the largest absolute
# difference of the deltas a1-a3 (fractions of pixels). About 3x the largest
# reading on an H100 over four runs (path 2 trains the weights anew in each
# run, and the readings moved 3-4x with them): fp32 1.6e-7, 2.3e-7, 1.2e-7
# and 5.75e-7 on NYU, 9e-8, 1.5e-7, 1.5e-7 and 0 on KITTI; bf16 2.7e-4,
# 4.0e-4, 8.6e-4 and 6.1e-4, deltas 1.7e-4, 2.5e-4, 6.4e-4 and 7.2e-4. The
# fp32 deltas read 0, 3.3e-6, 0 and 0: a delta moves in steps of one pixel,
# 1 / (2 n) for an image of n valid pixels (3.3e-6 is one NYU pixel), so the
# fp32 limit is 3x that reading in pixels, FP32_DELTA_PIXELS / (2 n) for the
# fewer-pixel image of the 2 (about 1e-5 on NYU, 3.3e-5 on KITTI's ~46k)
EVAL_VS_CPU_TOL = {"float32": (1.7e-6, None), "bfloat16": (2.6e-3, 2e-3)}
FP32_DELTA_PIXELS = 3
DELTAS = ("a1", "a2", "a3")
# path 6's images/s: the median of EVAL_PASSES passes over the dataset with
# the decode, and of passes over the decoded batches for EVAL_DECODED_S
# seconds and at least EVAL_PASSES + 2 passes
EVAL_PASSES, EVAL_DECODED_S = 3, 3.0


def nyu_eval_data(root: Path) -> Path:
    """``NYU_EVAL_IMAGES`` seeded 480x640 RGB and uint16 depth PNG pairs and
    their ``nyu2_test.csv`` (absolute paths) under ``root``."""
    import cv2

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    rows = []
    for i, im in enumerate(synthetic_images(NYU_EVAL_IMAGES, seed=5)):
        f = rng.uniform(0.002, 0.01, size=2)
        depth = 20000 + 15000 * np.sin(f[0] * xx + rng.uniform(0, 6)) * np.cos(f[1] * yy)
        depth = (depth + rng.normal(0, 500, depth.shape)).clip(1, 65535).astype(np.uint16)
        depth[:8] = 0  # invalid rows, as the sensor leaves them
        rgb_path, depth_path = root / f"{i:03d}_colors.png", root / f"{i:03d}_depth.png"
        cv2.imwrite(str(rgb_path), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(depth_path), depth)
        rows.append(f"{rgb_path},{depth_path}")
    (root / "nyu2_test.csv").write_text("\n".join(rows) + "\n")
    return root


def kitti_eval_data(root: Path) -> Path:
    """``KITTI_EVAL_IMAGES`` seeded 375x1242 RGB and uint16 (/256 m) depth
    pairs, 0 where a pixel has no depth, and the split list the registry
    reads under ``root``."""
    import cv2

    (root / "kitti").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(6)
    lines = []
    for i, im in enumerate(synthetic_images(KITTI_EVAL_IMAGES, hw=KITTI_RAW_HW, seed=6)):
        depth = rng.randint(256, 20000, KITTI_RAW_HW).astype(np.uint16)  # 1 to 78 m
        depth[rng.rand(*KITTI_RAW_HW) < 0.8] = 0  # sparse, as projected LiDAR
        cv2.imwrite(str(root / f"rgb_{i:02d}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / f"depth_{i:02d}.png"), depth)
        lines.append(f"rgb_{i:02d}.png depth_{i:02d}.png")
    (root / "kitti" / "eigen_test_files_with_gt.txt").write_text("\n".join(lines) + "\n")
    return root


def metrics_vs_cpu(tag: str, got: dict, ref: dict, tol: tuple[float, float]) -> dict:
    """The card's metrics against the CPU fp32 ones (``EVAL_VS_CPU_TOL``)."""
    from distill_any_depth_tpu_torch.eval.metrics import METRIC_KEYS

    diff = {k: abs(got[k] - ref[k]) / (1.0 if k in DELTAS else abs(ref[k])) for k in METRIC_KEYS}
    rel = max(v for k, v in diff.items() if k not in DELTAS)
    delta = max(v for k, v in diff.items() if k in DELTAS)
    ok = rel <= tol[0] and delta <= tol[1]
    log(f"[{tag}] card against CPU fp32 on 2 images: {json.dumps(diff)}; max rel {rel:.3e} "
        f"(tol {tol[0]:g}), max delta diff {delta:.3e} (tol {tol[1]:g}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: card metrics disagree with the CPU fp32 evaluation")
    return {"max_rel": rel, "max_delta": delta, **diff}


def run_evaluate(tag: str, argv: list[str], images: int, in_hw: tuple[int, int],
                 gt_hw: tuple[int, int], cpu_ref: dict) -> tuple[dict, dict]:
    """``cli.evaluate`` on the card with every launch count set to 0 just
    before and read just after (kernels 1 and 2 per batch); then, with the
    model the CLI builds, images/s over the dataset (decode included) and
    the metrics of its first 2 images against the CPU fp32 model's
    (computed once per dataset into ``cpu_ref``). Returns the results and
    the readings."""
    from distill_any_depth_tpu_torch.cli import evaluate as evaluate_cli
    from distill_any_depth_tpu_torch.data.nyu import iterate_batches
    from distill_any_depth_tpu_torch.eval.evaluate import evaluate_model
    from distill_any_depth_tpu_torch.eval.metrics import METRIC_KEYS

    args = evaluate_cli.argument_parser().parse_args(argv)
    reset_counts()
    t0 = time.time()
    results = evaluate_cli.main(args)
    torch.cuda.synchronize()
    counts = read_counts()
    batches = images // EVAL_BATCH
    blocks = model_config(args.arch_name).encoder.depth
    want = {k: {"attention": blocks, "tail": 1}.get(k, 0) * batches for k in COUNTERS}
    log(f"[{tag}] cli.evaluate over {images} images in {time.time() - t0:.1f} s (first call, "
        f"model build included): {json.dumps(results)} launches {counts}")
    check(counts == want, f"{tag}: launches {counts}, expected {want}")
    m = results["distilled"]
    check(set(m) == set(METRIC_KEYS) and all(np.isfinite(v) for v in m.values()),
          f"{tag}: metrics {m}")
    report = Path(args.output)
    check(report.exists() and report.with_suffix(".json").exists(), f"{tag}: no report")

    ds = evaluate_cli.build_dataset(args)
    check(ds[0].image.shape == (*in_hw, 3) and ds[0].depth.shape == gt_hw,
          f"{tag}: sample {ds[0].image.shape} {ds[0].depth.shape}")
    model = evaluate_cli.build_model(args, args.model_path)

    def pass_rate(batches) -> float:
        t0 = time.perf_counter()
        evaluate_model(model, batches)
        torch.cuda.synchronize()
        return images / (time.perf_counter() - t0)

    rates = [pass_rate(iterate_batches(ds, EVAL_BATCH, shuffle=False))
             for _ in range(EVAL_PASSES)]
    # the same without the decode: the batches decoded first, then evaluated
    t0 = time.perf_counter()
    decoded = list(iterate_batches(ds, EVAL_BATCH, shuffle=False))
    decode_s = time.perf_counter() - t0
    decoded_rates, t0 = [], time.perf_counter()
    while len(decoded_rates) < EVAL_PASSES + 2 or time.perf_counter() - t0 < EVAL_DECODED_S:
        decoded_rates.append(pass_rate(decoded))
    decoded_s = time.perf_counter() - t0
    del decoded
    rate, decoded_rate = float(np.median(rates)), float(np.median(decoded_rates))
    two = list(iterate_batches(ds, 2, shuffle=False, indices=[0, 1]))
    with torch.no_grad():
        x = torch.from_numpy(two[0]["image"]).cuda().permute(0, 3, 1, 2)
        check(tuple(model(x)[0].shape) == (2, *in_hw), f"{tag}: prediction shape")
    if "metrics" not in cpu_ref:
        cpu_args = evaluate_cli.argument_parser().parse_args(
            [*argv, "--device", "cpu", "--dtype", "float32"])
        t0 = time.time()
        cpu_ref["metrics"] = evaluate_model(evaluate_cli.build_model(cpu_args, args.model_path),
                                            two)
        log(f"[{tag}] CPU fp32 evaluate_model on 2 images in {time.time() - t0:.1f} s: "
            f"{json.dumps(cpu_ref['metrics'])}")
    rel_tol, delta_tol = EVAL_VS_CPU_TOL[args.dtype]
    if delta_tol is None:
        delta_tol = FP32_DELTA_PIXELS / (2 * int((two[0]["depth"] > 0).sum((1, 2)).min()))
    reading = metrics_vs_cpu(tag, evaluate_model(model, two), cpu_ref["metrics"],
                             (rel_tol, delta_tol))
    log(f"[{tag}] {images} images: median {rate:.1f} images/s over {len(rates)} passes "
        f"(decode included) {[round(r, 2) for r in rates]}; decode alone {decode_s:.2f} s; "
        f"the evaluation of decoded batches median {decoded_rate:.1f} images/s over "
        f"{len(decoded_rates)} passes in {decoded_s:.1f} s "
        f"{[round(r, 1) for r in decoded_rates]}")
    per_batch = {k: v // batches for k, v in counts.items()}
    return results, {"images": images, "images_per_s": rate, "passes": rates,
                     "decode_s": decode_s, "decoded_images_per_s": decoded_rate,
                     "decoded_passes": decoded_rates, "vs_cpu": reading,
                     "launches_per_batch": per_batch}


def phase_checkpoints_and_eval(trainer: Trainer, source: torch.nn.Module) -> dict:
    """Path 6: what path 2's ``cli.train`` saved (weights read back through
    the port's own reader, ``cli.infer --checkpoint``, the train state
    restored into ``trainer``'s state, ``cli.train --resume``), a ViT-L
    teacher through ``save_safetensors``, ``cli.convert`` and
    ``teacher_checkpoints``, and ``cli.evaluate`` on NYU (fp32 and bf16) and
    on KITTI at its native resolution. ``source`` is a seeded ViT-L (path 5's
    unquantized model, seed 0). Returns the readings and times."""
    from distill_any_depth_tpu_torch.cli import convert as convert_cli
    from distill_any_depth_tpu_torch.cli import infer as infer_cli
    from distill_any_depth_tpu_torch.cli import train as train_cli
    from distill_any_depth_tpu_torch.utils import checkpoint as ckpt_io

    out, run = {}, OUT / "train_cli_none"
    t_phase = time.time()

    # saves: every step, the final weights and the train state
    final = run / "student_final.safetensors"
    for name in ("student_checkpoint_1.safetensors", "student_checkpoint_2.safetensors",
                 final.name, "train_state/state.pt"):
        check((run / name).exists(), f"cli.train did not write {name}")
    t0 = time.perf_counter()
    weights = ckpt_io.read_safetensors(str(final))
    read_s = time.perf_counter() - t0
    saved = ckpt_io.restore_train_state(str(run))
    names = [k for k, _ in trainer.student.named_parameters()]
    check(int(saved["step"]) == 2 and sorted(weights) == sorted(names),
          f"student_final: {len(weights)} tensors, state at step {int(saved['step'])}")
    equal = all(torch.equal(weights[k], p) for k, p in zip(names, saved["params"]))
    last = ckpt_io.read_safetensors(str(run / "student_checkpoint_2.safetensors"))
    equal = equal and all(torch.equal(last[k], weights[k]) for k in names)
    log(f"[path 6] student_final ({final.stat().st_size / 1e6:.1f} MB, read in {read_s:.2f} s) "
        f"equals the saved fp32 parameters and student_checkpoint_2 bit for bit: {equal}")
    check(equal, "student_final differs from the student's parameters")

    # the saved weights through cli.infer on the card
    reset_counts()
    written = infer_cli.main(infer_cli.argument_parser().parse_args([
        "--device", "cuda", "--arch_name", ARCH, "--checkpoint", str(final), "--input",
        "data/smoke/imgs", "--output_dir", str(OUT / "infer_checkpoint")]))
    torch.cuda.synchronize()
    counts, n_in = read_counts(), len(list(Path("data/smoke/imgs").iterdir()))
    forwards = -(-n_in // BATCH)
    want = {k: {"attention": model_config(ARCH).encoder.depth, "tail": 1}.get(k, 0) * forwards
            for k in COUNTERS}
    log(f"[path 6] cli.infer --checkpoint student_final over data/smoke/imgs: {len(written)} "
        f"of {n_in} images written, launches {counts}")
    check(len(written) == n_in and all(Path(w).exists() for w in written), "cli.infer outputs")
    check(counts == want, f"cli.infer --checkpoint: launches {counts}, expected {want}")

    # the train state restored on the card into path 2's trainer (the same
    # student): parameters, Adam moments and counts, lr and counters
    t0 = time.perf_counter()
    trainer.state.load_state_dict(saved)
    torch.cuda.synchronize()
    out["train_state_load_s"] = time.perf_counter() - t0
    back = trainer.state.state_dict()
    opt = trainer.state.optimizer
    same = all(torch.equal(a[k], b[k]) for a, b in zip(back["adam"], saved["adam"])
               for k in ("exp_avg", "exp_avg_sq", "step"))
    same = same and all(torch.equal(a, b) for a, b in zip(back["params"], saved["params"]))
    same = same and all(torch.equal(back[k], saved[k])
                        for k in ("lr", "step", "applied", "notfinite_count", "last_norm"))
    on_card = all(opt.state[p]["step"].is_cuda for p in trainer.state.params)
    log(f"[path 6] train state (step 2) restored into the bs16 trainer in "
        f"{out['train_state_load_s']:.2f} s: parameters, Adam moments and counts, lr and "
        f"counters equal bit for bit: {same}; Adam counts on the card: {on_card}")
    check(same and on_card and opt.param_groups[0]["lr"].is_cuda, "train state restore")

    # cli.train --resume: steps 3 and 4 from the saved state. Bit-exact
    # continuation is a CPU test (tests/test_torch_checkpoint_io.py): cuDNN's
    # backward may pick non-deterministic algorithms on the card.
    resumed = OUT / "train_cli_resume"
    reset_counts()
    history = train_cli.main([
        "--device", "cuda", "--dataset_dir", "data/smoke", "--output_dir", str(resumed),
        "--batch_size", "2", "--num_iterations", "4", "--image_size", str(RES),
        "--use_hdn_loss", "--log_interval", "1", "--resume", str(run),
    ])
    torch.cuda.synchronize()
    counts, want = read_counts(), expected_step_counts(2)
    step = int(ckpt_io.restore_train_state(str(resumed))["step"])
    log(f"[path 6] cli.train --resume, 2 steps from step 2: history {history}, launches "
        f"{counts}, saved at step {step}")
    check(counts == {k: 2 * v for k, v in want.items()}, f"cli.train --resume: launches {counts}")
    check(step == 4 and len(history["lr"]) == 2 and all(np.isfinite(history["train_loss"])),
          "cli.train --resume did not run steps 3 and 4")

    # the ViT-B student's save and load times
    t0 = time.perf_counter()
    ckpt_io.save_safetensors(str(OUT / "student.safetensors"), trainer.student)
    out["vit_b_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_io.load_state_dict_file(trainer.student, str(OUT / "student.safetensors"))
    torch.cuda.synchronize()
    out["vit_b_load_s"] = time.perf_counter() - t0
    (OUT / "student.safetensors").unlink()

    # the seeded ViT-L saved, converted to backbone.* keys, and loaded as the
    # teacher of a Trainer, whose own seed for it would be 100
    raw, converted = OUT / "teacher.safetensors", OUT / "teacher_backbone.safetensors"
    t0 = time.perf_counter()
    ckpt_io.save_safetensors(str(raw), source)
    out["vit_l_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = convert_cli.main([str(raw), str(converted)])
    out["vit_l_convert_s"] = time.perf_counter() - t0
    want_n = sum(k.startswith("pretrained.") for k, _ in source.named_parameters())
    check(n == want_n, f"cli.convert renamed {n} keys, expected {want_n}")
    t0 = time.perf_counter()
    ckpt_io.load_state_dict_file(source, str(converted))
    torch.cuda.synchronize()
    out["vit_l_load_s"] = time.perf_counter() - t0
    cfg = TrainConfig(student=model_config(ARCH), teachers=(TEACHER,), batch_size=8,
                      image_size=RES, teacher_checkpoints=(str(converted),),
                      output_dir=str(OUT / "train_teacher_checkpoint"))
    loaded = Trainer(cfg, "cuda").teachers[0]
    same = all(torch.equal(a, b) for a, b in zip(loaded.parameters(), source.parameters()))
    x = torch.from_numpy(train_images(8, seed=4)).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        same_fwd = torch.equal(loaded(x)[0], source(x)[0])
    log(f"[path 6] ViT-L teacher: save {out['vit_l_save_s']:.2f} s "
        f"({raw.stat().st_size / 1e9:.2f} GB), cli.convert {out['vit_l_convert_s']:.2f} s "
        f"({n} keys renamed), load {out['vit_l_load_s']:.2f} s; the Trainer's teacher equals "
        f"it bit for bit: parameters {same}, bs8 {RES}^2 forward {same_fwd}")
    check(same and same_fwd and loaded.dtype == source.dtype,
          "teacher_checkpoints did not load the teacher")
    raw.unlink()
    converted.unlink()
    del loaded
    torch.cuda.empty_cache()

    # evaluation on NYU at 392^2 (fp32, bf16) and KITTI at its native size
    common = ["--arch_name", ARCH, "--model_path", str(final), "--image_size", str(RES),
              "--batch_size", str(EVAL_BATCH), "--device", "cuda"]
    nyu = nyu_eval_data(OUT / "nyu_eval")
    cpu_ref: dict = {}
    for dtype in ("float32", "bfloat16"):
        _, out[f"nyu_{dtype}"] = run_evaluate(
            f"eval NYU {dtype}", [*common, "--data_dir", str(nyu), "--dtype", dtype,
                                  "--output", str(OUT / f"eval_nyu_{dtype}" / "report.txt")],
            NYU_EVAL_IMAGES, (RES, RES), (RES, RES), cpu_ref)
    kitti = kitti_eval_data(OUT / "kitti_eval")
    _, out["kitti_float32"] = run_evaluate(
        "eval KITTI native", [*common, "--dataset", "kitti", "--data_dir", str(kitti),
                              "--output", str(OUT / "eval_kitti" / "report.txt")],
        KITTI_EVAL_IMAGES, KITTI_IN_HW, KITTI_CROP_HW, {})
    out["seconds"] = time.time() - t_phase
    log(f"[path 6] checkpoints and evaluation passed in {out['seconds']:.1f} s")
    print(json.dumps({"checkpoints_and_eval": out, "gpu": gpu_line()}), flush=True)
    return out


# ---------------------------------------------------------------- phase 16
def phase_timing(model, images, counts, errs, trainer, train_counts, wmodel, wcounts,
                 wtrain, qmodel, qplain, qcounts, qims, qtrainer, qtrain_counts, evals, gen) -> None:
    kernels = []
    bf16 = torch.bfloat16
    runs = {"infer_forward": counts, "train_step": train_counts,
            **{f"window_{res}_forward": wcounts[res] for res in WINDOW_RES},
            **{f"window_train_{res}_step": wtrain[res]["counts"] for res in WINDOW_RES},
            f"pseudo_label_{QUANT_IMAGES}_images": qcounts,
            "int8_teacher_train_step": qtrain_counts,
            **{f"eval_{k}_batch": evals[k]["launches_per_batch"]
               for k in ("nyu_float32", "nyu_bfloat16", "kitti_float32")}}

    def entry(name, key, source, replaces, err, ms, plain, lib, flops, nbytes, launches=None,
              rate=PEAK_BF16_FLOPS, **extra):
        b_ms, b_by = bound(flops, nbytes, rate)
        by_path = {path: c[key] for path, c in runs.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"distill_any_depth_tpu_torch/csrc/{source}",
                        "replaces": f"distill_any_depth_tpu/{replaces}",
                        "launches": by_path["infer_forward"] if launches is None else launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib, "launches_by_path": by_path,
                        **extra})

    # kernel 1 at the inference shape (ViT-B bs8), at the teacher's (ViT-L bs8
    # chunk) and at the ViT-L teacher's N at 1036^2 (the windowed student's
    # path 4), each beside SDPA on the same q, k, v; event times of
    # back-to-back calls and the profiler's device times
    n, d = (RES // 14) ** 2 + 1, 64
    n1036 = (WINDOW_RES[1] // 14) ** 2 + 1
    attn = {}
    for tag, b, nn, h in (("student", BATCH, n, 12), ("teacher", 8, n, 16),
                          ("teacher_1036", 8, n1036, 16)):
        c = h * d
        qkv = torch.randn(b, nn, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (x.contiguous() for x in qkv.view(b, nn, 3, h, d).permute(2, 0, 3, 1, 4))
        iters = 50 if nn == n else 10
        lib_dev, lib_kernels = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        attn[tag] = dict(
            B=b, N=nn, H=h, ms=cuda_ms(lambda: mha_flash_packed(qkv, h), iters=iters),
            device_ms=device_ms(lambda: mha_flash_packed(qkv, h))[0],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=iters),
            library_device_ms=lib_dev, library_kernels=lib_kernels,
            bound_ms=bound(4.0 * b * h * nn * nn * d, 4 * b * nn * c * 2)[0])
        if nn == n:
            attn[tag]["plain_ms"] = cuda_ms(lambda: mha_packed_reference(qkv, h))
        else:
            # its error at bs1: the plain version's fp32 scores at bs8 would take 15 GB
            attn[tag]["max_err_b1"] = reading_of(mha_flash_packed(qkv[:1], h),
                                                 mha_packed_reference(qkv[:1], h))
            check(attn[tag]["max_err_b1"] <= BF16_ATTN_TOL, "kernel 1 at N = 5477 outside tolerance")
        log(f"[timing] kernel 1 {tag}: {json.dumps(attn[tag])}")
        del qkv, q, k, v
    a = attn["student"]
    entry("packed_attention_fwd", "attention", "flash_attention.cu",
          "ops/flash_attention.py:537", errs["attention"], a["ms"], a["plain_ms"],
          a["library_ms"], 4.0 * BATCH * 12 * n * n * d, 4 * BATCH * n * 12 * d * 2,
          device_ms=a["device_ms"], library_device_ms=a["library_device_ms"],
          library_kernels=a["library_kernels"], teacher_shape=attn["teacher"],
          teacher_1036_shape=attn["teacher_1036"])

    # kernel 2 at every shape a path launches it (bf16; the weights prepared
    # once, as the model's WeightCache keeps them): CUDA events and the
    # profiler's device time of its two launches, beside its bound; the
    # plain version and a call that packs the weights itself at path 1's
    tail_rows = []
    for label, b, c, res, relu in TAIL_SHAPES:
        oh, ow = (res, res) if isinstance(res, int) else res
        t, w = tail_inputs(b, oh // 14 * 4, ow // 14 * 4, c, bf16, gen)
        prep = prepare_weights(*w.values(), bf16)

        def tail_call():
            return fused_dpt_tail(t, (oh, ow), trailing_relu=relu, weights=prep, **w)

        split = device_split(tail_call, 5)
        flops, nbytes = tail_work(b, oh // 14 * 4, ow // 14 * 4, c, oh, ow)
        row = dict(shape=label, B=b, C=c, res=res,
                   ms=cuda_ms(tail_call, iters=20 if oh * ow < 10 ** 6 else 5),
                   device_ms=sum(split.values()), device_split=split,
                   bound_ms=bound(flops, nbytes)[0])
        if len(tail_rows) == 0:
            row["plain_ms"] = cuda_ms(lambda: tail_reference(t, (oh, ow), trailing_relu=relu,
                                                             **w))
            row["ms_packing_each_call"] = cuda_ms(
                lambda: fused_dpt_tail(t, (oh, ow), trailing_relu=relu, **w))
        log(f"[timing] kernel 2 {label}: {json.dumps(row)}")
        tail_rows.append(row)
        del t, w, prep
        torch.cuda.empty_cache()
    a = tail_rows[0]
    entry("dpt_tail", "tail", "dpt_tail.cu", "ops/dpt_tail.py:362", errs["tail"], a["ms"],
          a["plain_ms"], None, *tail_work(BATCH, RES // 14 * 4, RES // 14 * 4, 128, RES, RES),
          device_ms=a["device_ms"], device_split=a["device_split"], shapes=tail_rows)
    # kernel 10, the v1 tail (same function and contract), is served by kernel 2
    tail_v1 = {**kernels[-1], "name": "dpt_tail_v1",
               "replaces": "distill_any_depth_tpu/ops/dpt_tail.py:529",
               "served_by": "kernel 2 (dpt_tail.cu) through ops/dpt_tail.fused_dpt_tail"}

    # kernel 3 at the student's training shape
    b, h = TRAIN_BATCH, 12
    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = _forward(qkv, h, with_lse=True)
    xr = qkv.clone().requires_grad_()
    out_ref = mha_packed_reference(xr, h)
    plain = cuda_ms(lambda: torch.autograd.grad(out_ref, xr, g, retain_graph=True), iters=5)
    q, k, v = (x.detach().contiguous().requires_grad_()
               for x in qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
    go = g.view(b, n, h, d).transpose(1, 2).contiguous()
    def sdpa_fb():
        return torch.autograd.grad(F.scaled_dot_product_attention(q, k, v), (q, k, v), go)

    sdpa_fb_ms = cuda_ms(sdpa_fb, iters=50)
    fb_dev, fb_kernels = device_ms(sdpa_fb)
    with torch.no_grad():
        sdpa_f_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
        f_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))[0]
    entry("packed_attention_bwd", "attention_bwd", "flash_attention_bwd.cu",
          "ops/flash_attention.py:731", errs["attention_bwd"],
          cuda_ms(lambda: packed_attention_backward(qkv, out, lse, g, h), iters=50), plain,
          sdpa_fb_ms - sdpa_f_ms, 10.0 * b * h * n * n * d, (3 * c + c + c + 3 * c) * b * n * 2,
          launches=train_counts["attention_bwd"],
          device_ms=device_ms(lambda: packed_attention_backward(qkv, out, lse, g, h))[0],
          library_device_ms=fb_dev - f_dev, library_kernels=fb_kernels,
          library_note="SDPA forward + backward less forward (events and device times)")

    # kernel 4 at the HDN loss's shapes: both of a step's launches select
    # from [112, N] rows (the SSI alignment's medians of the student's and
    # the teacher's depth over the 7 HDN contexts x 16 images), N = 392^2 on
    # paths 2 and the int8 teacher, 1036^2 on path 4's large cell
    select_rows = []
    for n in (RES * RES, WINDOW_RES[1] ** 2):
        u, kk = select_inputs(gen, n)
        wide = u.to(torch.int64) & 0xFFFFFFFF
        nbytes = u.numel() * 4 + kk.numel() * 4 + u.shape[0] * 4
        row = dict(R=u.shape[0], N=n, ms=cuda_ms(lambda: kth_select(u, kk), iters=50),
                   device_ms=device_ms(lambda: kth_select(u, kk))[0],
                   library_ms=cuda_ms(lambda: torch.kthvalue(wide, n // 2, dim=-1), iters=5),
                   library_device_ms=device_ms(lambda: torch.kthvalue(wide, n // 2, dim=-1),
                                               5)[0],
                   bound_ms=bound(0.0, nbytes)[0])
        if n == RES * RES:
            row["plain_ms"] = cuda_ms(lambda: kth_select_reference(u, kk), iters=5)
        log(f"[timing] kernel 4 [{u.shape[0]}, {n}]: {json.dumps(row)}")
        select_rows.append(row)
        del u, kk, wide
        torch.cuda.empty_cache()
    a = select_rows[0]
    entry("kth_select", "select", "kth_select.cu", "ops/stats.py:131", errs["select"], a["ms"],
          a["plain_ms"], a["library_ms"], 0.0, HDN_ROWS * RES * RES * 4 + HDN_ROWS * 8,
          launches=train_counts["select"], device_ms=a["device_ms"],
          library_device_ms=a["library_device_ms"], shapes=select_rows,
          library_note="torch.kthvalue over int64 order bits, one k for every row: the "
                       "value, not the first index")

    # kernels 5 and 7 at the windowed teacher's bs8 shapes (518^2 with the
    # window bias, 1036^2 banded) and at the windowed student's bs16 with the
    # log-sum-exp, as path 4 runs them: CUDA events and the profiler's device
    # time by kernel (the bias kernel's first pass apart), beside SDPA with
    # the additive mask (events and device time). The bound counts the
    # products of the live (query, key) pairs, which this run's window mask
    # sets; "dense_gflop" and "band_gflop" are what the kernels' loops could
    # visit.
    h = 12
    c = h * d
    for key, res in zip(("attention_bias", "attention_banded"), WINDOW_RES):
        g = res // 14
        n, band = g * g, (g, 7)
        wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
        live = int(torch.isfinite(wb).sum())
        rows = {}
        for b, with_lse in ((BATCH, False), (WINDOW_TRAIN_BATCH[res], True)):
            q, k, v = masked_inputs(b, n, h, bf16, gen)
            if key == "attention_bias":
                def fwd():
                    return _bias_forward(q, k, v, wb, with_lse)
            else:
                def fwd():
                    return _banded_forward(q, k, v, band, with_lse)
            sd = [x.transpose(1, 2).contiguous() for x in (q, k, v)]

            def sdpa():
                return F.scaled_dot_product_attention(*sd, attn_mask=wb)

            lib_dev, lib_kernels = device_ms(sdpa)
            nbytes = 4 * b * n * c * 2 + (b * h * n * 4 if with_lse else 0)
            if key == "attention_bias":
                nbytes += wb.numel() * 2
            split = device_split(fwd)
            rows[b] = dict(B=b, N=n, H=h, res=res, with_lse=with_lse,
                           ms=cuda_ms(fwd, iters=50), device_ms=sum(split.values()),
                           device_split=split, library_ms=cuda_ms(sdpa, iters=20),
                           library_device_ms=lib_dev, library_kernels=lib_kernels,
                           bound_ms=bound(4.0 * b * h * d * live, nbytes)[0])
            log(f"[timing] kernel {5 if key == 'attention_bias' else 7} {res}^2 bs{b}: "
                f"{json.dumps(rows[b])}")
            if b == BATCH:
                plain = cuda_ms((lambda: mha_bias_reference(q, k, v, wb))
                                if key == "attention_bias"
                                else (lambda: mha_banded_reference(q, k, v, band)), iters=5)
            del q, k, v, sd
        a = rows[BATCH]
        extra = dict(device_ms=a["device_ms"], device_split=a["device_split"],
                     library_device_ms=a["library_device_ms"],
                     library_kernels=a["library_kernels"],
                     train_shape=rows[WINDOW_TRAIN_BATCH[res]],
                     shape={"B": BATCH, "N": n, "H": h, "res": res},
                     library_note="SDPA with the additive window mask")
        if key == "attention_bias":
            entry("bias_attention_fwd", key, "flash_attention_bias.cu",
                  "ops/flash_attention.py:410", errs[key], a["ms"], plain, a["library_ms"],
                  4.0 * BATCH * h * d * live, 4 * BATCH * n * c * 2 + wb.numel() * 2,
                  launches=wcounts[res][key], dense_gflop=4.0 * BATCH * h * d * n * n / 1e9,
                  **extra)
        else:
            entry("banded_attention_fwd", key, "flash_attention_banded.cu",
                  "ops/flash_attention.py:330", errs[key], a["ms"], plain, a["library_ms"],
                  4.0 * BATCH * h * d * live, 4 * BATCH * n * c * 2,
                  launches=wcounts[res][key], band_gflop=4.0 * BATCH * h * d * n * 7 * g / 1e9,
                  **extra)
        del wb
        torch.cuda.empty_cache()

    # kernels 6 and 8 at the windowed student's bs16 training shapes, from
    # kernel 5's and 7's out, lse (and tile marks); the library yardstick is
    # SDPA with the additive mask, forward + backward less forward
    for key, res in zip(("attention_bias_bwd", "attention_banded_bwd"), WINDOW_RES):
        g, b = res // 14, WINDOW_TRAIN_BATCH[res]
        n, band = g * g, (g, 7)
        q, k, v = masked_inputs(b, n, h, bf16, gen)
        go = torch.randn(b, n, h, d, generator=gen, device="cuda").to(bf16)
        wb = local_window_bias(g, g, 7, 0, "cuda", bf16)
        live = int(torch.isfinite(wb).sum())
        sd = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
        gsd = go.transpose(1, 2).contiguous()
        fb = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*sd, attn_mask=wb),
                                                 sd, gsd), iters=5)
        with torch.no_grad():
            lib = fb - cuda_ms(lambda: F.scaled_dot_product_attention(*sd, attn_mask=wb), iters=5)
        nbytes = 8 * b * n * c * 2
        shape = {"B": b, "N": n, "H": h, "res": res}
        if key == "attention_bias_bwd":
            out, lse, marks, terms = _bias_forward(q, k, v, wb, with_lse=True)
            entry("bias_attention_bwd", key, "flash_attention_bias_bwd.cu",
                  "ops/flash_attention.py:973", errs[key],
                  cuda_ms(lambda: bias_attention_backward(q, k, v, wb, out, lse, go, marks,
                                                          terms)),
                  cuda_ms(lambda: bias_attention_backward_reference(q, k, v, wb, out, lse, go),
                          iters=3),
                  lib, 10.0 * b * h * d * live, nbytes + wb.numel() * 2,
                  launches=wtrain[res]["counts"][key], shape=shape,
                  dense_gflop=10.0 * b * h * d * n * n / 1e9,
                  device_split=device_split(
                      lambda: bias_attention_backward(q, k, v, wb, out, lse, go, marks, terms),
                      5))
        else:
            out, lse = _banded_forward(q, k, v, band, with_lse=True)
            entry("banded_attention_bwd", key, "flash_attention_banded_bwd.cu",
                  "ops/flash_attention.py:1188", errs[key],
                  cuda_ms(lambda: banded_attention_backward(q, k, v, band, out, lse, go)),
                  cuda_ms(lambda: banded_attention_backward_reference(q, k, v, band, out, lse,
                                                                      go), iters=3),
                  lib, 10.0 * b * h * d * live, nbytes,
                  launches=wtrain[res]["counts"][key], shape=shape,
                  band_gflop=10.0 * b * h * d * n * 7 * g / 1e9,
                  device_split=device_split(
                      lambda: banded_attention_backward(q, k, v, band, out, lse, go), 5))
        del q, k, v, go, sd, gsd, wb, out, lse
        torch.cuda.empty_cache()
    # kernel 9 at every encoder GEMM of paths 5 and 1 and of the int8 teacher
    # (bf16, with bias), beside
    # its plain version, the int8 route (row quant + torch._int_mm + dequant;
    # the library yardstick), torch._int_mm alone and bf16 F.linear
    shapes = []
    for label, (m, gemms) in W8A8_SHAPES.items():
        for gemm, (k, n) in zip(GEMMS, gemms):
            x, w, b = w8a8_inputs(m, k, n, bf16, gen)
            q = quantize_weight(w)
            xq = quantize_rows(x)[0]
            w16, b16 = w.to(bf16), b.to(bf16)
            ops, nbytes = 2.0 * m * k * n, m * k * 2 + n * k + n * 8 + m * n * 2
            b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
            shapes.append({
                "shape": label, "gemm": gemm, "M": m, "K": k, "N": n,
                "ms": cuda_ms(lambda: w8a8_matmul(x, w, b, quantized=q), iters=20),
                "plain_ms": cuda_ms(lambda: w8a8_reference(x, *q, b, bf16), iters=3),
                "int8_route_ms": cuda_ms(lambda: int8_matmul(x, w, b, quantized=q), iters=20),
                "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, q[0].t()), iters=20),
                "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w16, b16), iters=20),
                "bound_ms": b_ms, "bound_by": b_by,
                # the quantize pass and the GEMM apart, by the profiler's device time
                "device_split": device_split(lambda: w8a8_matmul(x, w, b, quantized=q), 10)})
            log(f"[timing] w8a8 {label} {gemm}: {json.dumps(shapes[-1])}")
            del x, w, b, q, xq, w16, b16
    qkv = shapes[0]
    entry("w8a8_matmul", "w8a8", "w8a8_matmul.cu", "ops/quant_matmul.py:75", errs["w8a8"],
          qkv["ms"], qkv["plain_ms"], qkv["int8_route_ms"], 2.0 * qkv["M"] * qkv["K"] * qkv["N"],
          qkv["M"] * qkv["K"] * 2 + qkv["N"] * qkv["K"] + qkv["N"] * 8 + qkv["M"] * qkv["N"] * 2,
          launches=qcounts["w8a8"], rate=PEAK_INT8_OPS, shape="ViT-L 518^2 bs8 qkv",
          shapes=shapes, launches_per_forward=4 * qmodel.cfg.encoder.depth,
          library_note="the int8 route (ops/quant.int8_matmul): a row-quant pass, "
                       "torch._int_mm (cuBLASLt int8) and the dequant; bf16_linear_ms per shape")
    kernels.append(tail_v1)
    for kd in kernels:
        log(f"[timing] {kd['name']}: kernel {kd['ms']:.4f} ms, plain {kd['plain_ms']:.4f} ms, "
            f"library {kd['library_ms']}, bound {kd['bound_ms']:.4f} ms ({kd['bound_by']}), "
            f"launches {kd['launches_by_path']}")

    # end to end, path 1: the bs8 forward alone, and predict() with preprocessing
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

    # end to end, path 2: the bs16 train step on a device-resident batch
    xs = torch.from_numpy(train_images(TRAIN_BATCH, seed=3)).cuda().permute(0, 3, 1, 2)
    torch.cuda.reset_peak_memory_stats()
    step_windows = [cuda_ms(lambda: trainer.train_step(trainer.state, 0, xs, xs), iters=3,
                            warmup=1) for _ in range(3)]
    step_ms = statistics.median(step_windows)
    train = {"student": ARCH, "teacher": TEACHER, "res": RES, "batch": TRAIN_BATCH,
             "dtype": "bfloat16", "step_ms": step_ms, "step_ms_windows": step_windows,
             "steps_per_s": 1e3 / step_ms, "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    # end to end, path 3: the windowed teacher's bs8 forward at both sizes,
    # predict(), and its PEG conv alone
    window = {}
    for res in WINDOW_RES:
        g = res // 14
        x = preprocess_on_device(raw, res, dtype=wmodel.dtype)
        tokens = torch.randn(BATCH, g * g, 768, generator=gen, device="cuda").to(bf16)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            windows = [cuda_ms(lambda: wmodel(x), iters=5) for _ in range(5)]
            peg = cuda_ms(lambda: wmodel.pretrained.pos_conv(tokens, g, g), iters=10)
        t0 = time.perf_counter()
        for _ in range(3):
            predict(wmodel, images[:BATCH], res, batch_size=BATCH)
        fwd = statistics.median(windows)
        window[res] = {"arch": WINDOW_ARCH, "res": res, "batch": BATCH, "dtype": "bfloat16",
                       "forward_ms": fwd, "forward_ms_windows": windows,
                       "forward_images_per_s": BATCH / fwd * 1e3,
                       "predict_images_per_s": BATCH * 3 / (time.perf_counter() - t0),
                       "peg_conv_ms": peg,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[timing] {WINDOW_ARCH} {res}^2 bs{BATCH}: forward {fwd:.3f} ms "
            f"({BATCH / fwd * 1e3:.1f} img/s), PEG conv {peg:.3f} ms")
    window_train = {res: {"student": WINDOW_ARCH, "teacher": TEACHER, "res": res,
                          "dtype": "bfloat16",
                          **{k: v for k, v in wtrain[res].items() if k != "counts"}}
                    for res in WINDOW_RES}

    # end to end, path 5: the ViT-L 518^2 bs8 forward with each quant mode,
    # and label_batches (preprocessing, the forward, the copy to the host)
    from distill_any_depth_tpu_torch.cli.pseudo_label import label_batches

    x = preprocess_on_device(torch.from_numpy(qims[:QUANT_BATCH]).cuda(), QUANT_RES, dtype=bf16)
    qint8 = create_model(QUANT_ARCH, dtype=bf16, device="cuda", seed=0, quant="int8")
    pseudo = {"arch": QUANT_ARCH, "res": QUANT_RES, "batch": QUANT_BATCH, "dtype": "bfloat16"}
    with torch.no_grad():
        for mode, m in (("none", qplain), ("int8", qint8), ("int8_pallas", qmodel)):
            windows = [cuda_ms(lambda: m(x), iters=3) for _ in range(5)]
            pseudo[f"forward_ms_{mode}"] = statistics.median(windows)
            pseudo[f"forward_ms_windows_{mode}"] = windows
            log(f"[timing] {QUANT_ARCH} {QUANT_RES}^2 bs{QUANT_BATCH} forward, quant {mode}: "
                f"{pseudo[f'forward_ms_{mode}']:.3f} ms (windows {windows})")
    del qint8
    t0 = time.perf_counter()
    for _ in range(3):
        label_batches(qmodel, qims[:QUANT_BATCH], QUANT_RES, QUANT_BATCH)
    pseudo["label_batches_images_per_s_int8_pallas"] = 3 * QUANT_BATCH / (time.perf_counter() - t0)
    pseudo["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # end to end, path 2 with the int8_pallas teacher
    xs = torch.from_numpy(train_images(TRAIN_BATCH, seed=3)).cuda().permute(0, 3, 1, 2)
    torch.cuda.reset_peak_memory_stats()
    step_windows = [cuda_ms(lambda: qtrainer.train_step(qtrainer.state, 0, xs, xs), iters=3,
                            warmup=1) for _ in range(3)]
    step_ms = statistics.median(step_windows)
    int8_train = {"student": ARCH, "teacher": TEACHER, "teacher_quant": "int8_pallas",
                  "res": RES, "batch": TRAIN_BATCH, "dtype": "bfloat16", "step_ms": step_ms,
                  "step_ms_windows": step_windows, "steps_per_s": 1e3 / step_ms,
                  "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[timing] int8_pallas teacher step {step_ms:.1f} ms (windows {step_windows}); bf16 "
        f"teacher step {train['step_ms']:.1f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"end_to_end": e2e, "train_step": train, "window": window,
                      "window_train": window_train, "pseudo_label": pseudo,
                      "int8_teacher_train_step": int8_train}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a card")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    # fp32 comparisons on the card in full fp32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    phase_build()
    errs = {"attention": phase_attention(gen), "attention_bwd": phase_attention_grad(gen),
            "tail": phase_tail(gen), "select": phase_select(gen)}
    errs["attention_bias"], errs["attention_banded"] = phase_window_attention(gen)
    errs["attention_bias_bwd"], errs["attention_banded_bwd"] = phase_window_grad(gen)
    errs["w8a8"] = phase_w8a8(gen)
    model = create_model(ARCH, dtype=torch.bfloat16, device="cuda", seed=0)
    images = synthetic_images(BATCH)
    counts = phase_main_path(model, images)
    trainer, train_counts = phase_train()
    phase_train_vs_cpu()
    wmodel, wcounts = phase_window_path(images)
    wtrain = phase_window_train()
    phase_window_train_vs_cpu()
    qmodel, qplain, qcounts, qims = phase_pseudo_label()
    qtrainer, qtrain_counts = phase_train("int8_pallas")
    evals = phase_checkpoints_and_eval(trainer, qplain)
    phase_timing(model, images, counts, errs, trainer, train_counts, wmodel, wcounts, wtrain,
                 qmodel, qplain, qcounts, qims, qtrainer, qtrain_counts, evals, gen)
    log(f"[smoke] all phases passed in {time.time() - t0:.1f} s")
    print(gpu_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
