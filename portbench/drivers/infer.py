"""``cli/infer.predict(model, images, res, batch_size)`` in a closed loop,
one call after another, each on ``batch_size`` host uint8 images drawn from
a pool made from the seed.

The window keeps a sample of its calls, drawn from the seed; after it the
reference preprocesses the same uint8 images itself and recomputes their
depth. ``compare`` gives the worst image's ``depth_gap``
(``||d - d_ref|| / ||d_ref||``) and ``depth_affine_gap`` (the residual after
the best affine fit to the reference, over its variation).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, harness, inputs, tracing
from portbench.reference import module as reference_module
from portbench.reference.images import preprocess

__all__ = ["CONFIG_KEYS", "run", "reference_depths", "reference", "compare"]

CONFIG_KEYS = ("model", "create")


def _image_pool(tr: dict, seed: int, device) -> list[np.ndarray]:
    gen = inputs.generator(seed, "images", device)
    sizes = [tuple(s) for s in tr["sizes"]]
    per = [tr["pool"] // len(sizes) + (i < tr["pool"] % len(sizes)) for i in range(len(sizes))]
    pool = []
    for hw, n in zip(sizes, per):
        pool += list(inputs.synthetic_images(gen, n, hw, device).cpu().numpy())
    return pool


def _call_order(tr: dict, seed: int):
    """Index lists of the calls: the pool in a seeded order, taken
    ``batch_size`` at a time, reshuffled at each pass."""
    rng = inputs.rng(seed, "order")
    order: list[int] = []
    while True:
        while len(order) < tr["batch_size"]:
            order += list(rng.permutation(tr["pool"]))
        yield order[:tr["batch_size"]]
        order = order[tr["batch_size"]:]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, program):
    from distill_any_depth_tpu_torch.cli.infer import predict

    tr, m = cell.traffic, cell.config["model"]
    res, bs = tr["processing_res"], tr["batch_size"]
    phase = harness.Phases()
    model = harness.build_model(m, cell.config["create"], device, seed, "student")
    phase("program")
    call = predict if program.predict_wrapper is None else program.predict_wrapper(predict)
    pool = _image_pool(tr, seed, device)
    phase("inputs")
    spans = tracing.Spans(trace)
    marks = {}
    if trace:
        model.register_forward_pre_hook(lambda *_: marks.__setitem__("pre", time.time_ns()))
        model.register_forward_hook(lambda *_: marks.__setitem__("post", time.time_ns()))

    def one(idx):
        t0 = time.time_ns()
        out = call(model, [pool[i] for i in idx], res, batch_size=bs)
        t1 = time.time_ns()
        if trace:
            spans.add("predict.preprocess", t0, marks["pre"])
            spans.add("predict.forward", marks["pre"], marks["post"])
            spans.add("predict.readback", marks["post"], t1)
        return out

    # warm-up: every image of the pool once, so each size has run
    for start in range(0, tr["pool"], bs):
        one([i % tr["pool"] for i in range(start, start + bs)])
    harness.sync(device)
    phase("warm_up")
    spans.items.clear()
    ctx = harness.Ctx(cell=cell, setup_s=time.perf_counter() - t_start, spans=spans,
                      phases=phase.seconds)

    order = _call_order(tr, seed)
    sample_rng = inputs.rng(seed, "sample")
    sample: list[tuple[list[int], np.ndarray]] = []
    setup_peak = harness.reset_peak(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        idx = next(order)
        c0 = time.perf_counter()
        out = one(idx)
        c1 = time.perf_counter()
        ctx.latencies_ms.append((c1 - c0) * 1e3)
        ctx.ends_s.append(c1 - t0)
        ctx.units += 1
        ctx.images += len(idx)
        # reservoir sample of the calls, drawn from the seed
        if len(sample) < tr["sample_calls"]:
            sample.append((idx, out))
        else:
            j = int(sample_rng.integers(ctx.units))
            if j < tr["sample_calls"]:
                sample[j] = (idx, out)
        if c1 >= deadline:
            break
    harness.sync(device)
    ctx.window_s = time.perf_counter() - t0
    ctx.peak_window_bytes = harness.peak(device)
    if trace and device.type == "cuda":
        ctx.trace = tracing.profile(lambda k: [one(next(order)) for _ in range(k)],
                                    tr["trace_calls"], spans)
    ctx.peak_bytes = max(setup_peak, harness.peak(device))
    del model
    harness.free(device)
    outcome = {"pool": pool, "images": [i for idx, _ in sample for i in idx],
               "depths": [d for _, out in sample for d in out]}
    return ctx, outcome


def reference_depths(cell, seed: int, pool, images, device, quant: str | None = None) -> list:
    """The reference's depth of each pool image in ``images`` (float32, TF32
    off; with ``quant``, computed in it)."""
    m, res = cell.config["model"], cell.traffic["processing_res"]
    forward = reference_module(m["reference"]).depth_forward
    weights = inputs.make_weights(m, seed, "student", device)
    with check.fp32(), torch.no_grad():
        return [forward(weights, m, preprocess(pool[i], res, device), quant)[0][0]
                for i in images]


def reference(cell, seed: int, outcome: dict, device, quant: str | None = None) -> dict:
    """The same sample worked out by the reference, in ``outcome``'s form."""
    return {"depths": reference_depths(cell, seed, outcome["pool"], outcome["images"], device,
                                       quant)}


def _depth_numbers(d: torch.Tensor, ref: torch.Tensor) -> dict:
    """Gaps of one image's depth ``d`` from the reference's: relative L2,
    and after the best affine fit to the reference (relative to its
    variation, in the fit's scale)."""
    a = torch.stack([ref.flatten(), torch.ones_like(ref.flatten())], 1)
    fit = torch.linalg.lstsq(a, d.flatten()[:, None]).solution
    resid = d.flatten() - (a @ fit)[:, 0]
    return {"depth_gap": float((d - ref).norm() / ref.norm()),
            "depth_affine_gap": float(resid.norm() / (ref - ref.mean()).norm()
                                      / abs(float(fit[0])))}


def compare(outcome: dict, ref: dict) -> dict:
    """The worst image's gaps of ``outcome``'s depths from ``ref``'s."""
    worst: dict[str, float] = {}
    with check.fp32():
        for d, r in zip(outcome["depths"], ref["depths"], strict=True):
            d = (d if isinstance(d, torch.Tensor) else torch.from_numpy(np.asarray(d))).to(
                r.device, torch.float32)
            for k, v in _depth_numbers(d, r).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst
