"""The distillation step as ``train/loop.Trainer._epochs`` drives it
(``_views``, ``_teacher_idx``, ``train_step``), fed from host memory
(``source: memory``) or from NYU files through ``data/nyu.NYUDataset`` and
``iterate_batches`` (``source: nyu_files``).

The configuration's ``train`` entry is the program's ``TrainConfig``,
passed whole (its ``loss`` and ``optimizer`` as ``LossConfig`` and
``OptimizerConfig``; the student and the teacher are the model entries'
presets), and ``adam`` holds Adam's betas and eps, which the program's
optimizer must have. Its ``reference`` names the reference step, which
refuses a ``train`` entry that it does not compute.

Set-up builds one ``Trainer`` and hands it to the window. Its first
``check_steps`` steps go through the window's own call and feed, on
distinct rows; after the window the reference follows them from the same
weights and batches (decoding the files itself where the cell reads files).
``compare`` gives ``loss0_gap``, the worst relative gap of a loss component
of the first step; ``change_gap``, the worst parameter's gap between the
program's and the reference's norm of its change over the steps, against
the larger of its reference norm and the median parameter's; and
``change_median_gap``, the median parameter's relative gap. Both change
numbers take the elements that ``kept_elements`` keeps. For files, also
``batch_gap``: the largest difference between the loader's batches and the
reference's decode.
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from portbench import check, harness, inputs, tracing
from portbench.reference import module as reference_module
from portbench.reference.images import decode_nyu

__all__ = ["CONFIG_KEYS", "COMPONENTS", "run", "reference_batches", "reference",
           "kept_elements", "masked_norms", "compare"]

CONFIG_KEYS = ("reference", "student", "teacher", "train", "adam")
COMPONENTS = ("sc", "lg", "feat", "grad", "hdn", "total")


def _train_config(c: dict):
    """The program's ``TrainConfig`` of the configuration ``c``."""
    from distill_any_depth_tpu_torch.configs import (
        LossConfig,
        OptimizerConfig,
        TrainConfig,
        model_config,
    )

    train = dict(c["train"])
    return TrainConfig(student=model_config(c["student"]["preset"]),
                       teachers=(c["teacher"]["preset"],), loss=LossConfig(**train.pop("loss")),
                       optimizer=OptimizerConfig(**train.pop("optimizer")),
                       checkpoint_interval=0, visualize_interval=0, **train)


def _trainer(c: dict, seed: int, device):
    """``train/loop.Trainer`` as its ``__init__`` builds it, with each model
    made on the device without its seeded init and then given the
    benchmark's weights."""
    from distill_any_depth_tpu_torch.train import loop

    reference_module(c["reference"]).check_train(c["train"])
    for role in ("student", "teacher"):
        harness.check_preset(c[role])
    cfg = _train_config(c)
    made = loop.create_model

    def on_device(*args, **kw):
        kw["seed"] = None
        with torch.device(device):
            return made(*args, **kw)

    loop.create_model = on_device
    try:
        trainer = loop.Trainer(cfg, device)
    finally:
        loop.create_model = made
    group = trainer.state.optimizer.param_groups[0]
    adam = c["adam"]
    if (tuple(group["betas"]), group["eps"]) != ((adam["beta1"], adam["beta2"]), adam["eps"]):
        raise ValueError(f"the program's Adam has betas {group['betas']} and eps "
                         f"{group['eps']}, not the configuration's {adam}")
    with torch.no_grad():
        trainer.teachers[0].load_state_dict(
            inputs.make_weights(c["teacher"], seed, "teacher", device), strict=True)
    p0 = inputs.make_weights(c["student"], seed, "student", device)
    trainer.student.load_state_dict(p0, strict=True)
    return trainer, cfg, p0


def _batches(cell, seed: int, seconds: float, device):
    """The step's feed: an endless iterator of batch dicts, and for NYU
    files the set's directory and the order of its pairs."""
    tr, t = cell.traffic, cell.config["train"]
    bs, res = t["batch_size"], t["image_size"]
    if tr["source"] == "memory":
        pool = inputs.memory_batches(seed, tr["pool_batches"], bs, res, device)

        def cycle():
            while True:
                for b in pool:
                    yield {"image": b}

        return cycle(), None, None
    if tr["source"] != "nyu_files":
        raise ValueError(f"no training source {tr['source']!r}")
    from distill_any_depth_tpu_torch.data.nyu import NYUDataset, iterate_batches

    steps = tr["check_steps"] + tr["trace_steps"] + int(np.ceil(tr["max_img_s"] * seconds / bs))
    pairs = (steps + tr["spare_batches"]) * bs
    root = inputs.nyu_files(harness.CACHE, seed, pairs, tuple(tr["file_hw"]), device)
    ds = NYUDataset("train", dataset_dir=root, image_size=res, root_dir=root)
    order = [int(i) for i in inputs.rng(seed, "order").permutation(len(ds))]

    def passes():  # a window longer than the set would repeat it, pass after pass
        while True:
            yield from iterate_batches(ds, bs, shuffle=False, indices=order)

    return passes(), root, order


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, program):
    c, tr = cell.config, cell.traffic
    phase = harness.Phases()
    trainer, cfg, p0 = _trainer(c, seed, device)
    phase("program")
    feed, root, order = _batches(cell, seed, seconds, device)
    phase("inputs")
    spans = tracing.Spans(trace)
    counter = [0]
    step_fn = None

    def step(batch):
        nonlocal step_fn
        if trainer.train_step is None:
            trainer._build_steps("global_image" not in batch)
            step_fn = trainer.train_step
            if program.step_wrapper is not None:
                step_fn = program.step_wrapper(step_fn)
        t0 = time.time_ns()
        g, l = trainer._views(batch)
        t1 = time.time_ns()
        metrics = step_fn(trainer.state, trainer._teacher_idx(cfg.seed, counter[0]), g, l)
        spans.add("step.views", t0, t1)
        spans.add("step.enqueue", t1, time.time_ns())
        counter[0] += 1
        return metrics

    def take():
        t0 = time.time_ns()
        batch = next(feed)
        spans.add("loader.wait", t0, time.time_ns())
        return batch

    # set-up's steps: the window's own call and feed, on distinct rows
    names = [n for n, _ in trainer.student.named_parameters()]
    params = dict(trainer.student.named_parameters())
    b1 = c["adam"]["beta1"]
    outcome = {"losses": [], "batches": [], "root": root, "order": order}
    for k in range(tr["check_steps"]):
        batch = take()
        outcome["batches"].append(batch["image"])
        m = step(batch)
        outcome["losses"].append({n: float(v) for n, v in m.items() if n in COMPONENTS})
        if k == 0:  # the first gradient as the optimizer took it, from Adam's first moment
            state = trainer.state.optimizer.state
            outcome["taken0"] = {n: float(state[params[n]]["exp_avg"].norm()) / (1 - b1)
                                 if params[n] in state else 0.0 for n in names}
            if program.keep_grad0:
                outcome["taken0_tensors"] = {n: state[params[n]]["exp_avg"] / (1 - b1)
                                             for n in names if params[n] in state}
    with torch.no_grad():  # kept on the host until the reference has run
        outcome["change_tensors"] = {n: (params[n] - p0[n]).float().cpu() for n in names}
    del p0
    harness.free(device)
    phase("first_steps")
    spans.items.clear()
    ctx = harness.Ctx(cell=cell, setup_s=time.perf_counter() - t_start, spans=spans,
                      phases=phase.seconds)

    state = trainer.state
    skipped0 = int(state.step) - int(state.applied)
    setup_peak = harness.reset_peak(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        step(take())
        ctx.units += 1
        ctx.images += c["train"]["batch_size"]
        now = time.perf_counter()
        ctx.ends_s.append(now - t0)
        if now >= deadline:
            break
    harness.sync(device)
    ctx.window_s = time.perf_counter() - t0
    ctx.failed = int(state.step) - int(state.applied) - skipped0
    ctx.peak_window_bytes = harness.peak(device)
    if trace and device.type == "cuda":
        # the teacher's forwards as host spans, so the trace can tell the
        # kernels they launch (tracing.Trace.launched_in)
        marks = {}
        teacher = trainer.teachers[0]
        hooks = [teacher.register_forward_pre_hook(
                     lambda *_: marks.__setitem__("pre", time.time_ns())),
                 teacher.register_forward_hook(
                     lambda *_: spans.add("teacher.forward", marks["pre"], time.time_ns()))]
        ctx.trace = tracing.profile(lambda k: [step(take()) for _ in range(k)],
                                    tr["trace_steps"], spans)
        for h in hooks:
            h.remove()
    ctx.peak_bytes = max(setup_peak, harness.peak(device))
    if hasattr(feed, "close"):
        feed.close()  # stops the loader's prefetch thread
    del trainer, feed, step_fn, params, state
    harness.free(device)
    return ctx, outcome


def reference_batches(cell, outcome: dict) -> tuple[list, bool]:
    """The batches the reference steps on: for NYU files its own decode of
    the files, in the order the benchmark gave the loader (and True);
    otherwise the benchmark's own in-memory batches (and False)."""
    if outcome["root"] is None:
        return outcome["batches"], False
    t = cell.config["train"]
    bs, res, root, order = t["batch_size"], t["image_size"], outcome["root"], outcome["order"]
    with open(os.path.join(root, "nyu2_train.csv")) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return [np.stack([decode_nyu(os.path.join(root, rows[i][0]), res)
                      for i in order[k * bs:(k + 1) * bs]])
            for k in range(len(outcome["batches"]))], True


def reference(cell, seed: int, outcome: dict, device, quant: str | None = None,
              keep_grad0: bool = False) -> dict:
    """The reference's steps over the same batches, in ``outcome``'s form
    (``losses``, ``taken0``, ``change_tensors``, ``batches``), with the first
    gradient's norms before the clip (``grad0``), the elements whose change
    is compared (``masks``, ``kept_elements``) and their change's norms
    (``change``); with ``quant``, computed in it."""
    c = cell.config
    batches, decoded = reference_batches(cell, outcome)
    student = inputs.make_weights(c["student"], seed, "student", device)
    start = {n: t.clone() for n, t in student.items()}
    teacher = inputs.make_weights(c["teacher"], seed, "teacher", device)
    with check.fp32():
        out = reference_module(c["reference"]).train_steps(student, teacher, c, batches, quant,
                                                           keep_grad0)
    out["masks"] = kept_elements(out.pop("grad0_tensors"))
    with torch.no_grad():
        out["change_tensors"] = {n: (student[n] - start[n]).cpu() for n in student}
    out["change"] = masked_norms(out["change_tensors"], out["masks"])
    out["batches"] = batches if decoded else None
    return out


def kept_elements(grad0: dict) -> dict:
    """The elements whose change is compared, by parameter: those whose
    reference gradient is at least a thousandth of the median parameter's
    (its norm over the root of its size). The rest move under Adam by
    round-off alone: each element's step is its gradient over the root of
    its mean square, whatever its size, and a gradient that is nought to
    rounding (a key's bias under softmax) points anywhere. A parameter with
    no element kept is left out."""
    rms = {n: float(g.norm()) / g.numel() ** 0.5 for n, g in grad0.items()}
    floor = 1e-3 * statistics.median(rms.values())
    masks = {n: (g.abs() >= floor).cpu() for n, g in grad0.items()}
    return {n: m for n, m in masks.items() if bool(m.any())}


def masked_norms(change: dict, masks: dict) -> dict:
    """The norm of each parameter's change over its kept elements."""
    return {n: float(change[n][m].norm()) for n, m in masks.items()}


def compare(outcome: dict, ref: dict) -> dict:
    """``loss0_gap``, ``change_gap``, ``change_median_gap`` and, where the
    reference decoded files, ``batch_gap`` of ``outcome`` against ``ref``."""
    p, r = outcome["losses"][0], ref["losses"][0]
    prog, refc = masked_norms(outcome["change_tensors"], ref["masks"]), ref["change"]
    median = statistics.median(refc.values())
    numbers = {
        "loss0_gap": max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6) for k in COMPONENTS),
        "change_gap": max(abs(prog[n] - refc[n]) / max(refc[n], median) for n in refc),
        "change_median_gap": statistics.median(abs(prog[n] - refc[n]) / refc[n] for n in refc)}
    if ref["batches"] is not None:
        numbers["batch_gap"] = max(float(np.abs(a - b).max())
                                   for a, b in zip(outcome["batches"], ref["batches"],
                                                   strict=True))
    return numbers
