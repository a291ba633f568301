"""The plain float32 distillation step: loss stack and clipped Adam.

Written from the Distill-Any-Depth definitions (arXiv 2502.19204, the
reference implementation's ``tools/train_distillation.py`` as its
configuration sets it): scale-and-shift-invariant L1 of hybrid-normalized
depths for the student-teacher (SC) and global-local (LG) terms, the
cosine feature loss over the token axis (the larger channel axis
nearest-resized to the smaller), the Sobel gradient-preservation term, and
HDN over seven depth-range contexts with a median alignment in each. The
median of a row is its lower median, read at the first index that holds it,
so its gradient is one element per row. The update is Adam with L2 decay
after one global-norm clip, and the cosine learning-rate schedule.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import reference

__all__ = ["check_train", "loss_stack", "train_steps"]

# the program's TrainConfig values this step computes, where they differ from
# what it reads: one frozen teacher in float, every student parameter
# trained, one process
REQUIRES = {"teacher_quant": "none", "adapter_only": False, "dp": 1, "tp": 1}
LOSS = {"normalization": "hybrid", "hdn_variant": "dr"}
OPTIMIZER = {"schedule": "cosine", "warmup_steps": 0}


def check_train(train: dict) -> None:
    """Refuse a configuration's ``train`` entry (the program's TrainConfig)
    that asks for what this step does not compute."""
    wrong = {k: train[k] for k, v in REQUIRES.items() if k in train and train[k] != v}
    wrong.update({k: train["loss"][k] for k, v in LOSS.items() if train["loss"][k] != v})
    wrong.update({k: train["optimizer"][k] for k, v in OPTIMIZER.items()
                  if train["optimizer"][k] != v})
    if wrong:
        raise ValueError(f"the reference step does not compute {wrong}")

def _lower_median(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Lower median of ``x[mask]`` along the last axis, read at the first
    index holding it (0 where no entry is valid)."""
    if mask is None:
        mask = torch.ones_like(x, dtype=torch.bool)
    count = mask.sum(-1)
    keyed = torch.where(mask, x.detach(), torch.inf)
    k = ((count - 1).clamp(min=0) // 2)[..., None]
    value = keyed.sort(dim=-1).values.gather(-1, k)
    idx = ((keyed == value) & mask).to(torch.uint8).argmax(-1, keepdim=True)
    return torch.where(count > 0, x.gather(-1, idx)[..., 0], 0.0)


def _hybrid_normalize(depth: torch.Tensor, segments: int) -> torch.Tensor:
    """Per depth-range segment: (d - masked mean) / (masked mean |d - mean|);
    segment edges are inclusive, a later segment overwrites a shared pixel."""
    flat = depth.reshape(depth.shape[0], -1)
    dmin = flat.amin(-1)[:, None, None]
    drange = flat.amax(-1)[:, None, None] - dmin
    out = torch.zeros_like(depth)
    for i in range(segments):
        mask = (depth >= dmin + i / segments * drange) & (depth <= dmin + (i + 1) / segments
                                                          * drange)
        m = mask.float()
        seg = torch.where(mask, depth, 0.0)
        cnt = m.sum((1, 2), keepdim=True)
        mean = seg.sum((1, 2), keepdim=True) / (cnt + 1e-6)
        mad = ((seg - mean).abs() * m).sum((1, 2), keepdim=True) / (cnt + 1e-6)
        out = torch.where(mask, (seg - mean) / (mad + 1e-6), out)
    return out


def _feature_loss(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if s.shape[2] != t.shape[2]:
        c = min(s.shape[2], t.shape[2])

        def nearest(x):
            n = x.shape[2]
            src = torch.floor(torch.arange(c, dtype=torch.float64) * (n / c)).long()
            return x[..., src.clamp(max=n - 1).to(x.device)]

        s, t = nearest(s), nearest(t)
    sn = s / s.norm(dim=1, keepdim=True).clamp(min=1e-12)
    tn = t / t.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return 1.0 - (sn * tn).sum(1).mean()


def _gradient_loss(d: torch.Tensor) -> torch.Tensor:
    p = F.pad(d, (1, 1, 1, 1))
    sobel_x = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                           device=d.device)
    gx = F.conv2d(p[:, None], sobel_x[None, None])[:, 0]
    gy = F.conv2d(p[:, None], sobel_x.t()[None, None])[:, 0]
    return torch.exp(-torch.sqrt(gx * gx + gy * gy + 1e-6)).mean()


def _dr_contexts(gt: torch.Tensor, level: int) -> torch.Tensor:
    b = gt.shape[0]
    dmin = gt.reshape(b, -1).amin(-1)[:, None, None]
    rng = gt.reshape(b, -1).amax(-1)[:, None, None] - dmin
    ctxs = []
    for size in [0.5 ** i for i in reversed(range(level))]:
        for i in range(int(1 / size)):
            lo, hi = dmin + rng * (i * size), dmin + rng * ((i + 1) * size) + 1e-30
            ctxs.append((gt >= lo) & (gt < hi))
    return torch.stack(ctxs)


def _align(d: torch.Tensor, mask: torch.Tensor, count1: torch.Tensor) -> torch.Tensor:
    lead = d.shape[:-2]
    t = _lower_median(d.reshape(*lead, -1), mask.reshape(*lead, -1))[..., None, None]
    s = torch.where(mask, (d - t).abs(), 0.0).sum((-2, -1), keepdim=True) / count1
    return (d - t) / (s + 1e-6)


def _hdn(pred: torch.Tensor, gt: torch.Tensor, level: int) -> torch.Tensor:
    ctx = _dr_contexts(gt, level)
    k, b = ctx.shape[:2]
    rows = ctx.reshape(k * b, *gt.shape[1:])
    p = pred[None].expand(ctx.shape).reshape(rows.shape)
    g = gt[None].expand(ctx.shape).reshape(rows.shape)
    count1 = rows.sum((-2, -1), keepdim=True).float() + 1.0
    dense = torch.where(rows, (_align(p, rows, count1) - _align(g, rows, count1)).abs(), 0.0)
    dense = dense.reshape(ctx.shape)
    times = ctx.sum(0)
    total = dense.sum(0)
    per_pixel = torch.where(times > 0, total / times.clamp(min=1), total)
    return per_pixel.sum() / ((times > 0).sum() + 1e-6)


def loss_stack(loss: dict, s_global, s_local, s_feat, t_depth, t_feat) -> dict:
    """The components and their weighted ``total`` (the configuration's
    ``loss`` entry: weights, segments, HDN level)."""
    seg = loss["num_segments"]

    def l1(a, b):
        return (_hybrid_normalize(a, seg) - _hybrid_normalize(b, seg)).abs().mean()

    c = {"sc": l1(s_local, t_depth), "lg": l1(s_global, s_local),
         "feat": _feature_loss(s_feat, t_feat), "grad": _gradient_loss(s_local),
         "hdn": _hdn(s_local, t_depth, loss["hdn_level"])}
    c["total"] = sum(loss[f"lambda_{k}"] * c[k] for k in ("sc", "lg", "feat", "grad", "hdn"))
    return c


def _lr(opt: dict, count: int) -> float:
    frac = min(count, opt["total_steps"]) / opt["total_steps"]
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return opt["lr"] * ((1.0 - opt["eta_min_ratio"]) * cosine + opt["eta_min_ratio"])


def train_steps(student: dict, teacher: dict, cfg: dict, batches, quant: str | None = None,
                keep_grad0: bool = False) -> dict:
    """Run ``len(batches)`` distillation steps from the weights ``student``
    (updated in place) under the frozen ``teacher``. ``batches`` are NHWC
    float32 images, normalized, one view for both the global and the local
    terms; ``cfg`` is the configuration (its ``student`` and ``teacher``
    model entries, ``train``'s ``loss``, ``optimizer`` and ``teacher_chunk``,
    and ``adam``). Returns each step's components, the per-parameter norm of
    the first step's gradient before the clip (``grad0``, and the tensors,
    ``grad0_tensors``) and as the optimizer took it, clipped and with the
    decay added (``taken0``; with ``keep_grad0``, also the tensors,
    ``taken0_tensors``)."""
    train, adam = cfg["train"], cfg["adam"]
    opt = train["optimizer"]
    b1, b2, eps, wd = adam["beta1"], adam["beta2"], adam["eps"], opt["weight_decay"]
    s_forward = reference.module(cfg["student"]["reference"]).depth_forward
    t_forward = reference.module(cfg["teacher"]["reference"]).depth_forward
    names = list(student)
    for n in names:
        student[n].requires_grad_(True)
    m = {n: torch.zeros_like(student[n]) for n in names}
    v = {n: torch.zeros_like(student[n]) for n in names}
    out = {"losses": []}
    for step, batch in enumerate(batches):
        x = torch.as_tensor(batch).to(student[names[0]].device).permute(0, 3, 1, 2)
        with torch.no_grad():
            chunk = train["teacher_chunk"] or x.shape[0]
            parts = [t_forward(teacher, cfg["teacher"], x[i:i + chunk], quant)
                     for i in range(0, x.shape[0], chunk)]
            t_depth = torch.cat([p[0] for p in parts])
            t_feat = torch.cat([p[1] for p in parts])
        s_depth, s_feat = s_forward(student, cfg["student"], x, quant)
        comps = loss_stack(train["loss"], s_depth, s_depth, s_feat, t_depth, t_feat)
        grads = torch.autograd.grad(comps["total"], [student[n] for n in names])
        out["losses"].append({k: float(c.detach()) for k, c in comps.items()})
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if not torch.isfinite(norm):
            raise FloatingPointError(f"reference step {step}: gradient norm {float(norm)}")
        clip = opt["max_grad_norm"] / max(float(norm), opt["max_grad_norm"])
        lr = _lr(opt, step)
        with torch.no_grad():
            if step == 0:
                out["grad0"] = {n: float(g.norm()) for n, g in zip(names, grads)}
                out["grad0_tensors"] = dict(zip(names, grads))
            taken = {}
            for n, g in zip(names, grads):
                g = g * clip + wd * student[n]
                taken[n] = g
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** (step + 1))).add_(eps)
                student[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (step + 1)))
            if step == 0:
                out["taken0"] = {n: float(t.norm()) for n, t in taken.items()}
                if keep_grad0:
                    out["taken0_tensors"] = taken
    return out
