"""The distillation train step and the validation loss.

Counterpart of distill_any_depth_tpu/train/step.py (``chunked_apply``,
``_loss_fn``, ``make_train_step``, ``make_eval_loss_fn``): the student
forward on the local view (and on the global view unless the views are
shared), the teacher forward without gradient in its own dtype, the loss
stack in fp32, the backward, then clip, guard and Adam
(``train/state.apply_gradients``). Metrics stay on the device.

The JAX step draws the teacher with ``jax.random``; here ``teacher_idx``
is an argument (the Trainer draws it from a seeded ``torch.Generator``;
with one teacher it is 0).

Data parallelism (``data_group``): the step runs on this data rank's rows
of the global batch; after the backward every parameter's gradient is
averaged over the data group in flat fp32 buckets (``all_reduce_gradients``,
frozen parameters too, whose gradients the reported norm reads), HDN's
normalizer counts the global batch (``losses/hdn``), and the loss
components returned are the global ones (their mean over the group), so
every rank clips, guards, updates and reports the same. Under tensor
parallelism the replicated parameters' gradients are averaged over the
model group too. The teacher draw depends on ``(seed, step)`` alone, the
same on every rank.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from distill_any_depth_tpu_torch.configs import LossConfig
from distill_any_depth_tpu_torch.losses.distill import combined_distillation_loss
from distill_any_depth_tpu_torch.losses.feature import feature_distillation_loss
from distill_any_depth_tpu_torch.train.state import TrainState, apply_gradients
from distill_any_depth_tpu_torch.utils.profiling import span

__all__ = ["BUCKET_BYTES", "chunked_apply", "all_reduce_gradients", "mean_over",
           "make_train_step", "make_eval_loss_fn"]

BUCKET_BYTES = 1 << 26  # the gradients reduced by one all_reduce


def chunked_apply(model: Callable, x: torch.Tensor, chunk: int):
    """``model(x)`` as sequential forwards of ``chunk`` images each, when
    ``chunk`` divides a batch larger than it; the outputs are concatenated.
    For forwards without gradient only (the teacher)."""
    b = x.shape[0]
    if not chunk or b <= chunk or b % chunk:
        return model(x)
    outs = [model(x[i:i + chunk]) for i in range(0, b, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Replace each parameter's gradient by its mean over ``group``: flat
    fp32 buckets of up to ``BUCKET_BYTES``, one ``all_reduce`` each. A
    parameter without a gradient gets zeros (JAX differentiates it to 0)."""
    size = dist.get_world_size(group)
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    buckets, nbytes = [[]], 0
    for g in grads:
        if buckets[-1] and nbytes + g.numel() * 4 > BUCKET_BYTES:
            buckets.append([])
            nbytes = 0
        buckets[-1].append(g)
        nbytes += g.numel() * 4
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat, group=group)
        flat /= size
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_over(values: dict, group) -> dict:
    """The mean of each device scalar of ``values`` over ``group``, in one
    ``all_reduce`` (``values`` as they are without a group)."""
    if group is None:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked /= dist.get_world_size(group)
    return dict(zip(keys, stacked.unbind()))


def _loss_fn(student, teachers: Sequence, loss_cfg: LossConfig, teacher_idx: int,
             global_image: torch.Tensor, local_image: torch.Tensor, views_shared: bool,
             teacher_chunk: int, data_group=None, loss_weights=None):
    # the loss reductions run in fp32 even for a bf16 student
    with span("train/student_fwd"):
        s_local_depth, s_local_feat = student(local_image)
        s_local_depth = s_local_depth.float()
        s_local_feat = s_local_feat.float()
    if views_shared:
        # the NYU path: the global view is the local view
        s_global_depth = s_local_depth
    else:
        with span("train/student_fwd"):
            s_global_depth = student(global_image)[0].float()
    with span("train/teacher_fwd"), torch.no_grad():
        t_depth, t_feat = chunked_apply(teachers[teacher_idx], local_image, teacher_chunk)
        t_depth = t_depth.float()
        t_feat = t_feat.float()
    with span("train/loss"):
        feat_loss = feature_distillation_loss(s_local_feat, t_feat)
        return combined_distillation_loss(loss_cfg, s_global_depth, s_local_depth,
                                          s_local_feat, t_depth, feat_loss=feat_loss,
                                          data_group=data_group, weights=loss_weights)


def make_train_step(student: torch.nn.Module, teachers: Sequence[torch.nn.Module],
                    loss_cfg: LossConfig, views_shared: bool = False,
                    teacher_chunk: int = 0, data_group=None):
    """``step(state, teacher_idx, global_image, local_image, loss_weights=None)
    -> metrics``: one update of ``state`` (which holds ``student``'s
    optimizer); images are ``[B, 3, H, W]`` on the student's device (a data
    rank's rows with ``data_group``). ``loss_weights`` overrides the
    ``lambda_*`` of ``loss_cfg`` for this step (keys ``sc``, ``lg``,
    ``feat``, ``grad``, ``hdn``; the loss-weight tuner's sweep). ``metrics``
    holds the loss components, ``grad_norm`` (unclipped, over every
    parameter's gradient, frozen ones included) and ``teacher_idx``.

    Under ``utils/profiling.recording()`` a step is the span ``train/step``
    over ``train/student_fwd``, ``train/teacher_fwd``, ``train/loss``,
    ``train/backward``, ``train/all_reduce`` (over a rank grid),
    ``train/optimizer`` and ``train/metrics``."""

    def step(state: TrainState, teacher_idx: int, global_image, local_image,
             loss_weights=None) -> dict:
        with span("train/step"):
            for p in state.params:
                p.grad = None
            total, components = _loss_fn(student, teachers, loss_cfg, teacher_idx,
                                         global_image, local_image, views_shared,
                                         teacher_chunk, data_group, loss_weights)
            with span("train/backward"):
                total.backward()
            if data_group is not None or state.model_group is not None:
                with span("train/all_reduce"):
                    if data_group is not None:
                        all_reduce_gradients(state.params, data_group)
                    if state.model_group is not None:
                        # the replicated parameters' gradients agree across
                        # the model group only up to the card's
                        # non-deterministic backwards (the head's resize
                        # accumulates with atomics): their mean keeps the
                        # replicas equal, and the clip and guard alike
                        all_reduce_gradients(
                            [p for p in state.params if id(p) not in state.splits],
                            state.model_group)
            with span("train/optimizer"):
                norm = apply_gradients(state)
            with span("train/metrics"):
                metrics = mean_over({k: v.detach() for k, v in components.items()},
                                    data_group)
            metrics["grad_norm"] = norm
            metrics["teacher_idx"] = teacher_idx
            return metrics

    return step


def make_eval_loss_fn(student: torch.nn.Module, teachers: Sequence[torch.nn.Module],
                      loss_cfg: LossConfig, views_shared: bool = False,
                      teacher_chunk: int = 0, data_group=None):
    """``eval_loss(teacher_idx, global_image, local_image, loss_weights=None)
    -> components``, without gradients (the global components with
    ``data_group``; ``loss_weights`` as the step's)."""

    @torch.no_grad()
    def eval_loss(teacher_idx: int, global_image, local_image, loss_weights=None) -> dict:
        _, components = _loss_fn(student, teachers, loss_cfg, teacher_idx, global_image,
                                 local_image, views_shared, teacher_chunk, data_group,
                                 loss_weights)
        return mean_over(components, data_group)

    return eval_loss
