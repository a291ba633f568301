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
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from distill_any_depth_tpu_torch.configs import LossConfig
from distill_any_depth_tpu_torch.losses.distill import combined_distillation_loss
from distill_any_depth_tpu_torch.losses.feature import feature_distillation_loss
from distill_any_depth_tpu_torch.train.state import TrainState, apply_gradients

__all__ = ["chunked_apply", "make_train_step", "make_eval_loss_fn"]


def chunked_apply(model: Callable, x: torch.Tensor, chunk: int):
    """``model(x)`` as sequential forwards of ``chunk`` images each, when
    ``chunk`` divides a batch larger than it; the outputs are concatenated.
    For forwards without gradient only (the teacher)."""
    b = x.shape[0]
    if not chunk or b <= chunk or b % chunk:
        return model(x)
    outs = [model(x[i:i + chunk]) for i in range(0, b, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _loss_fn(student, teachers: Sequence, loss_cfg: LossConfig, teacher_idx: int,
             global_image: torch.Tensor, local_image: torch.Tensor, views_shared: bool,
             teacher_chunk: int):
    # the loss reductions run in fp32 even for a bf16 student
    s_local_depth, s_local_feat = student(local_image)
    s_local_depth = s_local_depth.float()
    s_local_feat = s_local_feat.float()
    if views_shared:
        # the NYU path: the global view is the local view
        s_global_depth = s_local_depth
    else:
        s_global_depth = student(global_image)[0].float()
    with torch.no_grad():
        t_depth, t_feat = chunked_apply(teachers[teacher_idx], local_image, teacher_chunk)
        t_depth = t_depth.float()
        t_feat = t_feat.float()
    feat_loss = feature_distillation_loss(s_local_feat, t_feat)
    return combined_distillation_loss(loss_cfg, s_global_depth, s_local_depth, s_local_feat,
                                      t_depth, feat_loss=feat_loss)


def make_train_step(student: torch.nn.Module, teachers: Sequence[torch.nn.Module],
                    loss_cfg: LossConfig, views_shared: bool = False,
                    teacher_chunk: int = 0):
    """``step(state, teacher_idx, global_image, local_image) -> metrics``:
    one update of ``state`` (which holds ``student``'s optimizer); images
    are ``[B, 3, H, W]`` on the student's device. ``metrics`` holds the
    loss components, ``grad_norm`` (unclipped, over every parameter's
    gradient, frozen ones included) and ``teacher_idx``."""

    def step(state: TrainState, teacher_idx: int, global_image, local_image) -> dict:
        for p in state.params:
            p.grad = None
        total, components = _loss_fn(student, teachers, loss_cfg, teacher_idx, global_image,
                                     local_image, views_shared, teacher_chunk)
        total.backward()
        norm = apply_gradients(state)
        metrics = {k: v.detach() for k, v in components.items()}
        metrics["grad_norm"] = norm
        metrics["teacher_idx"] = teacher_idx
        return metrics

    return step


def make_eval_loss_fn(student: torch.nn.Module, teachers: Sequence[torch.nn.Module],
                      loss_cfg: LossConfig, views_shared: bool = False,
                      teacher_chunk: int = 0):
    """``eval_loss(teacher_idx, global_image, local_image) -> components``,
    without gradients."""

    @torch.no_grad()
    def eval_loss(teacher_idx: int, global_image, local_image) -> dict:
        _, components = _loss_fn(student, teachers, loss_cfg, teacher_idx, global_image,
                                 local_image, views_shared, teacher_chunk)
        return components

    return eval_loss
