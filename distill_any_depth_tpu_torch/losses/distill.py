"""The five-component distillation loss.

Counterpart of distill_any_depth_tpu/losses/distill.py: SC loss (student
local against teacher), LG loss (student global against student local),
feature cosine, Sobel gradient preservation of the student's local depth,
and HDN between student and teacher with contexts from the teacher depth.
Everything runs in the dtype of its inputs (fp32 in the train step).
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.configs import LossConfig
from distill_any_depth_tpu_torch.losses.feature import feature_distillation_loss
from distill_any_depth_tpu_torch.losses.gradient import gradient_preservation_loss
from distill_any_depth_tpu_torch.losses.hdn import (
    get_contexts_dp,
    get_contexts_dr,
    get_contexts_ds,
    hdn_loss,
)
from distill_any_depth_tpu_torch.losses.normalization import normalize_depth

__all__ = ["distillation_loss", "combined_distillation_loss"]


def distillation_loss(student_depth: torch.Tensor, teacher_depth: torch.Tensor,
                      norm_strategy: str, num_segments: int = 4) -> torch.Tensor:
    """L1 of the normalized depth maps."""
    if norm_strategy != "none":
        student_depth = normalize_depth(student_depth, norm_strategy, num_segments)
        teacher_depth = normalize_depth(teacher_depth, norm_strategy, num_segments)
    return (student_depth - teacher_depth).abs().mean()


def _contexts(cfg: LossConfig, gt: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if cfg.hdn_variant == "dr":
        return get_contexts_dr(cfg.hdn_level, gt, mask)
    if mask is None:
        mask = torch.ones_like(gt, dtype=torch.bool)
    if cfg.hdn_variant == "dp":
        return get_contexts_dp(cfg.hdn_level, gt, mask)
    if cfg.hdn_variant == "ds":
        return get_contexts_ds(cfg.hdn_level, mask)
    raise ValueError(f"unknown HDN variant {cfg.hdn_variant!r}")


def combined_distillation_loss(
    cfg: LossConfig,
    student_global_depth: torch.Tensor,
    student_local_depth: torch.Tensor,
    student_local_feat: torch.Tensor,
    teacher_local_depth: torch.Tensor,
    teacher_local_feat: torch.Tensor | None = None,
    valid_mask: torch.Tensor | None = None,
    feat_loss: torch.Tensor | None = None,
    data_group=None,
    weights: dict | None = None,
):
    """The whole stack; returns ``(total, components)``. Pass either
    ``teacher_local_feat`` or a precomputed ``feat_loss``. ``data_group``:
    this batch is a data rank's share, and HDN's normalizer counts the
    global batch (``losses/hdn``); every other term is a mean over images,
    whose mean over the ranks is the global one. ``weights`` overrides the
    ``lambda_*`` of ``cfg`` by key (``sc``, ``lg``, ``feat``, ``grad``,
    ``hdn``; numbers or 0-dim tensors), as the JAX package's does for the
    loss-weight tuner (``train/tuner``)."""
    w = weights or {}
    sc = distillation_loss(student_local_depth, teacher_local_depth, cfg.normalization,
                           cfg.num_segments)
    lg = distillation_loss(student_global_depth, student_local_depth, cfg.normalization,
                           cfg.num_segments)
    feat = (feat_loss if feat_loss is not None
            else feature_distillation_loss(student_local_feat, teacher_local_feat))
    grad = gradient_preservation_loss(student_local_depth)
    components = {"sc": sc, "lg": lg, "feat": feat, "grad": grad}
    total = (w.get("sc", cfg.lambda_sc) * sc + w.get("lg", cfg.lambda_lg) * lg
             + w.get("feat", cfg.lambda_feat) * feat + w.get("grad", cfg.lambda_grad) * grad)
    if cfg.use_hdn:
        contexts = _contexts(cfg, teacher_local_depth, valid_mask)
        hdn = hdn_loss(student_local_depth, teacher_local_depth, contexts,
                       data_group=data_group)
        components["hdn"] = hdn
        total = total + w.get("hdn", cfg.lambda_hdn) * hdn
    components["total"] = total
    return total, components
