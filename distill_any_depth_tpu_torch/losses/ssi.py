"""Scale-shift-invariant (SSI) alignment and masked L1.

Counterpart of distill_any_depth_tpu/losses/ssi.py. Depth and mask are
``[..., H, W]``; the leading axes are batch axes and every statistic is
taken over the two trailing ones. The median is ``ops/stats.masked_median``
(the select kernel on the card).
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.stats import masked_median

__all__ = ["masked_shift_and_scale", "masked_l1_loss", "ssi_mae_loss"]


def _align(depth: torch.Tensor, mask: torch.Tensor, count_plus1: torch.Tensor) -> torch.Tensor:
    lead = depth.shape[:-2]
    t = masked_median(depth.reshape(*lead, -1), mask.reshape(*lead, -1))[..., None, None]
    diff = torch.where(mask, (depth - t).abs(), 0.0)
    s = diff.reshape(*lead, -1).sum(dim=-1)[..., None, None] / count_plus1
    return (depth - t) / (s + 1e-6)


def masked_shift_and_scale(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                           mask: torch.Tensor):
    """Align pred and gt each by (x - median) / (MAD + 1e-6); the MAD uses
    the reference's ``count + 1`` denominator and the alignment applies to
    every pixel, not only the valid ones."""
    lead = depth_pred.shape[:-2]
    count_plus1 = (mask.reshape(*lead, -1).sum(dim=-1).to(depth_pred.dtype) + 1.0)[..., None, None]
    return _align(depth_pred, mask, count_plus1), _align(depth_gt, mask, count_plus1)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                   dense: bool = False) -> torch.Tensor:
    """|pred - target| zeroed at invalid pixels; the scalar mean (count
    + 1e-6) unless ``dense``."""
    elem = torch.where(mask, (pred - target).abs(), 0.0)
    if dense:
        return elem
    return elem.sum() / (mask.sum() + 1e-6)


def ssi_mae_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                 dense: bool = False) -> torch.Tensor:
    """Align both maps, then masked L1."""
    pred_a, gt_a = masked_shift_and_scale(depth_pred, depth_gt, mask)
    return masked_l1_loss(pred_a, gt_a, mask, dense)
