"""Depth evaluation metrics.

Counterpart of distill_any_depth_tpu/eval/metrics.py: per-sample
mean-ratio scale alignment on the valid (gt > 0) pixels, then abs_rel,
abs_diff, sq_rel, rmse, rmse_log and delta < 1.25^{1,2,3}.
``compute_depth_metrics`` is the single-sample numpy form (no alignment);
``batched_depth_metrics`` computes a batch with masked reductions in fp32
on the tensors' device, with the JAX function's ``1e-12`` guards.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_depth_metrics", "batched_depth_metrics", "METRIC_KEYS"]

METRIC_KEYS = ("abs_rel", "abs_diff", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
_EPS = 1e-12


def compute_depth_metrics(pred: np.ndarray, gt: np.ndarray, mask=None) -> dict:
    """Single-sample numpy metrics, no alignment."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    if mask is None:
        mask = gt > 0
    pred, gt = pred[mask], gt[mask]
    if pred.size == 0:
        return {k: float("nan") for k in METRIC_KEYS}
    thresh = np.maximum(gt / pred, pred / gt)
    return {
        "abs_rel": float(np.mean(np.abs(gt - pred) / gt)),
        "abs_diff": float(np.mean(np.abs(gt - pred))),
        "sq_rel": float(np.mean((gt - pred) ** 2 / gt)),
        "rmse": float(np.sqrt(np.mean((gt - pred) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))),
        "a1": float(np.mean(thresh < 1.25)),
        "a2": float(np.mean(thresh < 1.25**2)),
        "a3": float(np.mean(thresh < 1.25**3)),
    }


def batched_depth_metrics(pred, gt) -> tuple[dict, torch.Tensor]:
    """Per-sample metrics of ``pred`` and ``gt`` ``[B, H, W]`` (tensors or
    arrays; mask ``gt > 0``) after mean-ratio alignment: a dict of ``[B]``
    fp32 tensors on ``pred``'s device, and the ``[B]`` bool flags of the
    samples with a valid pixel."""
    pred = torch.as_tensor(pred).float()
    gt = torch.as_tensor(gt).to(device=pred.device, dtype=torch.float32)
    mask = gt > 0
    cnt = mask.sum(dim=(1, 2), dtype=torch.float32)
    safe_cnt = cnt.clamp(min=1.0)

    def masked_mean(x):
        return torch.where(mask, x, 0.0).sum(dim=(1, 2)) / safe_cnt

    # mean-ratio scale alignment: pred *= mean(gt[mask]) / mean(pred[mask])
    scale = masked_mean(gt) / masked_mean(pred).clamp(min=_EPS)
    pred = pred * scale[:, None, None]
    safe_pred = pred.clamp(min=_EPS)
    safe_gt = gt.clamp(min=_EPS)
    thresh = torch.maximum(gt / safe_pred, pred / safe_gt)
    diff = gt - pred
    metrics = {
        "abs_rel": masked_mean(diff.abs() / safe_gt),
        "abs_diff": masked_mean(diff.abs()),
        "sq_rel": masked_mean(diff * diff / safe_gt),
        "rmse": masked_mean(diff * diff).sqrt(),
        "rmse_log": masked_mean((safe_gt.log() - safe_pred.log()) ** 2).sqrt(),
        "a1": masked_mean((thresh < 1.25).float()),
        "a2": masked_mean((thresh < 1.25**2).float()),
        "a3": masked_mean((thresh < 1.25**3).float()),
    }
    return metrics, cnt > 0
