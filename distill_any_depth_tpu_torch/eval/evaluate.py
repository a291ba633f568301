"""Evaluation harness: batched inference and the aligned 8-metric set.

Counterpart of distill_any_depth_tpu/eval/evaluate.py (``evaluate_model``,
``compare_models``, ``write_report``). The forward runs on the model's
device in the model's dtype (on the card: attention kernel 1 and the DPT
tail kernel 2). When the prediction and the ground truth differ in size
(the registry's native-resolution protocol, ``data/registry``), the
prediction is upsampled to the ground truth's grid, bilinear with
``align_corners=False`` (PyTorch's ``F.interpolate`` default), by the
interpolation matrices of ``ops/resize.resize_matrix``, whose coordinates
are built in fp64 as the JAX ``resize_2d``'s are. Each batch goes to the
device once and its metrics come back in one read.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Iterable

import numpy as np
import torch

from distill_any_depth_tpu_torch.eval.metrics import METRIC_KEYS, batched_depth_metrics
from distill_any_depth_tpu_torch.ops.resize import resize_matrix

logger = logging.getLogger("distill_any_depth_tpu_torch.eval")

__all__ = ["evaluate_model", "compare_models", "write_report", "upsample_to"]


def upsample_to(pred: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear (``align_corners=False``) resize of fp32 ``pred [B, h, w]``
    to ``out_hw``: ``M_h @ pred @ M_w^T``."""
    h, w = pred.shape[-2:]
    mh, mw = (torch.from_numpy(resize_matrix(i, o, "bilinear", False)).to(pred.device)
              for i, o in ((h, out_hw[0]), (w, out_hw[1])))
    return mh @ pred @ mw.t()


@torch.no_grad()
def evaluate_model(model: torch.nn.Module, batches: Iterable[dict]) -> dict:
    """The 8 metrics averaged over every valid sample of ``batches``, which
    yield ``{'image': [B, H, W, 3], 'depth': [B, H', W']}`` (numpy)."""
    device = next(model.parameters()).device
    sums = dict.fromkeys(METRIC_KEYS, 0.0)
    n = 0
    for batch in batches:
        x = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32)).to(device)
        gt = torch.from_numpy(np.ascontiguousarray(batch["depth"], np.float32)).to(device)
        pred = model(x.permute(0, 3, 1, 2))[0].float()
        if pred.shape[1:] != gt.shape[1:]:
            pred = upsample_to(pred, tuple(gt.shape[1:]))
        metrics, valid = batched_depth_metrics(pred, gt)
        host = torch.stack([metrics[k] for k in METRIC_KEYS] + [valid.float()]).cpu().numpy()
        valid = host[-1] > 0
        for i, k in enumerate(METRIC_KEYS):
            sums[k] += float(np.nansum(host[i][valid]))
        n += int(valid.sum())
    if n == 0:
        return {k: float("nan") for k in METRIC_KEYS}
    return {k: sums[k] / n for k in METRIC_KEYS}


def compare_models(model_a: torch.nn.Module, model_b: torch.nn.Module,
                   make_batches: Callable[[], Iterable[dict]]) -> dict:
    """Both models on the same data (a distilled and an original model)."""
    return {"model_a": evaluate_model(model_a, make_batches()),
            "model_b": evaluate_model(model_b, make_batches())}


def write_report(path: str, results: dict, title: str = "NYU evaluation") -> None:
    """``results`` (name -> metrics) as text at ``path`` and as JSON beside
    it (``.json``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = [title, "=" * len(title), ""]
    for name, metrics in results.items():
        lines.append(f"[{name}]")
        for k in METRIC_KEYS:
            if k in metrics:
                lines.append(f"  {k:10s} {metrics[k]:.6f}")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(results, f, indent=2)
    logger.info("wrote %s", path)
