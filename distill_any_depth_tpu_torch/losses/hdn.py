"""Hierarchical Depth Normalization (HDN) loss: dr / dp / ds contexts.

Counterpart of distill_any_depth_tpu/losses/hdn.py. Contexts are a bool
``[K, B, H, W]`` tensor (K = 7 for dr and dp at level 3, 21 for ds); the
dense SSI runs once over the K*B rows folded together.

Normalizers: ``"covered"`` divides by the pixels covered by at least one
context (the training loop's), ``"valid"`` by ``valid_mask.sum()`` (the
demo's).

Under data parallelism (``data_group``) the normalizer is a count over the
whole global batch, not over this rank's rows: the count is summed over the
data group (it carries no gradient) and divided by the group's size, so
that the mean of the ranks' losses, and of their gradients, is the
single-process loss of the global batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from distill_any_depth_tpu_torch.losses.ssi import ssi_mae_loss
from distill_any_depth_tpu_torch.ops.stats import masked_quantile

__all__ = ["get_contexts_dr", "get_contexts_dp", "get_contexts_ds", "hdn_loss"]


def _bin_fractions(level: int) -> list[tuple[float, float]]:
    """(lo, hi) fractional bin edges, finest level first."""
    edges = []
    for bin_size in [(1 / 2) ** i for i in reversed(range(level))]:
        for i in range(int(1 / bin_size)):
            edges.append((i * bin_size, (i + 1) * bin_size))
    return edges


def get_contexts_dr(level: int, depth_gt: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    """Depth-range contexts: ``[B, H, W]`` -> bool ``[K, B, H, W]``. With no
    valid pixel the min/max are +inf/-inf and every context is empty."""
    if mask is None:
        mask = torch.ones_like(depth_gt, dtype=torch.bool)
    b = depth_gt.shape[0]
    flat = depth_gt.reshape(b, -1)
    mflat = mask.reshape(b, -1)
    dmin = torch.where(mflat, flat, torch.inf).amin(dim=-1)[:, None, None]
    dmax = torch.where(mflat, flat, -torch.inf).amax(dim=-1)[:, None, None]
    rng = dmax - dmin
    ctxs = []
    for lo_f, hi_f in _bin_fractions(level):
        lo = dmin + rng * lo_f
        hi = dmin + rng * hi_f + 1e-30
        ctxs.append((depth_gt >= lo) & (depth_gt < hi) & mask)
    return torch.stack(ctxs, dim=0)


def get_contexts_dp(level: int, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Depth-percentile contexts from masked quantiles (a NaN quantile of an
    empty mask compares false)."""
    b = depth_gt.shape[0]
    flat = depth_gt.reshape(b, -1)
    mflat = mask.reshape(b, -1)
    ctxs = []
    for lo_f, hi_f in _bin_fractions(level):
        lo = masked_quantile(flat, mflat, lo_f)[:, None, None]
        hi = masked_quantile(flat, mflat, hi_f)[:, None, None]
        ctxs.append(mask & (depth_gt >= lo) & (depth_gt < hi))
    return torch.stack(ctxs, dim=0)


def get_contexts_ds(level: int, mask: torch.Tensor) -> torch.Tensor:
    """Spatial-grid contexts: per level a (1/bs)^2 grid of cells sized from
    the trailing axis (square images, as the reference)."""
    h, w = mask.shape[-2], mask.shape[-1]
    ctxs = []
    for bin_size in [(1 / 2) ** i for i in reversed(range(level))]:
        n = int(1 / bin_size)
        for gy in range(n):
            for gx in range(n):
                cell = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
                y0, y1 = int(gy * bin_size * w), int((gy + 1) * bin_size * w)
                x0, x1 = int(gx * bin_size * w), int((gx + 1) * bin_size * w)
                cell[y0:y1, x0:x1] = True
                ctxs.append(mask & cell)
    return torch.stack(ctxs, dim=0)


def _global_count(count: torch.Tensor, data_group) -> torch.Tensor:
    """``count`` summed over ``data_group``, and the group's size."""
    if data_group is None:
        return count, 1
    count = count.clone()
    dist.all_reduce(count, group=data_group)
    return count, dist.get_world_size(data_group)


def hdn_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor, contexts: torch.Tensor,
             normalizer: str = "covered", valid_mask: torch.Tensor | None = None,
             data_group=None) -> torch.Tensor:
    """``depth_pred``/``depth_gt`` ``[B, H, W]``, ``contexts`` bool
    ``[K, B, H, W]`` -> scalar. ``data_group``: the normalizer counts the
    global batch (see the module docstring)."""
    k, b = contexts.shape[:2]
    hw = depth_pred.shape[1:]
    dense = ssi_mae_loss(
        depth_pred[None].expand(contexts.shape).reshape(k * b, *hw),
        depth_gt[None].expand(contexts.shape).reshape(k * b, *hw),
        contexts.reshape(k * b, *hw),
        dense=True,
    ).reshape(contexts.shape)
    per_pixel_sum = dense.sum(dim=0)
    times = contexts.sum(dim=0)
    covered = times > 0
    per_pixel = torch.where(covered, per_pixel_sum / times.clamp(min=1), per_pixel_sum)
    if normalizer == "covered":
        count, ranks = _global_count(covered.sum(), data_group)
        denom = count + 1e-6
    elif normalizer == "valid":
        if valid_mask is None:
            raise ValueError("normalizer='valid' needs valid_mask")
        denom, ranks = _global_count(valid_mask.sum(), data_group)
    else:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    if ranks > 1:
        denom = denom / ranks
    return per_pixel.sum() / denom
