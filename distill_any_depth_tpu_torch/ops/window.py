"""Local-window and segment attention biases.

The port's own copy of distill_any_depth_tpu/ops/window.py: additive
``[N, N]`` biases, 0 where a query may attend a key and -inf elsewhere.
``local_window_bias`` restricts each patch token of a row-major
``gh x gw`` grid to a ``window x window`` neighbourhood whose centre is
clamped inward at the borders (corner/edge completion: a border token sees a
full window, not a truncated one; a grid smaller than the window sees the
whole axis); prefix tokens (cls, registers) attend and are attended
everywhere. ``window_pairs`` counts the bias's live (query, key) pairs on
the host.

The bias is built once with numpy and kept per grid, device and dtype, so a
forward does not copy it from the host again.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["local_window_bias", "window_pairs", "segment_bias"]


@functools.lru_cache(maxsize=64)
def _bias_np(gh: int, gw: int, window: int, n_prefix: int) -> np.ndarray:
    n = n_prefix + gh * gw
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    half = window // 2
    cy = np.clip(ys, half, max(gh - 1 - half, half))
    cx = np.clip(xs, half, max(gw - 1 - half, half))
    dy = np.abs(cy[:, None] - ys[None, :])
    dx = np.abs(cx[:, None] - xs[None, :])
    allowed = (dy <= half) & (dx <= half)
    bias = np.full((n, n), -np.inf, dtype=np.float32)
    bias[:n_prefix, :] = 0.0
    bias[:, :n_prefix] = 0.0
    bias[n_prefix:, n_prefix:][allowed] = 0.0
    return bias


@functools.lru_cache(maxsize=16)
def _bias_tensor(gh: int, gw: int, window: int, n_prefix: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    # a plain tensor even when first asked for under inference mode: a
    # training forward saves it for its backward, which an inference tensor
    # refuses
    with torch.inference_mode(False):
        return torch.from_numpy(_bias_np(gh, gw, window, n_prefix)).to(device=device,
                                                                      dtype=dtype)


def local_window_bias(gh: int, gw: int, window: int, n_prefix: int = 1,
                      device: str | torch.device = "cpu",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive ``[N, N]`` bias (N = n_prefix + gh*gw) restricting patch-token
    attention to a ``window x window`` neighbourhood. The tensor is shared
    between callers: do not write to it. A trace (``torch.export``) gets a
    tensor of its own, which it keeps as a constant, and caches nothing."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(_bias_np(gh, gw, window, n_prefix)).to(device=device, dtype=dtype)
    return _bias_tensor(gh, gw, window, n_prefix, torch.device(device), dtype)


def window_pairs(gh: int, gw: int, window: int, n_prefix: int = 0) -> int:
    """Live (query, key) pairs of ``local_window_bias(gh, gw, window,
    n_prefix)``, from the shapes alone. The window is separable and its
    clamped centre keeps it whole, so an axis of ``g`` tokens gives each
    query ``min(window, g)`` keys; a prefix token pairs with every token."""
    grid = gh * min(window, gh) * gw * min(window, gw)
    n = n_prefix + gh * gw
    return grid + n_prefix * (2 * n - n_prefix)


def segment_bias(segment_ids: torch.Tensor) -> torch.Tensor:
    """Block-diagonal bias from per-token segment ids ``[N]``: 0 within a
    segment, -inf across (packed variable-length sequences)."""
    same = segment_ids[:, None] == segment_ids[None, :]
    return torch.where(same, 0.0, float("-inf")).to(torch.float32)
