"""Sobel gradient-preservation loss: ``mean(exp(-|grad|))``.

Counterpart of distill_any_depth_tpu/losses/gradient.py: the separable
Sobel stencil as shift-and-add slices over the zero-padded map (the same
sums the JAX package takes, so both agree to rounding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gradient_preservation_loss", "sobel_gradients"]


def sobel_gradients(depth: torch.Tensor):
    """Sobel-x/y of ``[..., H, W]`` with zero padding."""
    p = F.pad(depth, (1, 1, 1, 1))
    sv = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]  # [..., H, W+2]
    gx = sv[..., :, 2:] - sv[..., :, :-2]
    sh = p[..., :, :-2] + 2.0 * p[..., :, 1:-1] + p[..., :, 2:]  # [..., H+2, W]
    gy = sh[..., 2:, :] - sh[..., :-2, :]
    return gx, gy


def gradient_preservation_loss(depth: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` -> scalar ``mean(exp(-sqrt(gx^2 + gy^2 + 1e-6)))``."""
    gx, gy = sobel_gradients(depth)
    return torch.exp(-torch.sqrt(gx * gx + gy * gy + 1e-6)).mean()
