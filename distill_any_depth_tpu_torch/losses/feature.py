"""Feature distillation loss: 1 - mean cosine over the token axis.

Counterpart of distill_any_depth_tpu/losses/feature.py, for ``[B, N, C]``
final-tap tokens, with the reference's quirks: the larger channel axis is
nearest-resized to the smaller one, and the cosine runs over the token axis
(dim 1).

When the token counts differ, the JAX package projects the larger one with
a fixed matrix drawn from ``jax.random.PRNGKey(8421 + salt)``. The port
cannot draw those numbers without JAX, so the caller passes the matrices
(``projections``: for student and teacher, ``[N_in, N_target]`` or None);
the main path (equal token counts) never needs them.
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops.resize import resize_1d

__all__ = ["feature_distillation_loss"]


def _cosine_over_tokens(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(min=1e-12)
    bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(min=1e-12)
    return 1.0 - (an * bn).sum(dim=1).mean()


def feature_distillation_loss(student_feat: torch.Tensor, teacher_feat: torch.Tensor,
                              projections=(None, None)) -> torch.Tensor:
    """Cosine feature-alignment loss of ``[B, N, C]`` token features."""
    sf, tf = student_feat, teacher_feat
    if sf.ndim != 3 or tf.ndim != 3:
        raise ValueError(f"features must be [B, N, C]; got {tuple(sf.shape)}, {tuple(tf.shape)}")
    if sf.shape[2] != tf.shape[2]:
        target = min(sf.shape[2], tf.shape[2])
        sf = resize_1d(sf, target, "nearest", axis=2)
        tf = resize_1d(tf, target, "nearest", axis=2)
    if sf.shape[1] != tf.shape[1]:
        target = min(sf.shape[1], tf.shape[1])

        def project(x, proj):
            if x.shape[1] == target:
                return x
            if proj is None or tuple(proj.shape) != (x.shape[1], target):
                raise ValueError(f"token counts differ ({sf.shape[1]} vs {tf.shape[1]}): "
                                 f"pass a [{x.shape[1]}, {target}] projection")
            return torch.einsum("bcs,ct->bts", x, proj.to(x))

        sf = project(sf, projections[0])
        tf = project(tf, projections[1])
    return _cosine_over_tokens(sf, tf)
