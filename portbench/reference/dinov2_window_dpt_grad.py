"""Plain float32 windowed high-resolution ViT-B whose gradient fits on one
card at bs16 1036^2: ``dinov2_window_dpt``'s forward, computed in pieces
that autograd recomputes in the backward.

The model, its weights and its equations are ``dinov2_window_dpt``'s
(Distill-Any-Depth ``ViT_DINO.py:875`` ``DinoWindowVisionTransformer`` as
``vit_base`` builds it, CPVT's PEG, no cls token, the final-layer taps, the
DAM teacher head), and so are ``READS``, ``REQUIRES``, ``IGNORES``,
``WEIGHT_KEYS``, ``OPTIONS`` and ``param_specs``: a configuration names this
module where the model is a training step's student. Autograd through that
module's ``depth_forward`` would keep each image's masked float32 scores
and probabilities, about 2.9 GB an image and block at 1036^2, so 550 GB
over 16 images and 12 blocks, and about 50 GB of other activations. Here:

- each encoder block is recomputed in the backward
  (``torch.utils.checkpoint``, non-reentrant), which keeps the 13 residual
  streams alone (3.5 GB at bs16);
- inside a block, the attention (qkv, the masked softmax, proj: that
  module's ``_window_attention`` on one image) is recomputed one image at a
  time, so that one image's scores live at once;
- the DPT head, with the resize to the input, is recomputed one image at a
  time (its float32 maps are about 1.6 GB an image at 1036^2).

Every piece calls ``dinov2_window_dpt``'s and ``dinov2_dpt``'s helpers
unchanged; a matrix product over one image in place of a batch sums in
the same order up to the library's blocking. On a card it refuses to run
with TF32 on: the recomputation runs in the backward, so the whole step
runs inside ``portbench.check.fp32()``.

Departures from the published model: none in the arithmetic. As in
``dinov2_window_dpt`` the model runs past its PE -> GPE schedule
(coefficient 1), where the pos-embed has weight 0: it is added as 0 times
its mean, exact zeros, so that autograd gives it the zero gradient the
program gives it. As a student this is
a departure of the training step: the published model ramps the
coefficient from step 2000 to step 10000 (``ViT_DINO.py:1118-1139``), and
both the port's and the JAX package's train steps call the student with no
``pe_step``, so they train the post-schedule blend from step 0.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import dinov2_window_dpt as window
from portbench.reference.dinov2_dpt import PATCH, _conv, _layer_norm, _linear, _q, _up, head_forward
from portbench.reference.dinov2_window_dpt import (IGNORES, OPTIONS, READS, REQUIRES, WEIGHT_KEYS,
                                                   param_specs)

__all__ = ["READS", "REQUIRES", "IGNORES", "WEIGHT_KEYS", "OPTIONS", "param_specs",
           "depth_forward", "encoder_forward"]

_recompute = functools.partial(checkpoint, use_reentrant=False)


def _block(t, W, m, i, dead, quant):
    """Block ``i`` of ``dinov2_window_dpt.encoder_forward``, its attention
    recomputed one image at a time."""
    blk = f"pretrained.blocks.{i}"
    x = _layer_norm(t, W, f"{blk}.norm1", quant)
    a = torch.cat([_recompute(window._window_attention, x[j:j + 1], W, f"{blk}.attn",
                              m["num_heads"], dead, quant) for j in range(x.shape[0])])
    t = _q(t + W[f"{blk}.ls1.gamma"] * a, quant)
    y = _linear(_layer_norm(t, W, f"{blk}.norm2", quant), W[f"{blk}.mlp.fc1.weight"],
                W[f"{blk}.mlp.fc1.bias"], quant)
    y = _linear(_q(F.gelu(y), quant), W[f"{blk}.mlp.fc2.weight"], W[f"{blk}.mlp.fc2.bias"],
                quant)
    return _q(t + W[f"{blk}.ls2.gamma"] * y, quant)


def encoder_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """``dinov2_window_dpt.encoder_forward``, each block recomputed in the
    backward."""
    window._check(m)
    gh, gw = x.shape[-2] // PATCH, x.shape[-1] // PATCH
    p = "pretrained"
    t = _conv(x, W[f"{p}.patch_embed.proj.weight"], W[f"{p}.patch_embed.proj.bias"], quant,
              stride=PATCH).flatten(2).transpose(1, 2)
    # past the schedule the pos-embed has weight 0: it enters as 0 * its
    # mean, which adds exact zeros and gives it the zero gradient that the
    # program gives it (the step takes a gradient of every parameter)
    t = t + 0.0 * W[f"{p}.pos_embed"].mean(1, keepdim=True)
    t = _q(t + window._peg(W, t, gh, gw, quant), quant)
    dead = ~window.window_mask(gh, gw, m["window_size"], x.device)
    for i in range(m["depth"]):
        t = _recompute(_block, t, W, m, i, dead, quant)
    return [_layer_norm(t, W, f"{p}.norm", quant)] * 4


def _head(W, m, tap, gh, gw, hw, quant):
    """One image's depth before the final ReLU, ``[1, 1, H, W]``."""
    depth = head_forward(W, m, [tap] * 4, gh, gw, quant)
    if m["interp_to_input"] and tuple(depth.shape[-2:]) != hw:
        depth = _up(depth, hw, quant)
    return depth


def depth_forward(W: dict, m: dict, x: torch.Tensor, quant: str | None = None):
    """``(depth [B, H, W], last tap [B, N, C])`` of normalized images ``x
    [B, 3, H, W]``, as ``dinov2_window_dpt.depth_forward``."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the reference runs with TF32 off, its backward too "
                           "(portbench.check.fp32)")
    h, w = x.shape[-2:]
    tap = encoder_forward(W, m, x, quant)[3]
    depth = torch.cat([_recompute(_head, W, m, tap[j:j + 1], h // PATCH, w // PATCH, (h, w),
                                  quant) for j in range(x.shape[0])])
    return F.relu(depth)[:, 0], tap
