"""DPT decoder head and the full depth model.

Counterpart of distill_any_depth_tpu/models/dpt.py (``PatchExpand``,
``ResidualConvUnit``, ``FeatureFusionBlock``, ``DPTHead``, ``DepthModel``),
in NCHW with the reference's state-dict names
(``depth_head.scratch.refinenet1.resConfUnit1.conv1`` ...). ``PatchExpand``
is the reference's ``ConvTranspose2d(k, stride=k)`` it stands for.

The tail after refinenet1 (2x upsample, output_conv1, upsample to the
patch-grid resolution, output_conv2 + ReLU + 1x1) of a 1-channel head built
with ``fused_tail=True`` (inference, and the teacher of a distillation)
goes through ``ops/dpt_tail.fused_dpt_tail``: the CUDA kernel on the card
(which is forward-only and raises on tensors that require a gradient), its
plain version on the CPU. With ``fused_tail=False``, the JAX package's
student configuration, and for a multi-channel head, the tail is the plain
chain of convs and bilinear resizes. refinenet1's 1x1 ``out_conv`` runs
before its 2x upsample on every path: a 1x1 conv commutes with bilinear
resampling (its rows sum to one).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distill_any_depth_tpu_torch.configs import ModelConfig
from distill_any_depth_tpu_torch.models.vit import Conv2d, DinoViT, Linear, cast_weights, gelu
from distill_any_depth_tpu_torch.ops.derived import Derived
from distill_any_depth_tpu_torch.ops.dpt_tail import fused_dpt_tail, prepare_weights
from distill_any_depth_tpu_torch.ops.resize import resize_nchw

__all__ = ["ConvTranspose2d", "ResidualConvUnit", "FeatureFusionBlock", "DPTHead",
           "DepthModel"]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``PatchExpand``: a transposed conv with kernel == stride."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.casts = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, *cast_weights(self.casts, x.dtype, (self.weight, self.bias)),
                                  self.stride)


class _Readout(nn.Module):
    """Linear(2C -> C) + GELU over [patch tokens | cls] (key ``.0``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.add_module("0", Linear(2 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self._modules["0"](x))


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3 -> + x."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """Refinenet fusion: optional skip through resConfUnit1, resConfUnit2,
    bilinear upsample (align_corners), 1x1 out_conv. refinenet4 has no skip,
    hence no resConfUnit1 (as in the JAX param tree)."""

    def __init__(self, features: int, has_skip: bool):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None, defer_resize: bool = False):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if defer_resize:  # out_conv at the low resolution; the caller resizes
            return self.out_conv(x)
        if size is None:
            size = (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize_nchw(x, tuple(size)))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int], head_out_channels: int):
        super().__init__()
        for i, oc in enumerate(out_channels):
            self.add_module(f"layer{i + 1}_rn", Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(features, has_skip=i != 4))
        self.output_conv1 = Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), Conv2d(32, head_out_channels, 1)
        )


class DPTHead(nn.Module):
    """``forward(taps, gh, gw, cls_tokens)`` -> ``[B, head_out, 14*gh, 14*gw]``."""

    def __init__(self, embed_dim: int, features: int, out_channels: Sequence[int],
                 head_out_channels: int = 1, use_clstoken: bool = False,
                 trailing_relu: bool = True, patch_size: int = 14,
                 fused_tail: bool = True):
        super().__init__()
        self.fused_tail = fused_tail
        self.tail_weights = Derived()  # the kernel's packed weights, per weight version
        self.use_clstoken = use_clstoken
        self.trailing_relu = trailing_relu
        self.patch_size = patch_size
        self.head_out_channels = head_out_channels
        self.projects = nn.ModuleList(Conv2d(embed_dim, oc, 1) for oc in out_channels)
        oc = out_channels
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        if use_clstoken:
            self.readout_projects = nn.ModuleList(_Readout(embed_dim) for _ in range(4))
        self.scratch = _Scratch(features, out_channels, head_out_channels)

    def forward(self, taps, gh: int, gw: int, cls_tokens=None) -> torch.Tensor:
        s = self.scratch
        outs = []
        for i, t in enumerate(taps):
            if self.use_clstoken:
                cls = cls_tokens[i][:, None, :].expand_as(t)
                t = self.readout_projects[i](torch.cat([t, cls], dim=-1))
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
            outs.append(self.resize_layers[i](self.projects[i](x)))
        rn = [getattr(s, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        path = s.refinenet4(rn[3], size=rn[2].shape[2:])
        path = s.refinenet3(path, rn[2], size=rn[1].shape[2:])
        path = s.refinenet2(path, rn[1], size=rn[0].shape[2:])
        t = s.refinenet1(path, rn[0], defer_resize=True)

        oh, ow = gh * self.patch_size, gw * self.patch_size
        conv2, head = s.output_conv2[0], s.output_conv2[2]
        if self.fused_tail and self.head_out_channels == 1:
            weights = (s.output_conv1.weight.permute(2, 3, 1, 0), s.output_conv1.bias,
                       conv2.weight.permute(2, 3, 1, 0), conv2.bias,
                       head.weight[:, :, 0, 0].t(), head.bias)
            prepared = (self.tail_weights.get(weights, lambda: prepare_weights(*weights, t.dtype),
                                              t.dtype) if t.is_cuda else None)
            d = fused_dpt_tail(t.permute(0, 2, 3, 1).contiguous(), (oh, ow), *weights,
                               trailing_relu=self.trailing_relu, weights=prepared)
            return d[:, None]
        x = s.output_conv1(resize_nchw(t, (2 * t.shape[2], 2 * t.shape[3])))
        x = s.output_conv2(resize_nchw(x, (oh, ow)))
        return F.relu(x) if self.trailing_relu else x


class DepthModel(nn.Module):
    """DINOv2 encoder + DPT head, student or teacher by ``ModelConfig``.

    ``forward(x [B, 3, H, W], pe_step=None)`` runs in ``self.dtype`` (the
    windowed encoder's PE -> GPE blend at training step ``pe_step``; None
    is inference, past the schedule) and returns
    ``(depth, features)``: depth ``[B, H', W']`` (``[B, C, H', W']`` for a
    multi-channel head) ReLU'd as the reference does, and the last tap's
    tokens ``[B, N, C]``. ``fused_tail`` selects the DPT tail kernel for a
    1-channel head (see the module docstring); ``quant`` ("none", "int8",
    "int8_pallas") the encoder blocks' GEMMs (``models/vit``), for a model
    that does not train; ``attn_impl`` their attention and ``remat`` the
    recompute of each block in the backward (``models/vit``).
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 fused_tail: bool = True, quant: str = "none", attn_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        enc = cfg.encoder
        self.pretrained = DinoViT(enc, quant, attn_impl, remat)
        self.depth_head = DPTHead(enc.embed_dim, cfg.features, cfg.out_channels,
                                  cfg.head_out_channels, cfg.use_clstoken,
                                  cfg.trailing_head_relu, enc.patch_size, fused_tail)

    def forward(self, x: torch.Tensor, pe_step=None):
        x = x.to(self.dtype)
        h, w = x.shape[-2:]
        p = self.cfg.encoder.patch_size
        taps, cls_tokens = self.pretrained(x, pe_step)
        depth = self.depth_head(taps, h // p, w // p, cls_tokens)
        if self.cfg.interp_to_input and tuple(depth.shape[-2:]) != (h, w):
            depth = resize_nchw(depth, (h, w))
        if self.cfg.wo_relu_1_2_channel:
            depth = torch.cat([depth[:, :2], F.relu(depth[:, 2:])], dim=1)
        else:
            depth = F.relu(depth)
        if depth.shape[1] == 1:
            depth = depth[:, 0]
        return depth, taps[3]
