"""Model factory: named presets -> initialised DepthModel on a device.

Counterpart of distill_any_depth_tpu/models/factory.py. The random init is
seeded with a ``torch.Generator`` on the CPU before the move to the device,
so one seed gives the same weights on every device. It follows flax's
initialisers in kind (truncated-normal LeCun kernels, SwiGLU's included,
zero biases, LayerScale at ``init_values``, register tokens normal with std
1e-6, LoRA's A normal with std 1/r and B zero, SSF the identity) but not in
bits: for parity with the JAX package, load
its params through ``utils/convert.params_from_jax``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from distill_any_depth_tpu_torch.configs import ModelConfig, model_config
from distill_any_depth_tpu_torch.models.adapters import SSF, LoRALinear
from distill_any_depth_tpu_torch.models.dpt import DepthModel
from distill_any_depth_tpu_torch.models.vit import DinoViT, LayerScale

__all__ = ["resolve_device", "resolve_fused_tail", "create_model", "init_params"]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


def resolve_fused_tail(mode) -> bool:
    """A ``fused_tail`` setting (``TrainConfig.teacher_fused_tail``, the
    CLIs' ``--fused_tail``) as a bool, as the JAX package maps it: a bool
    passes through, "on" and "off" map to it, and "auto" (or None) is on:
    kernel 2 on the card, its plain version on the CPU (the JAX package's
    "auto" is on where its kernel runs natively, the TPU)."""
    if isinstance(mode, bool):
        return mode
    if mode in (None, "auto"):
        return True
    return mode == "on"


def create_model(
    arch_name: str | ModelConfig,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
    seed: int | None = 0,
    fused_tail: bool = True,
    quant: str = "none",
    attn_impl: str = "auto",
    remat: bool = False,
) -> DepthModel:
    """An eval-mode ``DepthModel`` with seeded random weights on ``device``
    (``seed=None``: no seeded init, for a caller that loads every weight
    from a checkpoint next; the seeded init of ViT-L takes seconds).
    ``dtype`` is the compute dtype (parameters stay fp32): bf16 by default
    on a card, fp32 on the CPU. ``fused_tail=True`` (inference, teachers)
    runs a 1-channel DPT tail through its kernel; a model that trains (the
    distillation student) passes ``False``, as the JAX package's student.
    ``quant="int8"`` or ``"int8_pallas"`` runs the encoder blocks' GEMMs as
    dynamic W8A8 int8 (``ops/quant``; kernel 9 for "int8_pallas" on the
    card): inference only, so a model that trains keeps "none".
    ``attn_impl`` ("auto", "flash", "reference") selects the attention and
    ``remat=True`` recomputes each encoder block in the backward
    (``models/vit``)."""
    cfg = arch_name if isinstance(arch_name, ModelConfig) else model_config(arch_name)
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = DepthModel(cfg, dtype, fused_tail, quant, attn_impl, remat)
    if seed is not None:
        init_params(model, seed)
    return model.to(device).eval()


def _trunc_normal(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> None:
    """Seeded in-place init of every parameter of ``model`` (on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DinoViT):
            _trunc_normal(m.pos_embed, 0.02, gen)
            if m.cls_token is not None:
                m.cls_token.normal_(0.0, 1e-6, generator=gen)
            if m.register_tokens is not None:
                m.register_tokens.normal_(0.0, 1e-6, generator=gen)
        elif isinstance(m, (LayerScale, SSF)):
            pass  # keeps init_values; SSF keeps the identity
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.ConvTranspose2d):
            # flax variance_scaling(1/3, fan_in, uniform) on the [I, k*k*O] kernel
            bound = 1.0 / math.sqrt(m.weight.shape[0])
            m.weight.uniform_(-bound, bound, generator=gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            # LeCun normal: truncated at 2 std, rescaled to unit variance
            _trunc_normal(m.weight, 1.0 / math.sqrt(fan_in) / 0.87962566103423978, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    # the patch embedding follows the JAX package: truncated normal, std 0.02
    _trunc_normal(model.pretrained.patch_embed.proj.weight, 0.02, gen)
    # LoRA last, so that a seed gives the same base weights with adapters
    # as without
    for m in model.modules():
        if isinstance(m, LoRALinear):
            m.reset_lora(gen)
