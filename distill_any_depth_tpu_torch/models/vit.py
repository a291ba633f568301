"""DINOv2-style ViT encoder: global attention with a cls token (and, in the
register family, register tokens and a SwiGLU FFN), or the windowed
high-resolution variant.

Counterpart of distill_any_depth_tpu/models/vit.py (``PatchEmbed``, ``Mlp``,
``SwiGLU``, ``Attention``, ``Block``, ``_interp_pos_embed``, ``PosConv``,
``DinoViT``). Submodules carry the reference state-dict names
(``pretrained.blocks.{i}.attn.qkv``, ``pretrained.blocks.{i}.mlp.w12``,
``pretrained.register_tokens``, ``pretrained.pos_conv.proj.0`` ...), so a
state dict from ``utils/convert.params_from_jax`` loads with
``strict=True``.

Parameters stay fp32; every layer casts its weights to the dtype of its
input, as flax does with ``kernel.astype(dtype)``, so bf16 activations reach
the attention kernels. Under ``torch.inference_mode()`` the casts
(``cast_weights``: the layers' weights, the pos-embed of a grid, the cls and
register tokens) are kept per weight version in an ``ops/derived.Derived``
of the module, so a forward reads its bf16 weights instead of casting them
again; in grad mode and under ``torch.no_grad()`` each forward casts anew.
``quant`` ("int8" or "int8_pallas") runs the blocks' qkv, proj and FFN
GEMMs (fc1 and fc2, or SwiGLU's w12 and w3) as dynamic W8A8 int8 GEMMs
(``QuantLinear`` on ``ops/quant``, inference only; the patch embedding and
the PEG conv stay unquantized, as in the JAX package).
``cfg.lora_rank`` puts LoRA on the blocks' attention qkv and proj (a
``models/adapters.LoRALinear`` in place of the plain or quantized layer, as
the JAX ``LoRADense``; the qkv output with its update goes to the
attention kernels as it is), and ``cfg.use_ssf`` an SSF adapter at the four
taps ``ssf_norm1`` (after norm1), ``ssf_attn`` (after the attention),
``ssf_norm2`` and ``ssf_mlp``. The JAX encoder's 8-row pad of the token
count is a TPU tiling and is not ported: the attention kernels take any N.
``attn_impl`` selects every block's attention (``ops/attention``:
"auto" and "flash" the kernels on the card, "reference" the plain
version), and ``remat=True`` recomputes each block in the backward instead
of keeping its activations (``torch.utils.checkpoint``, the JAX
``nn.remat(Block)``): the recompute runs the attention kernels again, with
their log-sum-exp, and LoRA and SSF with their block.

Tensor parallelism (``parallel/tp.shard_model``) keeps a rank's shard of
each block's weights and sets the model group on its modules: ``Attention``
runs its ``num_heads / tp`` local heads through the same attention kernels,
``Mlp`` and ``SwiGLU`` their local columns, each after Megatron's *f*, and
the row-parallel ``proj``, ``fc2`` and ``w3`` reduce their fp32 partial
products before the bias (``reduce_group``). Without a group nothing
changes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from distill_any_depth_tpu_torch.configs import EncoderConfig
from distill_any_depth_tpu_torch.models.adapters import SSF, LoRALinear
from distill_any_depth_tpu_torch.ops.attention import multi_head_attention_packed
from distill_any_depth_tpu_torch.ops.derived import Derived
from distill_any_depth_tpu_torch.ops.flash_attention import banded_eligible
from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv
from distill_any_depth_tpu_torch.ops.quant import int8_matmul, shard_product
from distill_any_depth_tpu_torch.ops.quant_matmul import quantize_rows, w8a8_matmul
from distill_any_depth_tpu_torch.ops.resize import resize_matrix
from distill_any_depth_tpu_torch.ops.swiglu import swiglu_gate
from distill_any_depth_tpu_torch.ops.window import local_window_bias, window_pairs
from distill_any_depth_tpu_torch.parallel.tp import (
    all_reduce_max,
    copy_to_model,
    model_size,
    row_parallel_linear,
)
from distill_any_depth_tpu_torch.utils.profiling import backward_span, count, span

__all__ = ["QUANT_MODES", "cast_weights", "Linear", "QuantLinear",
           "LayerNorm", "Conv2d", "gelu", "PatchEmbed", "Mlp", "SwiGLU", "Attention", "Block",
           "interp_pos_embed", "PosConv", "DinoViT"]

QUANT_MODES = ("none", "int8", "int8_pallas")


def cast_weights(kept: Derived, dtype: torch.dtype, tensors, compute=None, extra=None):
    """``tensors`` cast to ``dtype`` (a list; None stays None), or with
    ``compute`` the value it makes from them in ``dtype``. Under
    ``torch.inference_mode()``, where a tensor has another dtype, the result
    is ``kept``'s: made at the first call and again after a tensor,
    ``dtype`` or ``extra`` changed. Elsewhere each call makes it anew: in
    grad mode a cast is part of autograd's graph and a trained weight
    changes every step, and a copy kept under ``torch.no_grad()`` (a
    distillation teacher) would hold its memory through training."""
    if torch.is_inference_mode_enabled() and any(
            t is not None and t.dtype != dtype for t in tensors):
        if compute is None:
            compute = lambda: [None if t is None else t.to(dtype) for t in tensors]  # noqa: E731
        return kept.get([t for t in tensors if t is not None], compute, (dtype, extra))
    if compute is not None:
        return compute()
    return [None if t is None else t.to(dtype) for t in tensors]


class Linear(nn.Linear):
    reduce_group = None  # the model group of a row-parallel shard

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.casts = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduce_group is not None:
            return row_parallel_linear(x, self.weight, self.bias, self.reduce_group)
        return F.linear(x, *cast_weights(self.casts, x.dtype, (self.weight, self.bias)))


class QuantLinear(Linear):
    """Drop-in for ``Linear`` running its GEMM as dynamic W8A8 int8, the
    counterpart of the JAX package's ``QuantDense``. It declares the same
    ``weight [out, in]`` and ``bias``, so state dicts load unchanged.
    ``mode``: "int8" (``ops/quant.int8_matmul``) or "int8_pallas" (kernel 9,
    ``ops/quant_matmul.w8a8_matmul``).

    Inference only: in grad mode a weight that requires a gradient raises.
    The int8 weight and its scales are an ``ops/derived.Derived`` of the
    weight, so an in-place update (``load_state_dict``, an optimizer step)
    quantizes anew."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mode: str = "int8"):
        if mode not in ("int8", "int8_pallas"):
            raise ValueError(f"QuantLinear mode must be 'int8' or 'int8_pallas', not {mode!r}")
        super().__init__(in_features, out_features, bias=bias)
        self.mode = mode
        self._int8 = Derived()

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(wq int8 [out, in], ws fp32 [out])``, kept until the weight
        changes."""
        return self._int8.get((self.weight,), self._quantize)

    def _quantize(self) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.weight.detach()
        amax = None
        if self.reduce_group is not None:
            # a shard's rows are slices of the unsharded rows: their scales
            # come from the absmax over every shard
            amax = all_reduce_max(w.float().abs().amax(-1, keepdim=True), self.reduce_group)
        wq, ws = quantize_rows(w, amax)
        return wq, ws[:, 0]

    def _row_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's fp32 partial products at the global scales, summed
        over the model group, then the bias as the route adds it."""
        wq, ws = self.quantized_weight()
        *lead, k = x.shape
        x2 = x.reshape(-1, k)
        amax = all_reduce_max(x2.float().abs().amax(-1, keepdim=True), self.reduce_group)
        y = shard_product(x2, amax, wq, ws, self.mode)
        dist.all_reduce(y, group=self.reduce_group)
        if self.bias is None:
            y = y.to(x.dtype)
        elif self.mode == "int8_pallas":
            y = (y + self.bias.float()).to(x.dtype)
        else:
            y = y.to(x.dtype) + self.bias.to(x.dtype)
        return y.reshape(*lead, wq.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            raise RuntimeError("int8 GEMMs are inference-only: run under torch.no_grad() "
                               "or freeze the weights (a model that trains keeps quant='none')")
        if self.reduce_group is not None:
            return self._row_parallel(x)
        matmul = w8a8_matmul if self.mode == "int8_pallas" else int8_matmul
        return matmul(x, self.weight, self.bias, x.dtype, quantized=self.quantized_weight())


def _linear(in_features: int, out_features: int, quant: str) -> Linear:
    """``Linear``, or its dynamic-W8A8 drop-in when ``quant`` is "int8"
    (the plain route) or "int8_pallas" (kernel 9); the same parameters
    either way (the JAX package's ``_dense``)."""
    if quant == "none":
        return Linear(in_features, out_features)
    return QuantLinear(in_features, out_features, mode=quant)


class LayerNorm(nn.LayerNorm):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.casts = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            *cast_weights(self.casts, x.dtype, (self.weight, self.bias)), self.eps)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.casts = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, *cast_weights(self.casts, x.dtype, (self.weight, self.bias)),
                        self.stride, self.padding, self.dilation, self.groups)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, the tanh form under bf16 (the JAX
    package's ``gelu="auto"``: its error is below bf16 rounding)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class PatchEmbed(nn.Module):
    """Conv2d(3, D, p, stride p) over ``[B, 3, H, W]`` -> ``[B, N, D]``."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    tp_group = None  # the model group under tensor parallelism

    def __init__(self, dim: int, hidden: int, quant: str = "none"):
        super().__init__()
        self.fc1 = _linear(dim, hidden, quant)
        self.fc2 = _linear(hidden, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(copy_to_model(x, self.tp_group))))


class SwiGLU(nn.Module):
    """DINOv2's fused SwiGLU FFN: ``w3(silu(x1) * x2)`` with ``x1 | x2`` the
    halves of the packed ``w12`` output, and the hidden width ``2/3`` of
    ``dim * mlp_ratio`` rounded up to a multiple of 8 (4096 for ViT-g).

    The gate is ``ops/swiglu.swiglu_gate`` on w12's packed output: one
    kernel on the card, the plain ``F.silu(x1) * x2`` on the CPU.

    Under ``utils/profiling.recording()`` each call is the span
    ``vit/swiglu`` (w12, the gate and w3) around ``vit/swiglu_gate``
    (``silu(x1) * x2`` alone), and counts ``vit/swiglu_gate_bytes``, the
    bytes the gate must move: ``x1`` and ``x2`` read, their product
    written, ``rows * 3 * hidden`` elements. Each launch of the gate's
    kernels (forward or backward), on the card only, counts
    ``kernels/gate``."""

    tp_group = None  # the model group under tensor parallelism

    def __init__(self, dim: int, mlp_ratio: float, quant: str = "none"):
        super().__init__()
        hidden = (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8
        self.w12 = _linear(dim, 2 * hidden, quant)
        self.w3 = _linear(hidden, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit/swiglu"):
            # a shard of w12 holds its columns of each half, so its output's
            # halves are this rank's x1 and x2
            x12 = self.w12(copy_to_model(x, self.tp_group))
            with span("vit/swiglu_gate"):
                count("vit/swiglu_gate_bytes", 3 * (x12.numel() // 2) * x12.element_size())
                gated = swiglu_gate(x12)
            return self.w3(gated)


class Attention(nn.Module):
    tp_group = None  # the model group under tensor parallelism

    def __init__(self, dim: int, num_heads: int, quant: str = "none", lora_rank: int = 0,
                 attn_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        if lora_rank > 0:
            self.qkv = LoRALinear(dim, 3 * dim, lora_rank)
            self.proj = LoRALinear(dim, dim, lora_rank)
        else:
            self.qkv = _linear(dim, 3 * dim, quant)
            self.proj = _linear(dim, dim, quant)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None,
                band: tuple[int, int] | None = None, pairs: int | None = None) -> torch.Tensor:
        """Attention of ``x [B, N, C]``, over every key or, windowed, under
        ``bias``/``band``. ``pairs`` (windowed only) is the live (query, key)
        pairs of one image and head: under ``utils/profiling.recording()``
        a windowed call is the span ``vit/window_attention`` (qkv, the
        attention, proj) and counts ``vit/window_pairs``, ``B * heads *
        pairs`` over this rank's heads; its backward from the attention's
        output to ``qkv`` (the banded or the biased kernel's backward on the
        card) is the span ``vit/window_attention_bwd`` and counts
        ``vit/window_bwd_pairs``, the same number."""
        # qkv columns are (q|k|v, head, dim): the layout the kernels read as
        # is, with this rank's heads of each of q, k and v under tensor
        # parallelism
        heads = self.num_heads // model_size(self.tp_group)
        if pairs is None:
            return self._attend(x, heads, bias, band)
        with span("vit/window_attention"):
            count("vit/window_pairs", x.shape[0] * heads * pairs)
            return self._attend(x, heads, bias, band, x.shape[0] * heads * pairs)

    def _attend(self, x, heads, bias, band, pairs=None):
        qkv = self.qkv(copy_to_model(x, self.tp_group))
        out = multi_head_attention_packed(qkv, heads, bias, band, self.attn_impl)
        if pairs is not None:
            backward_span("vit/window_attention_bwd", out, qkv, "vit/window_bwd_pairs", pairs)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.casts = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (gamma,) = cast_weights(self.casts, x.dtype, (self.gamma,))
        return x * gamma


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (eval path), optionally
    with LoRA on the attention and SSF adapters at four taps."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float | None,
                 quant: str = "none", ffn: str = "mlp", lora_rank: int = 0,
                 use_ssf: bool = False, attn_impl: str = "auto"):
        super().__init__()
        if ffn not in ("mlp", "swiglu"):
            raise ValueError(f"ffn must be 'mlp' or 'swiglu', not {ffn!r}")
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, quant, lora_rank, attn_impl)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = (SwiGLU(dim, mlp_ratio, quant) if ffn == "swiglu"
                    else Mlp(dim, int(dim * mlp_ratio), quant))
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.ssf_norm1, self.ssf_attn, self.ssf_norm2, self.ssf_mlp = (
            SSF(dim) if use_ssf else nn.Identity() for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None,
                band: tuple[int, int] | None = None, pairs: int | None = None) -> torch.Tensor:
        a = self.attn(self.ssf_norm1(self.norm1(x)), bias, band, pairs)
        x = x + self.ls1(self.ssf_attn(a))
        return x + self.ls2(self.ssf_mlp(self.mlp(self.ssf_norm2(self.norm2(x)))))


def interp_pos_embed(pos_embed: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
                     dtype: torch.dtype, has_cls: bool = True) -> torch.Tensor:
    """Bicubic resampling of the base-grid pos-embed (after its cls entry
    when ``has_cls``) with the ``[gh, base]`` / ``[gw, base]`` interpolation
    matrices ``mh``, ``mw``."""
    base, dim = mh.shape[1], pos_embed.shape[-1]
    n_cls = 1 if has_cls else 0
    grid = pos_embed[0, n_cls:].float().reshape(base, base, dim)
    out = torch.einsum("Hh,hwc->Hwc", mh, grid)
    out = torch.einsum("Ww,hwc->hWc", mw, out).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :n_cls].float(), out], dim=1).to(dtype)


class PosConv(nn.Module):
    """PEG conv positional encoding: a 37x37 depthwise conv over the token
    grid plus the identity, ``[B, N, C]`` tokens on a ``gh x gw`` grid. The
    conv is ``proj.0`` (the reference key ``pos_conv.proj.0``); its weights,
    the bias and the identity go to ``ops/peg_conv.peg_conv``: one kernel on
    the card, the plain ``F.conv2d(...) + x`` on the CPU.

    Under ``utils/profiling.recording()`` each call is the span
    ``vit/pos_conv`` and counts ``vit/pos_conv_flops``, the conv's
    multiply-adds twice: ``2 * B * C * 37^2 * gh * gw``. Its backward (on
    the card ``ops/peg_conv``'s autograd Function: d(x) and d(weight), each
    the forward's taps) is the span ``vit/pos_conv_bwd`` and counts
    ``vit/pos_conv_bwd_flops``, twice the forward's."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(dim, dim, 37, padding=18, groups=dim))

    def forward(self, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        b, n, c = tokens.shape
        with span("vit/pos_conv"):
            kh, kw = self.proj[0].kernel_size
            count("vit/pos_conv_flops", 2 * b * c * kh * kw * gh * gw)
            # NCHW-contiguous whatever the tokens' layout, as the kernel reads
            # it (PyTorch's depthwise kernel took 7x longer on the
            # channels-last view that contiguous tokens give, ViT-B 518^2 bs8
            # on an H100)
            x = tokens.transpose(1, 2).reshape(b, c, gh, gw).contiguous()
            conv = self.proj[0]
            weight, bias = cast_weights(conv.casts, x.dtype, (conv.weight, conv.bias))
            y = peg_conv(x, weight, bias)
            backward_span("vit/pos_conv_bwd", y, x, "vit/pos_conv_bwd_flops",
                          2 * 2 * b * c * kh * kw * gh * gw)
            return y.flatten(2).transpose(1, 2)


class DinoViT(nn.Module):
    """DINOv2 encoder with intermediate-layer taps.

    ``forward(x [B, 3, H, W], pe_step=None)`` returns ``(taps, cls_tokens)``:
    for each index in ``cfg.out_indices`` the final-normed patch tokens
    ``[B, N, C]`` and the cls token ``[B, C]`` (the register tokens, which
    sit between them in the token stream, are in neither). With
    ``cfg.tap_norm`` False the taps and cls tokens are the blocks' outputs
    before the final norm. The windowed variant (``cfg.final_taps``)
    returns the final post-norm tokens four times, its "cls token" being
    patch token 0 (it has no cls token). ``quant`` selects the blocks'
    GEMMs, ``attn_impl`` their attention and ``remat`` the recompute of
    each block in the backward (see the module docstring).
    """

    def __init__(self, cfg: EncoderConfig, quant: str = "none", attn_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, not {quant!r}")
        self.cfg = cfg
        self.remat = remat
        d = cfg.embed_dim
        n_base = (cfg.base_img_size // cfg.patch_size) ** 2
        n_cls = 1 if cfg.use_cls_token else 0
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d)) if cfg.use_cls_token else None
        self.pos_embed = nn.Parameter(torch.zeros(1, n_base + n_cls, d))
        self.register_tokens = (nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
                                if cfg.num_register_tokens else None)
        self.pos_conv = PosConv(d) if cfg.use_pos_conv else None
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, quant, cfg.ffn,
                  cfg.lora_rank, cfg.use_ssf, attn_impl)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(d, eps=1e-6)
        self._pe_mats: dict = {}  # (gh, gw, device) -> pos-embed resampling matrices
        self.pe_casts = Derived()  # the pos-embed of a grid in the compute dtype
        self.token_casts = Derived()  # the cls and register tokens in it

    def _pos_embed(self, gh: int, gw: int, dtype: torch.dtype) -> torch.Tensor:
        """The pos-embed for a ``gh x gw`` grid: DINOv2's bicubic resampling
        with the ``(g + offset) / base`` scale factor driving the source
        coordinates (``F.interpolate(scale_factor=..., mode="bicubic")``
        semantics, pinned by the tests), 37 -> 28 at 392^2.

        It runs as two small fp32 products with ``resize_matrix`` weights, as
        in the JAX package: PyTorch's CUDA bicubic kernel loops over the 768
        channels per output pixel and took 5.3 ms of a 13.2 ms ViT-B 392^2
        bs8 forward on an H100. The matrices are built once per grid and
        device (a host-to-device copy inside every forward would stall it).
        """
        return cast_weights(self.pe_casts, dtype, (self.pos_embed,),
                            lambda: self._grid_pos_embed(gh, gw, dtype), (gh, gw))

    def _grid_pos_embed(self, gh: int, gw: int, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        base = cfg.base_img_size // cfg.patch_size
        if (gh, gw) == (base, base):
            return self.pos_embed.to(dtype)
        dev = self.pos_embed.device
        mats = self._pe_mats.get((gh, gw, dev))
        if mats is None:
            # plain tensors even under inference mode: a training forward
            # saves them for its backward, which an inference tensor refuses
            with torch.inference_mode(False):
                mats = tuple(
                    torch.from_numpy(resize_matrix(base, g, "bicubic", False,
                                                   (g + cfg.interpolate_offset) / base)).to(dev)
                    for g in (gh, gw)
                )
            if not torch.compiler.is_compiling():  # a trace's constants are its own
                self._pe_mats[(gh, gw, dev)] = mats
        return interp_pos_embed(self.pos_embed, *mats, dtype, cfg.use_cls_token)

    def _attention_mask(self, gh: int, gw: int, n: int, device: torch.device,
                        dtype: torch.dtype):
        """``(bias, band)`` for every block: the local-window bias of the
        grid (built once per grid and device), and, with no prefix token,
        the band ``(gw, window)``. A grid that the banded kernel takes needs
        no bias, so none is built for it."""
        window = self.cfg.window_size
        if window is None:
            return None, None
        n_prefix = (1 if self.cfg.use_cls_token else 0) + self.cfg.num_register_tokens
        band = (gw, window) if n_prefix == 0 else None
        if banded_eligible(n, band):
            return None, band
        return local_window_bias(gh, gw, window, n_prefix, device, dtype), band

    def forward(self, x: torch.Tensor, pe_step=None):
        cfg = self.cfg
        b, _, h, w = x.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} must be a multiple of patch {p}")
        gh, gw = h // p, w // p
        tokens = self.patch_embed(x)
        cls, reg = cast_weights(self.token_casts, x.dtype, (self.cls_token, self.register_tokens))
        if cls is not None:
            cls = cls.expand(b, -1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        if self.pos_conv is None:
            tokens = tokens + self._pos_embed(gh, gw, x.dtype)
        else:
            # PE -> GPE blend: the coefficient ramps 0 -> 1 between
            # pe_start_step and pe_total_step; inference (pe_step=None) is
            # past the schedule and reads no pos-embed
            gpe = self.pos_conv(tokens, gh, gw)
            if pe_step is None:
                tokens = tokens + gpe
            else:
                step = torch.as_tensor(pe_step, dtype=torch.float32, device=x.device)
                coef = ((step - cfg.pe_start_step) / (cfg.pe_total_step - cfg.pe_start_step))
                coef = coef.clamp(0.0, 1.0).to(x.dtype)
                tokens = tokens + (1.0 - coef) * self._pos_embed(gh, gw, x.dtype) + coef * gpe
        n_prefix = 1 if cfg.use_cls_token else 0
        if reg is not None:
            # the registers go between the cls token and the patch tokens,
            # after the position embedding (which has no entries for them)
            reg = reg.expand(b, -1, -1)
            tokens = torch.cat([tokens[:, :n_prefix], reg, tokens[:, n_prefix:]], dim=1)
            n_prefix += cfg.num_register_tokens
        # a token-major residual stream: without a cls token to concatenate,
        # the patch embedding's tokens are a transposed view, and every
        # elementwise op of the blocks would run strided
        tokens = tokens.contiguous()
        bias, band = self._attention_mask(gh, gw, tokens.shape[1], x.device, x.dtype)
        pairs = None if cfg.window_size is None else window_pairs(gh, gw, cfg.window_size,
                                                                   n_prefix)
        raw = {}
        # the blocks draw no random numbers: no RNG state to keep for the
        # recompute
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                tokens = torch.utils.checkpoint.checkpoint(blk, tokens, bias, band, pairs,
                                                           use_reentrant=False,
                                                           preserve_rng_state=False)
            else:
                tokens = blk(tokens, bias, band, pairs)
            if i in cfg.out_indices:
                raw[i] = tokens
        if cfg.final_taps:
            t = self.norm(tokens)
            return [t[:, n_prefix:]] * 4, [t[:, 0]] * 4
        taps, cls_tokens = [], []
        for i in cfg.out_indices:
            t = self.norm(raw[i]) if cfg.tap_norm else raw[i]
            cls_tokens.append(t[:, 0])
            taps.append(t[:, n_prefix:])
        return taps, cls_tokens
