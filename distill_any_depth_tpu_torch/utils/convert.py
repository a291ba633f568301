"""JAX param tree -> the port's state dict.

The port's own copy of the mapping in
distill_any_depth_tpu/utils/torch_interop.py ``params_to_torch``, for the
modules this package has. It takes the flax param tree as nested dicts of
numpy arrays, so the weights of one JAX model load into the port with
``load_state_dict(strict=True)``:

- Dense ``[I, O]`` -> Linear ``[O, I]`` (SwiGLU's ``mlp/w12`` and
  ``mlp/w3`` too), or a 1x1 conv ``[O, I, 1, 1]``;
- ``cls_token``, ``pos_embed`` and ``register_tokens`` as they are;
- conv HWIO ``[kh, kw, I, O]`` -> OIHW ``[O, I, kh, kw]``;
- patch-embed matmul ``[p*p*C, D]`` ((ph, pw, c) order) -> conv OIHW;
- the PEG depthwise conv ``pos_conv/proj`` HWIO ``[37, 37, 1, C]`` ->
  ``pos_conv.proj.0`` ``[C, 1, 37, 37]``;
- PatchExpand ``[I, k*k*O]`` ((kh, kw, o) order) -> ConvTranspose2d
  ``[I, O, k, k]``;
- LayerNorm ``scale`` -> ``weight``; LayerScale ``ls{1,2}_gamma`` ->
  ``ls{1,2}.gamma``;
- the adapters as ``params_to_torch`` writes them: a block's LoRA
  ``lora_a`` ``[in, r]`` -> ``lora_A`` ``[r, in]`` and ``lora_b`` ``[r,
  out]`` -> ``lora_B`` ``[out, r]`` times 8 (the reference LoRALinear's
  alpha 1 against the JAX package's 8: a power of two, so exact), and every
  SSF parameter verbatim under ``adapters.<its JAX path>``.

The result is the reference layout of a file, not the port's module state:
``utils/checkpoint.load_state_dict`` loads it into a model (for a model
without adapters the two are the same, and ``load_state_dict(strict=True)``
takes it as it is). A tensor-parallel rank keeps its shard of it through
``parallel/tp.shard_state_dict``, which reads the same names.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from distill_any_depth_tpu_torch.configs import ModelConfig
from distill_any_depth_tpu_torch.utils.checkpoint import LORA_B_FILE_SCALE

__all__ = ["params_from_jax"]


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v, np.float32)
    return flat


def _oihw(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _dense_as_conv(k: np.ndarray) -> np.ndarray:
    return k.T[:, :, None, None]


def _encoder_key(path: tuple[str, ...], v: np.ndarray, patch: int) -> tuple[str, np.ndarray]:
    name = path[0]
    if name in ("cls_token", "pos_embed", "register_tokens"):
        return f"pretrained.{name}", v
    if name == "patch_embed":
        if path[1] == "kernel":
            return "pretrained.patch_embed.proj.weight", v.reshape(patch, patch, -1, v.shape[-1]).transpose(3, 2, 0, 1)
        return "pretrained.patch_embed.proj.bias", v
    if name == "pos_conv":  # PEG depthwise conv: HWIO [37, 37, 1, C] -> [C, 1, 37, 37]
        leaf = "weight" if path[-1] == "kernel" else "bias"
        return f"pretrained.pos_conv.proj.0.{leaf}", _oihw(v) if leaf == "weight" else v
    if name == "norm":
        return f"pretrained.norm.{'weight' if path[1] == 'scale' else 'bias'}", v
    if name.startswith("blocks_"):
        base = f"pretrained.blocks.{name.split('_')[1]}"
        rest = path[1:]
        if rest[0] in ("ls1_gamma", "ls2_gamma"):
            return f"{base}.{rest[0][:3]}.gamma", v
        if rest[0] in ("norm1", "norm2"):
            return f"{base}.{rest[0]}.{'weight' if rest[1] == 'scale' else 'bias'}", v
        mod = ".".join(rest[:-1])  # attn.qkv, attn.proj, mlp.fc1/fc2 or mlp.w12/w3
        if rest[-1] == "lora_a":
            return f"{base}.{mod}.lora_A", v.T
        if rest[-1] == "lora_b":
            return f"{base}.{mod}.lora_B", v.T * LORA_B_FILE_SCALE
        return (f"{base}.{mod}.weight", v.T) if rest[-1] == "kernel" else (f"{base}.{mod}.bias", v)
    raise KeyError(f"unmapped encoder param {'/'.join(path)}")


def _head_key(path: tuple[str, ...], v: np.ndarray) -> tuple[str, np.ndarray]:
    sub, leaf = path[0], path[-1]
    is_kernel = leaf == "kernel"
    if sub.startswith("projects_"):
        key = f"depth_head.projects.{sub.split('_')[1]}"
        return (f"{key}.weight", _dense_as_conv(v)) if is_kernel else (f"{key}.bias", v)
    if sub in ("resize_0", "resize_1"):
        key = f"depth_head.resize_layers.{sub[-1]}"
        if is_kernel:
            f = 4 if sub == "resize_0" else 2
            return f"{key}.weight", v.reshape(v.shape[0], f, f, -1).transpose(0, 3, 1, 2)
        return f"{key}.bias", v
    if sub == "resize_3":
        key = "depth_head.resize_layers.3"
        return (f"{key}.weight", _oihw(v)) if is_kernel else (f"{key}.bias", v)
    if sub.startswith("scratch_"):  # scratch_{n}_rn, conv without bias
        return f"depth_head.scratch.layer{sub.split('_')[1]}_rn.weight", _oihw(v)
    if sub.startswith("refinenet"):
        base = f"depth_head.scratch.{sub}"
        if path[1] in ("rcu1", "rcu2"):
            unit = "resConfUnit1" if path[1] == "rcu1" else "resConfUnit2"
            key = f"{base}.{unit}.{path[2]}"
            return (f"{key}.weight", _oihw(v)) if is_kernel else (f"{key}.bias", v)
        if path[1] == "out_conv":
            key = f"{base}.out_conv"
            return (f"{key}.weight", _dense_as_conv(v)) if is_kernel else (f"{key}.bias", v)
    if sub in ("output_conv1", "output_conv2_0"):
        key = "depth_head.scratch." + ("output_conv1" if sub == "output_conv1" else "output_conv2.0")
        return (f"{key}.weight", _oihw(v)) if is_kernel else (f"{key}.bias", v)
    if sub == "output_conv2_2":
        key = "depth_head.scratch.output_conv2.2"
        return (f"{key}.weight", _dense_as_conv(v)) if is_kernel else (f"{key}.bias", v)
    if sub.startswith("readout_"):
        key = f"depth_head.readout_projects.{sub.split('_')[1]}.0"
        return (f"{key}.weight", v.T) if is_kernel else (f"{key}.bias", v)
    raise KeyError(f"unmapped head param {'/'.join(path)}")


def params_from_jax(params: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The flax ``DepthModel`` param tree as the port's state dict (fp32)."""
    out: dict[str, torch.Tensor] = {}
    patch = cfg.encoder.patch_size
    for path, v in _flatten(params).items():
        if any(seg.startswith("ssf_") for seg in path):
            key, arr = "adapters." + ".".join(path), v
        elif path[0] == "pretrained":
            key, arr = _encoder_key(path[1:], v, patch)
        elif path[0] == "depth_head":
            key, arr = _head_key(path[1:], v)
        else:
            raise KeyError(f"unmapped param {'/'.join(path)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out
