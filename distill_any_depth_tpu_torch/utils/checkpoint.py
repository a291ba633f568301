"""Checkpoint I/O: safetensors weights in the reference layout, the train
state for an exact resume, and the key conversion.

Counterpart of distill_any_depth_tpu/utils/checkpoint.py
(``save_safetensors``, ``load_safetensors``, ``convert_checkpoint``,
``save_train_state``, ``restore_train_state``) with the key handling of
distill_any_depth_tpu/utils/torch_interop.py (``normalize_torch_keys`` and
``torch_to_params``), so that the port writes files the JAX package reads
and loads and refuses the same files:

- ``backbone.*`` -> ``pretrained.*`` (teacher checkpoints);
- ``pretrained.blocks.0.{i}.*`` -> ``pretrained.blocks.{i}.*`` (the
  chunked block namespace of the teacher ViT);
- ``pretrained.mask_token`` and a refinenet's ``resConfUnit1.*`` where the
  model has none (``refinenet4``, which fuses no skip) are keys that
  ``torch_to_params`` maps and the forward never reads: they are dropped;
- any other key the model does not hold, and any key it holds that the
  file lacks, raises ``KeyError``.

The safetensors reader and writer are the port's own (no ``safetensors``
package): an 8-byte little-endian header length, a JSON header mapping each
name to ``{dtype, shape, data_offsets}`` (and an optional
``__metadata__`` of strings), padded with spaces to 8 bytes, then the raw
little-endian bytes. A file is read with one ``readinto`` into one buffer,
of which each tensor is a view. The train state, which orbax keeps in the
JAX package, is a ``torch.save`` of ``TrainState.state_dict()``.
"""
from __future__ import annotations

import json
import math
import os
import re
import struct
import sys
from typing import Mapping

import torch

__all__ = ["normalize_keys", "load_state_dict", "load_state_dict_file", "read_safetensors",
           "write_safetensors", "save_safetensors", "convert_checkpoint", "save_train_state",
           "restore_train_state"]

_CHUNKED = re.compile(r"^pretrained\.blocks\.0\.(\d+)\.")
_UNUSED = re.compile(r"^(pretrained\.mask_token|depth_head\.scratch\.refinenet\d\.resConfUnit1\..+)$")

# the dtypes read and written, in the order the safetensors format lays
# tensors out (larger alignment first, then by name)
_DTYPES = {"I64": torch.int64, "F32": torch.float32, "I32": torch.int32,
           "BF16": torch.bfloat16, "F16": torch.float16}
_NAMES = {v: k for k, v in _DTYPES.items()}
_ORDER = {name: i for i, name in enumerate(_DTYPES)}
_STATE_FILE = "state.pt"  # inside a train-state directory


def _little_endian() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors I/O assumes a little-endian host")


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a safetensors file, as views of one CPU buffer that a
    single ``readinto`` fills (a tensor whose offset is not aligned to its
    element size is copied out). F32, F16, BF16, I64 and I32 are read; any
    other dtype raises ``ValueError`` naming it."""
    _little_endian()
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, info in header.items():
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                                 f"only {sorted(_DTYPES)} are read")
        size = max((info["data_offsets"][1] for info in header.values()), default=0)
        data = torch.empty(size, dtype=torch.uint8)
        if size and f.readinto(memoryview(data.numpy())) != size:
            raise ValueError(f"{path}: truncated data section")
    out = {}
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if math.prod(info["shape"]) * dtype.itemsize != end - begin:
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape "
                             f"{info['shape']}")
        raw = data[begin:end]
        if begin % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write ``tensors`` (CPU or device, any layout) as a safetensors file,
    laid out as the ``safetensors`` package lays them out (no metadata).
    The file is written beside ``path`` and renamed over it, so a reader
    never sees a partial file."""
    _little_endian()
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; only "
                             f"{sorted(_DTYPES)} are written")
    names = sorted(tensors, key=lambda k: (_ORDER[_NAMES[tensors[k].dtype]], k))
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)


def save_safetensors(path: str, model: torch.nn.Module) -> None:
    """``model``'s weights as a reference-layout fp32 safetensors file: its
    parameters under their names, the key set that JAX ``params_to_torch``
    emits (buffers are not written)."""
    write_safetensors(path, {k: p.detach().float() for k, p in model.named_parameters()})


def normalize_keys(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``state`` with the reference's key variants mapped onto the
    ``pretrained.blocks.{i}`` namespace."""
    out = {}
    for k, v in state.items():
        if k.startswith("backbone."):
            k = "pretrained." + k[len("backbone."):]
        k = _CHUNKED.sub(r"pretrained.blocks.\1.", k)
        out[k] = v
    return out


def load_state_dict(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Load a reference-layout ``state`` into ``model``: keys normalized,
    the unused ones that the model lacks dropped, everything else strict.
    The parameters are updated in place (``copy_``), which bumps their
    version counters, so the caches keyed on them (``ops/dpt_tail.
    WeightCache``, ``ops/quant.QuantLinear``) rebuild."""
    held = model.state_dict()
    state = {k: v for k, v in normalize_keys(state).items()
             if k in held or not _UNUSED.match(k)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"unmapped checkpoint keys ({len(unexpected)}): {unexpected[:8]}")
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys: {missing[:8]}")


def load_state_dict_file(model: torch.nn.Module, path: str) -> None:
    """``load_state_dict`` from a safetensors file."""
    load_state_dict(model, read_safetensors(path))


def convert_checkpoint(in_path: str, out_path: str) -> int:
    """``pretrained.*`` -> ``backbone.*``: a DepthAnything-V2 checkpoint in
    the teacher architecture's namespace, every tensor as it was. Returns
    the number of renamed keys."""
    out, n = {}, 0
    for k, v in read_safetensors(in_path).items():
        if k.startswith("pretrained."):
            k = "backbone." + k[len("pretrained."):]
            n += 1
        out[k] = v
    write_safetensors(out_path, out)
    return n


def save_train_state(path: str, state) -> None:
    """``state.state_dict()`` (a ``train/state.TrainState``) into the
    directory ``path``, replacing what it held."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, target)


def restore_train_state(path: str) -> dict:
    """The saved train state of ``path``: a directory written by
    ``save_train_state``, or a run's output directory, which holds one
    under ``train_state/``. Tensors come back on the CPU; pass the result to
    ``TrainState.load_state_dict``."""
    if not os.path.exists(os.path.join(path, _STATE_FILE)):
        nested = os.path.join(path, "train_state")
        if os.path.exists(os.path.join(nested, _STATE_FILE)):
            path = nested
    target = os.path.join(path, _STATE_FILE)
    if not os.path.exists(target):
        raise FileNotFoundError(f"no train state in {path} (nor in {path}/train_state)")
    return torch.load(target, map_location="cpu", weights_only=True)
