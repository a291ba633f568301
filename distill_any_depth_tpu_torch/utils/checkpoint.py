"""Reference-layout state dicts into the port's models.

The port's own copy of the key handling of
distill_any_depth_tpu/utils/torch_interop.py (``normalize_torch_keys`` and
``torch_to_params``), so that the port loads and refuses the same files:

- ``backbone.*`` -> ``pretrained.*`` (teacher checkpoints);
- ``pretrained.blocks.0.{i}.*`` -> ``pretrained.blocks.{i}.*`` (the
  chunked block namespace of the teacher ViT);
- ``pretrained.mask_token`` and a refinenet's ``resConfUnit1.*`` where the
  model has none (``refinenet4``, which fuses no skip) are keys that
  ``torch_to_params`` maps and the forward never reads: they are dropped;
- any other key the model does not hold, and any key it holds that the
  file lacks, raises ``KeyError``.
"""
from __future__ import annotations

import re
from typing import Mapping

import torch

__all__ = ["normalize_keys", "load_state_dict", "load_state_dict_file"]

_CHUNKED = re.compile(r"^pretrained\.blocks\.0\.(\d+)\.")
_UNUSED = re.compile(r"^(pretrained\.mask_token|depth_head\.scratch\.refinenet\d\.resConfUnit1\..+)$")


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
    the unused ones that the model lacks dropped, everything else strict."""
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
    from safetensors.torch import load_file

    load_state_dict(model, load_file(path))
