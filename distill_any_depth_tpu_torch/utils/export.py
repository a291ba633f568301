"""Ahead-of-time model export for serving.

Counterpart of distill_any_depth_tpu/utils/export.py: the depth forward at
a fixed shape as a ``torch.export`` program, serialized with
``torch.export.save``, which a process loads and runs without the model
code. The kernels stay in the program as single nodes: the port's
wrappers call their registered ops under tracing (``dad::packed_attention``,
``dad::bias_attention``, ``dad::banded_attention``, ``dad::dpt_tail``,
``dad::w8a8_matmul``, ``dad::swiglu_gate``, ``dad::peg_conv``;
``ops/flash_attention``, ``ops/dpt_tail``, ``ops/quant_matmul``,
``ops/swiglu``, ``ops/peg_conv``), whose CUDA implementations launch the
kernels and whose CPU implementations are the plain versions. Loading
imports those five modules, which register the ops, and nothing of
``models/``.

Two artifact flavours, as in the JAX package:

- ``export_forward`` keeps the weights in the program: one file.
- ``export_forward_with_params`` takes the weights as an argument at call
  time (``torch.func.functional_call``) and writes them beside the
  program as safetensors, through the port's own writer
  (``utils/checkpoint``), keyed by the model's parameter names.

The program takes the port's NCHW input ``[B, 3, H, W]`` (the JAX artifact
takes NHWC) and returns the depth ``[B, H, W]`` in fp32.
"""
from __future__ import annotations

import io

import torch
from torch import nn

# registers the dad:: ops that the programs call
from distill_any_depth_tpu_torch.ops import (  # noqa: F401
    dpt_tail,
    flash_attention,
    peg_conv,
    quant_matmul,
    swiglu,
)
from distill_any_depth_tpu_torch.utils.checkpoint import read_safetensors, write_safetensors

__all__ = [
    "export_forward",
    "load_exported",
    "export_forward_with_params",
    "load_exported_with_params",
]


class _Depth(nn.Module):
    """The model's depth in fp32."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[0].float()


class _DepthOf(nn.Module):
    """The depth of ``model`` run with the weights given at call time. The
    model is held outside the module tree, so the program owns no weights."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["model"] = model

    def forward(self, params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, params, (x,))[0].float()


def _example(model: nn.Module, image_size: int, batch_size: int,
             dtype: torch.dtype) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.zeros((batch_size, 3, image_size, image_size), dtype=dtype, device=device)


def _save(program) -> bytes:
    """The program's bytes, without the example inputs it was traced with
    (which would carry the weights of a weights-as-arguments export)."""
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _load(blob: bytes):
    return torch.export.load(io.BytesIO(blob)).module()


def export_forward(model: nn.Module, image_size: int, batch_size: int = 1,
                   dtype: torch.dtype = torch.float32) -> bytes:
    """``model``'s depth at input ``[batch_size, 3, image_size,
    image_size]`` of ``dtype`` on its device, as the bytes of a saved
    ``torch.export`` program that holds the weights."""
    x = _example(model, image_size, batch_size, dtype)
    with torch.no_grad():
        program = torch.export.export(_Depth(model), (x,))
    return _save(program)


def load_exported(blob: bytes):
    """An ``export_forward`` artifact -> ``callable(x) -> depth``."""
    module = _load(blob)

    def call(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(x)

    return call


def export_forward_with_params(model: nn.Module, weights_path: str, image_size: int,
                               batch_size: int = 1,
                               dtype: torch.dtype = torch.float32) -> bytes:
    """Weights-as-arguments export: the program takes the parameters at call
    time, and they are written to ``weights_path`` as safetensors, keyed by
    ``model``'s parameter names. Returns the program's bytes."""
    # in name order: the program takes the dict in the order it was traced with
    params = {k: p.detach() for k, p in sorted(model.named_parameters())}
    x = _example(model, image_size, batch_size, dtype)
    with torch.no_grad():
        program = torch.export.export(_DepthOf(model), (params, x))
    write_safetensors(weights_path, params)
    return _save(program)


def load_exported_with_params(blob: bytes, weights_path: str,
                              device: str | torch.device = "cuda"):
    """An ``export_forward_with_params`` artifact and its weights file ->
    ``callable(x) -> depth``, the weights moved to ``device`` once."""
    module = _load(blob)
    params = {k: v.to(device) for k, v in sorted(read_safetensors(weights_path).items())}

    def call(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(params, x)

    return call
