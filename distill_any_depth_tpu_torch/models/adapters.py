"""Parameter-efficient tuning adapters: LoRA and SSF.

Counterpart of distill_any_depth_tpu/models/adapters.py (``LoRADense``,
``ssf``, ``adapter_label_tree``):

- ``LoRALinear``: the encoder's ``Linear`` plus a low-rank update
  ``(x A) B * alpha / r`` with alpha 8, ``A ~ N(0, 1/r)`` and ``B = 0``, so
  that it is the plain layer at init. Its parameters are ``lora_A``
  ``[r, in]`` and ``lora_B`` ``[out, r]``: the JAX ``lora_a`` and
  ``lora_b`` transposed, in the reference's LoRALinear shapes.
  ``utils/checkpoint`` writes ``lora_B`` to a file times 8, as the JAX
  package's ``params_to_torch`` does;
- ``SSF``: ``x * gamma + beta`` on the channel axis, gamma 1 and beta 0 at
  init;
- ``adapter_parameters``: the parameters an adapter-only run trains.

Under tensor parallelism (``parallel/tp``) a ``LoRALinear`` on the
column-parallel ``qkv`` keeps its rows of ``lora_B`` and sums ``lora_A``'s
gradient over the model group (``a_group``); on the row-parallel ``proj``
(``reduce_group``) ``lora_A`` takes the input shard and its rank-r output
is reduced before the replicated ``lora_B``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distill_any_depth_tpu_torch.parallel.tp import copy_to_model, row_parallel_linear

__all__ = ["LORA_ALPHA", "LoRALinear", "SSF", "is_adapter_name", "adapter_parameters"]

LORA_ALPHA = 8.0


class LoRALinear(nn.Linear):
    """``Linear`` with an additive rank-``rank`` update. Every weight is cast
    to the dtype of the input, as the encoder's ``Linear`` casts its own."""

    reduce_group = None  # the model group of a row-parallel shard
    a_group = None  # the model group of a column-parallel shard

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__(in_features, out_features)
        if rank <= 0:
            raise ValueError(f"LoRA rank must be positive, not {rank}")
        self.rank = rank
        self.lora_A = nn.Parameter(torch.empty(rank, in_features))
        self.lora_B = nn.Parameter(torch.zeros(out_features, rank))
        self.reset_lora()

    @torch.no_grad()
    def reset_lora(self, generator: torch.Generator | None = None) -> None:
        """A ~ N(0, 1/r) (standard deviation 1/r), B = 0."""
        self.lora_A.normal_(0.0, 1.0 / self.rank, generator=generator)
        self.lora_B.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.reduce_group is not None:
            y = row_parallel_linear(x, self.weight, self.bias, self.reduce_group)
            u = row_parallel_linear(x, self.lora_A, None, self.reduce_group)
        else:
            y = F.linear(x, self.weight.to(dt), self.bias.to(dt))
            u = F.linear(x, copy_to_model(self.lora_A, self.a_group).to(dt))
        return y + F.linear(u, self.lora_B.to(dt)) * (LORA_ALPHA / self.rank)


class SSF(nn.Module):
    """Scale and shift on the last axis; the identity at init."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype) + self.beta.to(x.dtype)


def is_adapter_name(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) is a LoRA
    or SSF parameter: the JAX ``adapter_label_tree``'s "adapter" label."""
    return any(part in ("lora_A", "lora_B") or part.startswith("ssf")
               for part in name.split("."))


def adapter_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The LoRA and SSF parameters of ``model``, in ``named_parameters``
    order."""
    return [p for name, p in model.named_parameters() if is_adapter_name(name)]
