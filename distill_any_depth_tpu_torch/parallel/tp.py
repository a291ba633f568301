"""Tensor parallelism over the model group (Megatron placement).

Counterpart of distill_any_depth_tpu/parallel/tp.py (``tp_param_specs``,
``shard_params``). The JAX package annotates the placement and lets GSPMD
insert the collectives; here the placement is explicit and so are the two
collectives of Megatron-LM, *f* (identity forward, all-reduce backward)
before a column-parallel layer and *g* (all-reduce forward, identity
backward) after a row-parallel one:

- column-split (weight dim 0 in torch's ``[out, in]`` layout, and the
  bias): attention ``qkv``, MLP ``fc1``, SwiGLU ``w12``;
- row-split (weight dim 1; the bias is added once, after the reduce):
  attention ``proj``, MLP ``fc2``, SwiGLU ``w3``;
- LoRA on ``qkv``: ``lora_B``'s rows split as the qkv columns, ``lora_A``
  replicated with its gradient summed over the group; on ``proj``:
  ``lora_A`` takes the input shard, its rank-r output is reduced before the
  replicated ``lora_B``;
- everything else replicated: norms, embeddings, LayerScale, SSF, the PEG
  conv, registers and the DPT head.

Packed layouts are split block by block, not contiguously: ``qkv``'s
``[3C, C]`` weight is ``(q|k|v, head, dim)`` and each rank takes its heads
from each of q, k and v; ``w12``'s ``x1 | x2`` halves each give a rank its
share. A contiguous split would run and compute another function.

The reductions run in fp32 (the row-parallel partial products are fp32
before *g*, the gradients of *f* are reduced in fp32), through
``all_reduce`` and ``broadcast`` alone, which gloo also runs on CUDA
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["Split", "tp_plan", "model_size", "shard_tensor", "shard_state_dict",
           "gather_tensors", "gather_state_dict", "shard_model", "copy_to_model",
           "reduce_from_model", "all_reduce_max", "row_parallel_linear"]


@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor split along ``dim``, each of its ``parts`` packed blocks on
    its own (3 for q|k|v, 2 for SwiGLU's x1|x2)."""

    dim: int
    parts: int = 1


# (parent module, module, parameter) -> split; the parent is the block's
# "attn" or "mlp"
_PLAN = {
    ("attn", "qkv", "weight"): Split(0, 3), ("attn", "qkv", "bias"): Split(0, 3),
    ("attn", "qkv", "lora_B"): Split(0, 3),
    ("attn", "proj", "weight"): Split(1), ("attn", "proj", "lora_A"): Split(1),
    ("mlp", "fc1", "weight"): Split(0), ("mlp", "fc1", "bias"): Split(0),
    ("mlp", "w12", "weight"): Split(0, 2), ("mlp", "w12", "bias"): Split(0, 2),
    ("mlp", "fc2", "weight"): Split(1), ("mlp", "w3", "weight"): Split(1),
}
_ROW = {("attn", "proj"), ("mlp", "fc2"), ("mlp", "w3")}


def _split_of(name: str) -> Split | None:
    return _PLAN.get(tuple(name.split(".")[-3:]))


def tp_plan(names) -> dict[str, Split]:
    """The split of every sharded name among ``names`` (parameter names,
    or the keys of a state dict in the reference layout); a name that is
    not in the result is replicated."""
    return {n: s for n in names if (s := _split_of(n)) is not None}


def model_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def shard_tensor(t: torch.Tensor, split: Split, index: int, size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of the full tensor ``t`` (a new tensor)."""
    n = t.shape[split.dim]
    per_part = n // split.parts
    if n % split.parts or per_part % size:
        raise ValueError(f"cannot split {split.parts} blocks of dim {split.dim} of a "
                         f"{tuple(t.shape)} tensor over {size} ranks")
    c = per_part // size
    return torch.cat([t.narrow(split.dim, p * per_part + index * c, c)
                      for p in range(split.parts)], split.dim)


def _unshard(shards: list[torch.Tensor], split: Split) -> torch.Tensor:
    c = shards[0].shape[split.dim] // split.parts
    return torch.cat([s.narrow(split.dim, p * c, c) for p in range(split.parts) for s in shards],
                     split.dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], index: int,
                     size: int) -> dict[str, torch.Tensor]:
    """Shard ``index`` of ``size`` of a full state dict (the module's own or
    the reference layout, e.g. ``utils/convert.params_from_jax``'s)."""
    plan = tp_plan(state)
    return {k: shard_tensor(v, plan[k], index, size) if k in plan else v
            for k, v in state.items()}


def gather_tensors(tensors: list[torch.Tensor], splits: list, group) -> list[torch.Tensor]:
    """The full tensors of this rank's shards (``splits[i]`` None for a
    replicated tensor, which is returned as it is), gathered over the model
    ``group`` by one ``broadcast`` from each rank of a flat buffer per dtype.
    Every rank of the group calls it with tensors of the same shapes."""
    idx = [i for i, s in enumerate(splits) if s is not None]
    out = list(tensors)
    if group is None or not idx:
        return out
    size = model_size(group)
    me = dist.get_rank(group)
    for dtype in dict.fromkeys(tensors[i].dtype for i in idx):  # one order on every rank
        sel = [i for i in idx if tensors[i].dtype == dtype]
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in sel])
        bufs = [flat if r == me else torch.empty_like(flat) for r in range(size)]
        for r, buf in enumerate(bufs):
            dist.broadcast(buf, src=dist.get_global_rank(group, r), group=group)
        offset = 0
        for i in sel:
            numel, shape = tensors[i].numel(), tensors[i].shape
            out[i] = _unshard([b[offset:offset + numel].view(shape) for b in bufs], splits[i])
            offset += numel
    return out


def gather_state_dict(state: Mapping[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """The full state dict of this rank's shard ``state`` (inverse of
    ``shard_state_dict``); a collective over the model ``group``."""
    plan = tp_plan(state)
    keys = list(state)
    full = gather_tensors([state[k] for k in keys], [plan.get(k) for k in keys], group)
    return dict(zip(keys, full))


def shard_model(model: torch.nn.Module, mesh) -> dict[str, Split]:
    """Keep this rank's shard of ``model``'s full weights in place and wire
    its blocks to the model group: the attention and FFN modules run *f*
    and their local heads or columns, the row-parallel layers reduce.
    Returns the plan of the sharded parameters (empty when ``tp`` is 1).
    ``ValueError`` when a block's heads do not split over ``tp``."""
    if mesh is None or mesh.tp == 1:
        return {}
    group = mesh.model_group
    for name, m in model.named_modules():
        heads = getattr(m, "num_heads", None)
        if heads is not None and heads % mesh.tp:
            raise ValueError(f"{name} has {heads} heads, which do not split over tp={mesh.tp}")
    plan = tp_plan([n for n, _ in model.named_parameters()])
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in plan:
                p.data = shard_tensor(p.data, plan[name], mesh.model_index, mesh.tp)
    for name, m in model.named_modules():
        parts = tuple(name.split(".")[-2:])
        if parts[-1] in ("attn", "mlp"):
            m.tp_group = group
        elif parts in _ROW:
            m.reduce_group = group
        elif parts == ("attn", "qkv") and hasattr(m, "lora_A"):
            m.a_group = group
    return plan


def _all_reduce_fp32(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` in fp32, in ``x``'s dtype."""
    y = x.float().clone() if x.dtype == torch.float32 else x.float()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """f before a column-parallel layer (the identity without a group)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """g after a row-parallel product (the identity without a group)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, without gradient."""
    return x if group is None else _all_reduce_fp32(x.detach(), group, dist.ReduceOp.MAX)


def _fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` accumulated and returned in fp32: in bf16 on the card,
    the GEMM's fp32 accumulator before its rounding."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.device.type == "cuda":
        return torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                        out_dtype=torch.float32).reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


class _RowParallelProduct(torch.autograd.Function):
    """g(x_shard @ w_shard.T) in fp32; the backward runs in the compute
    dtype, as the single-process layer's does."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        y = _fp32_product(x, w)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w
        dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx, dw, None


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        group) -> torch.Tensor:
    """A row-parallel layer: the fp32 partial products reduced over
    ``group``, the bias added in fp32, one cast to ``x``'s dtype."""
    y = _RowParallelProduct.apply(x, weight.to(x.dtype), group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
