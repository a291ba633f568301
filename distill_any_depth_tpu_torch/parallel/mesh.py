"""The ``(data, model)`` rank grid.

Counterpart of distill_any_depth_tpu/parallel/mesh.py (``make_mesh``,
``shard_batch``, ``host_local_batch_size``). The JAX package lays its
devices out as ``reshape(dp, model)``; here each device is one process, and
rank ``r`` sits at ``(d, m) = divmod(r, tp)``. The model group of a rank is
the ``tp`` ranks that share its ``d`` (they hold the shards of one model),
its data group the ``dp`` ranks that share its ``m`` (they hold the same
shard and see other rows of the batch). A group of one rank is ``None``:
no collective runs over it.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from distill_any_depth_tpu_torch.parallel import launch

__all__ = ["Mesh", "make_mesh", "host_local_batch_size", "shard_batch"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    rank: int
    data_group: object = None   # ProcessGroup of this rank's data ranks (None if dp == 1)
    model_group: object = None  # ProcessGroup of this rank's model ranks (None if tp == 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """The grid of ``dp * tp`` ranks; every rank calls it with the same
    arguments (it creates the groups in one order). ``ValueError`` unless
    the world holds exactly ``dp * tp`` processes."""
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be positive, got dp={dp} tp={tp}")
    world = launch.process_count()
    if world != dp * tp:
        raise ValueError(f"the world has {world} processes but dp * tp = {dp} * {tp} = "
                         f"{dp * tp}: launch dp * tp processes (torchrun --nproc_per_node)")
    rank = launch.process_index()
    d, m = divmod(rank, tp)
    data_group = model_group = None
    if tp > 1:
        for dd in range(dp):
            g = dist.new_group([dd * tp + mm for mm in range(tp)])
            if dd == d:
                model_group = g
    if dp > 1:
        for mm in range(tp):
            g = dist.new_group([dd * tp + mm for dd in range(dp)])
            if mm == m:
                data_group = g
    return Mesh(dp, tp, rank, data_group, model_group)


def host_local_batch_size(dp: int, global_batch: int) -> int:
    """The rows of a global batch that each of ``dp`` data ranks takes."""
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by data={dp}")
    return global_batch // dp


def shard_batch(batch: dict, data_index: int, dp: int) -> dict:
    """Data rank ``data_index``'s rows of a global batch: every array (or
    list) of ``batch`` cut to rows ``[d * b, (d + 1) * b)`` with ``b`` the
    local batch size."""
    if dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        b = host_local_batch_size(dp, len(v))
        out[k] = v[data_index * b:(data_index + 1) * b]
    return out
