"""Optimizer and train state.

Counterpart of distill_any_depth_tpu/train/state.py (``make_lr_schedule``,
``_clip_and_guard``, ``make_optimizer``, ``create_train_state``):

- ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``: its
  L2 decay enters the gradient before the moments, which is optax's
  ``add_decayed_weights`` before ``scale_by_adam``;
- global-norm clipping from ONE norm of the unclipped gradients, applied
  before the decay (the JAX guard wraps the inner chain);
- a non-finite norm skips the update: parameters, moments, Adam's step
  count and the schedule's position stay as they were (optax keeps the
  inner state), ``notfinite_count`` counts consecutive skips and
  ``last_norm`` keeps the norm.

Everything stays on the device, with no host read per step: Adam is the
fused implementation, whose ``found_inf`` input skips the update and leaves
its step count alone, and its learning rate is a tensor set from the
schedule at the count of applied updates.

Adapter-only training (the JAX Trainer's ``optax.multi_transform`` of the
optimizer on the adapters and ``set_to_zero`` elsewhere): Adam, the decay,
the clip and the guard own the LoRA/SSF parameters alone, and their norm is
the adapters' norm; the frozen parameters are never updated. The state
still holds every parameter, so that a resume is exact, and the frozen
parameters keep their gradients: the reported gradient norm is, as in the
JAX step, the global norm of every parameter's gradient.

Under tensor parallelism (``splits`` and ``model_group``, set by the
Trainer from ``parallel/tp.shard_model``'s plan) the state holds this
rank's shards, Adam's moments of a sharded parameter are sharded with it,
and the gradient norm is that of the full gradient: the squared norms of the
sharded gradients summed over the model group, the replicated ones counted
once. So the clip and the guard decide the same on every rank. ``state_dict``
gathers the shards (a collective over the model group) and
``load_state_dict`` shards a full state, so a saved state has the layout of
a single-process one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from distill_any_depth_tpu_torch.configs import OptimizerConfig
from distill_any_depth_tpu_torch.models.adapters import adapter_parameters
from distill_any_depth_tpu_torch.parallel.tp import gather_tensors, model_size, shard_tensor

__all__ = ["TrainState", "make_lr_schedule", "make_optimizer", "create_train_state",
           "apply_gradients"]


def make_lr_schedule(cfg: OptimizerConfig):
    """Learning rate as a function of the count of applied updates (a
    number or a tensor): linear warmup from 0, then cosine decay to
    ``eta_min_ratio * lr``, staircase step decay, or constant; optax's
    ``join_schedules`` of them."""
    warmup = max(int(cfg.warmup_steps), 0)
    decay_steps = max(cfg.total_steps - warmup, 1)
    if cfg.schedule not in ("cosine", "step", "none"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    def after_warmup(count: torch.Tensor) -> torch.Tensor:
        if cfg.schedule == "cosine":
            frac = count.clamp(max=decay_steps) / decay_steps
            cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
            return cfg.lr * ((1.0 - cfg.eta_min_ratio) * cosine + cfg.eta_min_ratio)
        if cfg.schedule == "step":
            return cfg.lr * cfg.gamma ** torch.floor(count / cfg.step_size)
        return torch.full_like(count, cfg.lr)

    def schedule(count):
        count = torch.as_tensor(count, dtype=torch.float32)
        if warmup == 0:
            return after_warmup(count)
        ramp = cfg.lr * count.clamp(max=warmup) / warmup
        return torch.where(count < warmup, ramp, after_warmup(count - warmup))

    return schedule


def make_optimizer(params, cfg: OptimizerConfig) -> torch.optim.Adam:
    """Adam on ``params`` with a tensor learning rate on their device."""
    params = list(params)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay, fused=True)


@dataclasses.dataclass
class TrainState:
    """The student's parameters, its optimizer and the guard's counters,
    all on the device. ``params`` holds every parameter of the student, the
    optimizer those it trains (``trained``). ``step`` counts train steps
    (skipped ones too), ``applied`` the updates that were applied (the
    schedule's and Adam's count). ``splits`` maps ``id(parameter)`` to the
    ``parallel/tp.Split`` of each sharded parameter (empty without tensor
    parallelism) and ``model_group`` is the group that holds the shards."""

    params: list
    optimizer: torch.optim.Adam
    schedule: object
    cfg: OptimizerConfig
    step: torch.Tensor
    applied: torch.Tensor
    notfinite_count: torch.Tensor
    last_norm: torch.Tensor
    splits: dict = dataclasses.field(default_factory=dict)
    model_group: object = None

    _COUNTERS = ("step", "applied", "notfinite_count", "last_norm")
    _ADAM = ("exp_avg", "exp_avg_sq", "step")

    @property
    def trained(self) -> list:
        return self.optimizer.param_groups[0]["params"]

    def state_dict(self) -> dict:
        """CPU copies of the parameters, Adam's moments and step counts, the
        learning-rate tensor and the counters: what an exact resume needs
        (the counterpart of the JAX package's orbax checkpoint). Sharded
        parameters and their moments are gathered whole: every rank of the
        model group calls it."""
        opt = self.optimizer

        def cpu(t):
            return t.detach().to("cpu", copy=True)

        held = [p for p in self.params if opt.state.get(p)]
        adam = {p: {k: opt.state[p][k] for k in self._ADAM} for p in held}
        params = self._gather(self.params)
        for k in ("exp_avg", "exp_avg_sq"):
            for p, t in zip(held, self._gather(held, [adam[p][k] for p in held])):
                adam[p][k] = t
        return {"params": [cpu(p) for p in params],
                "adam": [{k: cpu(v) for k, v in adam[p].items()} if p in adam else {}
                         for p in self.params],
                "lr": cpu(opt.param_groups[0]["lr"]),
                **{k: cpu(getattr(self, k)) for k in self._COUNTERS}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (from ``state_dict``) into this state in place: the
        parameters' version counters move, so the caches keyed on them
        rebuild, and Adam's step counts and learning rate stay on the
        parameters' device, where the fused Adam reads them. A full state
        is sharded as this rank's parameters are."""
        if len(state["params"]) != len(self.params):
            raise ValueError("the saved train state holds other parameters than this model's")
        opt = self.optimizer
        shard = self._shard
        if any(tuple(shard(p, a).shape) != tuple(p.shape)
               for a, p in zip(state["params"], self.params)):
            raise ValueError("the saved train state holds other parameters than this model's")
        for p, saved, adam in zip(self.params, state["params"], state["adam"]):
            p.copy_(shard(p, saved))
            if not adam:
                opt.state.pop(p, None)
                continue
            held = opt.state[p]
            for k in self._ADAM:
                value = adam[k] if k == "step" else shard(p, adam[k])
                if k not in held:
                    held[k] = torch.empty_like(value, device=p.device)
                held[k].copy_(value)
        opt.param_groups[0]["lr"].copy_(state["lr"])
        for k in self._COUNTERS:
            getattr(self, k).copy_(state[k])

    def _gather(self, params: list, tensors: list | None = None) -> list:
        """The full tensors of ``tensors`` (by default ``params``), each
        split as its parameter is."""
        tensors = [p.detach() for p in params] if tensors is None else tensors
        if not self.splits:
            return tensors
        return gather_tensors(tensors, [self.splits.get(id(p)) for p in params],
                              self.model_group)

    def _shard(self, p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``, split as its parameter ``p`` is."""
        split = self.splits.get(id(p))
        if split is None:
            return full
        return shard_tensor(full, split, dist.get_rank(self.model_group),
                            model_size(self.model_group))


def create_train_state(model: torch.nn.Module, cfg: OptimizerConfig,
                       adapter_only: bool = False, plan: dict | None = None,
                       model_group=None) -> TrainState:
    """The train state of ``model``: every parameter that requires a
    gradient, with Adam on all of them or, with ``adapter_only``, on the
    LoRA/SSF parameters alone (``ValueError`` if the model has none).
    ``plan`` (``parallel/tp.shard_model``'s) and ``model_group``: the
    model holds this rank's shards."""
    params = [p for p in model.parameters() if p.requires_grad]
    trained = params
    if adapter_only:
        trained = adapter_parameters(model)
        if not trained:
            raise ValueError("adapter_only=True but the student has no LoRA/SSF parameters: "
                             "set lora_rank or use_ssf on its encoder config")
    dev = params[0].device

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=dev)

    splits = {id(p): plan[name] for name, p in model.named_parameters() if name in (plan or {})}
    return TrainState(params, make_optimizer(trained, cfg), make_lr_schedule(cfg), cfg,
                      zero(torch.int64), zero(torch.float32), zero(torch.int64),
                      zero(torch.float32), splits, model_group)


def _global_norm(tensors: list, state: TrainState, params: list) -> torch.Tensor:
    """The global norm of ``tensors`` (the gradients of ``params``); under
    tensor parallelism, that of the full gradients."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if not state.splits:
        return torch.linalg.vector_norm(norms)
    sharded = torch.tensor([id(p) in state.splits for p in params], device=norms.device)
    sq = norms.square()
    shard_sq = torch.where(sharded, sq, 0.0).sum()
    dist.all_reduce(shard_sq, group=state.model_group)
    return (torch.where(sharded, 0.0, sq).sum() + shard_sq).sqrt()


@torch.no_grad()
def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip, guard and apply the gradients held in the trained parameters'
    ``.grad``; returns the unclipped global norm of every parameter's
    gradient (a device scalar), which is the clip's norm unless the state
    trains the adapters alone."""
    cfg = state.cfg
    trained = state.trained
    for p in trained:
        if p.grad is None:
            # a parameter the loss does not reach (the windowed encoder's
            # pos-embed past the PE schedule): JAX differentiates it to 0,
            # and the L2 decay and Adam still move it
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in trained]
    norm = _global_norm(grads, state, trained)
    reported = norm
    if len(trained) < len(state.params):
        held = [p for p in state.params if p.grad is not None]
        reported = _global_norm([p.grad for p in held], state, held)
    if cfg.max_grad_norm and cfg.max_grad_norm > 0:
        torch._foreach_mul_(grads, cfg.max_grad_norm / torch.clamp(norm, min=cfg.max_grad_norm))
    opt = state.optimizer
    opt.param_groups[0]["lr"].copy_(state.schedule(state.applied))
    skip = (~torch.isfinite(norm)).float()
    opt.found_inf = skip
    state.notfinite_count = torch.where(skip > 0, state.notfinite_count + 1, 0)
    opt.step()
    state.applied += 1.0 - skip
    state.step += 1
    state.last_norm = norm
    return reported
