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
"""
from __future__ import annotations

import dataclasses
import math

import torch

from distill_any_depth_tpu_torch.configs import OptimizerConfig

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
    """The student's optimizer and the guard's counters, all on the device.
    ``step`` counts train steps (skipped ones too), ``applied`` the updates
    that were applied (the schedule's and Adam's count)."""

    params: list
    optimizer: torch.optim.Adam
    schedule: object
    cfg: OptimizerConfig
    step: torch.Tensor
    applied: torch.Tensor
    notfinite_count: torch.Tensor
    last_norm: torch.Tensor

    _COUNTERS = ("step", "applied", "notfinite_count", "last_norm")
    _ADAM = ("exp_avg", "exp_avg_sq", "step")

    def state_dict(self) -> dict:
        """CPU copies of the parameters, Adam's moments and step counts, the
        learning-rate tensor and the counters: what an exact resume needs
        (the counterpart of the JAX package's orbax checkpoint)."""
        opt = self.optimizer

        def cpu(t):
            return t.detach().to("cpu", copy=True)

        return {"params": [cpu(p) for p in self.params],
                "adam": [{k: cpu(opt.state[p][k]) for k in self._ADAM} if opt.state[p] else {}
                         for p in self.params],
                "lr": cpu(opt.param_groups[0]["lr"]),
                **{k: cpu(getattr(self, k)) for k in self._COUNTERS}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (from ``state_dict``) into this state in place: the
        parameters' version counters move, so the caches keyed on them
        rebuild, and Adam's step counts and learning rate stay on the
        parameters' device, where the fused Adam reads them."""
        if len(state["params"]) != len(self.params) or any(
                tuple(a.shape) != tuple(p.shape) for a, p in zip(state["params"], self.params)):
            raise ValueError("the saved train state holds other parameters than this model's")
        opt = self.optimizer
        for p, saved, adam in zip(self.params, state["params"], state["adam"]):
            p.copy_(saved)
            if not adam:
                opt.state[p] = {}
                continue
            held = opt.state[p]
            for k in self._ADAM:
                if k not in held:
                    held[k] = torch.empty_like(adam[k], device=p.device)
                held[k].copy_(adam[k])
        opt.param_groups[0]["lr"].copy_(state["lr"])
        for k in self._COUNTERS:
            getattr(self, k).copy_(state[k])


def create_train_state(model: torch.nn.Module, cfg: OptimizerConfig) -> TrainState:
    params = [p for p in model.parameters() if p.requires_grad]
    dev = params[0].device

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=dev)

    return TrainState(params, make_optimizer(params, cfg), make_lr_schedule(cfg), cfg,
                      zero(torch.int64), zero(torch.float32), zero(torch.int64),
                      zero(torch.float32))


@torch.no_grad()
def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip, guard and apply the gradients held in the parameters' ``.grad``;
    returns the unclipped global norm (a device scalar)."""
    cfg = state.cfg
    for p in state.params:
        if p.grad is None:
            # a parameter the loss does not reach (the windowed encoder's
            # pos-embed past the PE schedule): JAX differentiates it to 0,
            # and the L2 decay and Adam still move it
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in state.params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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
    return norm
