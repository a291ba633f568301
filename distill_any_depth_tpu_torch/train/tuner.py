"""Loss-weight grid search.

Counterpart of distill_any_depth_tpu/train/tuner.py, in two modes:

- ``tune_loss_weights``: runs ``run_fn(cfg)`` (e.g. ``train/loop.train_nyu``)
  for each lambda combination and ranks them by validation loss.
- ``tune_loss_weights_traced``: one in-process sweep. The student, the
  teachers and the step are built once (a ``train/loop.Trainer``), and
  each experiment restarts from a copy of the initial student with a fresh
  Adam, its lambdas handed to the step as ``loss_weights``
  (``train/step``). The JAX package traces the lambdas so that one compile
  serves the grid; PyTorch compiles nothing, and what is built once here
  is the models (a ViT-L teacher's seeded init takes seconds).

A failed experiment, and one whose score is not finite, ranks last with
score ``inf``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from distill_any_depth_tpu_torch.configs import TrainConfig

logger = logging.getLogger("distill_any_depth_tpu_torch.tuner")

__all__ = [
    "DEFAULT_GRID",
    "generate_experiment_configs",
    "tune_loss_weights",
    "tune_loss_weights_traced",
]

DEFAULT_GRID = {
    "lambda_sc": (0.25, 0.5, 1.0),
    "lambda_lg": (0.25, 0.5),
    "lambda_feat": (0.5, 1.0),
    "lambda_grad": (0.1, 0.2),
    "lambda_hdn": (0.4, 0.8),
}
_LAMBDAS = ("lambda_sc", "lambda_lg", "lambda_feat", "lambda_grad", "lambda_hdn")


def generate_experiment_configs(
    base: TrainConfig, grid: dict[str, Sequence[float]] | None = None,
    max_experiments: int | None = None,
) -> list[TrainConfig]:
    """``base`` with each combination of ``grid`` (keys in sorted order, the
    last varying fastest), at most ``max_experiments`` of them."""
    grid = grid or DEFAULT_GRID
    keys = sorted(grid)
    configs = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        loss = dataclasses.replace(base.loss, **dict(zip(keys, combo)))
        configs.append(dataclasses.replace(base, loss=loss))
        if max_experiments and len(configs) >= max_experiments:
            break
    return configs


def _write_report(results: list[dict], report_dir: str) -> None:
    results.sort(key=lambda r: r["score"])
    os.makedirs(report_dir, exist_ok=True)
    with open(os.path.join(report_dir, "tuning_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    logger.info("best: %s", results[0] if results else None)


def _finite(score: float) -> float:
    """A diverged run must never rank first."""
    return score if np.isfinite(score) else float("inf")


def tune_loss_weights(
    base: TrainConfig,
    run_fn,
    grid: dict[str, Sequence[float]] | None = None,
    max_experiments: int | None = None,
    output_dir: str | None = None,
) -> list[dict]:
    """Run the grid; ``run_fn(cfg) -> history dict`` (e.g. ``train_nyu``)
    with each experiment's ``output_dir`` under ``output_dir/exp_{i:03d}``.
    Returns the experiments ranked by their last validation loss (the last
    train loss without one), best first, and writes them to
    ``tuning_results.json``."""
    results = []
    out = output_dir or base.output_dir
    for i, cfg in enumerate(generate_experiment_configs(base, grid, max_experiments)):
        cfg = dataclasses.replace(cfg, output_dir=os.path.join(out, f"exp_{i:03d}"))
        lambdas = {k: getattr(cfg.loss, k) for k in _LAMBDAS}
        logger.info("experiment %d: %s", i, lambdas)
        try:
            history = run_fn(cfg)
            score = (history.get("val_loss") or history.get("train_loss") or [float("inf")])[-1]
            results.append({"experiment": i, "lambdas": lambdas, "score": _finite(score),
                            "history": history})
        except Exception as e:  # a failed configuration must not end the sweep
            logger.exception("experiment %d failed", i)
            results.append({"experiment": i, "lambdas": lambdas, "score": float("inf"),
                            "error": str(e)})
    _write_report(results, out)
    return results


def tune_loss_weights_traced(
    base: TrainConfig,
    train_batches,
    val_batches,
    grid: dict[str, Sequence[float]] | None = None,
    steps_per_experiment: int = 20,
    max_experiments: int | None = None,
    output_dir: str | None = None,
    device: str | torch.device = "cuda",
    on_step=None,
) -> list[dict]:
    """One in-process sweep on ``device`` (the card unless the caller asks
    for the CPU). ``train_batches`` and ``val_batches``: sequences, reused
    by every experiment, of dict batches with ``global_image`` and
    ``local_image`` (or ``image``), NHWC. Each experiment runs
    ``steps_per_experiment`` steps (cycling over ``train_batches``) from
    the initial student with a fresh optimizer, then scores the mean
    validation total (the last train total without validation batches).
    ``on_step(experiment, step, metrics)`` is called after each step.
    Ranked results and their JSON report as ``tune_loss_weights``."""
    from distill_any_depth_tpu_torch.train.loop import Trainer
    from distill_any_depth_tpu_torch.train.state import create_train_state

    if base.dp * base.tp > 1:
        raise ValueError("the loss-weight sweep runs in one process (dp = tp = 1)")
    grid = grid or DEFAULT_GRID
    trainer = Trainer(base, device)
    initial = {k: v.detach().clone() for k, v in trainer.student.state_dict().items()}
    keys = sorted(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))
    if max_experiments:
        combos = combos[:max_experiments]
    results = []
    for i, combo in enumerate(combos):
        lambdas = dict(zip(keys, combo))
        weights = {k[len("lambda_"):]: float(v) for k, v in lambdas.items()}
        trainer.student.load_state_dict(initial)
        trainer.state = create_train_state(trainer.student, base.optimizer, base.adapter_only)
        train_hist = []
        for step, batch in enumerate(itertools.islice(itertools.cycle(train_batches),
                                                      steps_per_experiment)):
            if trainer.train_step is None:
                trainer._build_steps("global_image" not in batch)
            metrics = trainer.train_step(trainer.state, trainer._teacher_idx(base.seed, step),
                                         *trainer._views(batch), loss_weights=weights)
            train_hist.append(float(metrics["total"]))
            if on_step is not None:
                on_step(i, step, metrics)
        val_hist = []
        for j, batch in enumerate(val_batches or ()):
            if trainer.eval_loss is None:
                trainer._build_steps("global_image" not in batch)
            comps = trainer.eval_loss(trainer._teacher_idx(base.seed, j), *trainer._views(batch),
                                      loss_weights=weights)
            val_hist.append(float(comps["total"]))
        score = _finite(float(np.mean(val_hist)) if val_hist else train_hist[-1])
        logger.info("experiment %d %s -> %.4f", i, lambdas, score)
        results.append({"experiment": i, "lambdas": lambdas, "score": score,
                        "history": {"train_loss": train_hist, "val_loss": val_hist}})
    _write_report(results, output_dir or base.output_dir)
    return results
