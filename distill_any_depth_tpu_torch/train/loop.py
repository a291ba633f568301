"""Distillation training loop for one process and one device.

Counterpart of distill_any_depth_tpu/train/loop.py (``Trainer.__init__``,
``run``, ``validate``, ``train_nyu``): epochs, ``max_steps``, the history,
log lines, validation, early stopping and ``history.json``. The loss stays
on the device between log steps (a host read every step would stall the
queue of launches). ``cfg.teacher_quant`` builds the teachers with int8
encoder GEMMs (``ops/quant``), as the JAX Trainer does. Not ported yet:
checkpoints (best, final, periodic and emergency saves, resume),
visualisation, the profiler hook, the device mesh, adapters, the native
loader and the image-folder mode.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from distill_any_depth_tpu_torch.configs import TrainConfig, model_config
from distill_any_depth_tpu_torch.data.nyu import NYUDataset, iterate_batches
from distill_any_depth_tpu_torch.models.factory import create_model, resolve_device
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_eval_loss_fn, make_train_step

logger = logging.getLogger("distill_any_depth_tpu_torch.train")

__all__ = ["Trainer", "train_nyu"]


class Trainer:
    """Builds the student, the teachers and the step from a ``TrainConfig``
    on ``device`` (the card unless the caller asks for the CPU), and runs
    epochs. Weights are seeded random (student ``cfg.seed``, teacher i
    ``100 + i``). The student runs the plain DPT tail, the JAX package's
    student configuration (its weights train); the teachers, without
    gradient, run the tail kernel and, with ``cfg.teacher_quant``, int8
    encoder GEMMs."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.student = create_model(cfg.student, dtype=getattr(torch, cfg.student_compute_dtype),
                                    device=self.device, seed=cfg.seed, fused_tail=False)
        self.teachers = []
        for i, name in enumerate(cfg.teachers):
            logger.warning("teacher %s: no checkpoint loader yet, random init", name)
            teacher = create_model(model_config(name), dtype=getattr(torch, cfg.teacher_dtype),
                                   device=self.device, seed=100 + i, quant=cfg.teacher_quant)
            self.teachers.append(teacher.requires_grad_(False))
        self.state = create_train_state(self.student, cfg.optimizer)
        # the steps are built on the first batch: whether it carries one view
        # or two decides whether the second student forward is skipped
        self.train_step = None
        self.eval_loss = None

    def _build_steps(self, views_shared: bool) -> None:
        args = (self.student, self.teachers, self.cfg.loss)
        kw = dict(views_shared=views_shared, teacher_chunk=self.cfg.teacher_chunk)
        self.train_step = make_train_step(*args, **kw)
        self.eval_loss = make_eval_loss_fn(*args, **kw)

    def _teacher_idx(self, seed: int, counter: int) -> int:
        """The teacher of a train step (``seed = cfg.seed``, ``counter`` the
        step before the update) or of validation batch ``counter`` (``seed =
        cfg.seed + 1``): a function of ``(seed, counter)`` alone, as the JAX
        step's ``fold_in(PRNGKey(seed), counter)``, though not its bits. The
        pair is the 128-bit key of a Philox generator, so distinct pairs
        never share a stream."""
        if len(self.teachers) == 1:
            return 0
        key = (seed % 2 ** 64) << 64 | counter % 2 ** 64
        return int(np.random.Generator(np.random.Philox(key=key)).integers(len(self.teachers)))

    def _views(self, batch: dict):
        """Global and local views ``[B, 3, H, W]`` on the device: NYU batches
        use one image for both."""
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device).permute(0, 3, 1, 2)

        if "global_image" in batch:
            return put(batch["global_image"]), put(batch["local_image"])
        x = put(batch["image"])
        return x, x

    def run(self, train_batches: Callable[[int], Iterable[dict]],
            val_batches: Callable[[], Iterable[dict]] | None = None,
            max_steps: int | None = None,
            on_step: Callable[[int, dict], None] | None = None) -> dict:
        """Train. ``train_batches(epoch)`` yields dicts with ``image`` (or
        ``global_image`` and ``local_image``), NHWC. ``on_step(step,
        metrics)`` is called after each step. Returns the history."""
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        history = {"train_loss": [], "val_loss": [], "lr": []}
        best_val = float("inf")
        epochs_without_improvement = 0
        start = time.time()
        step = int(self.state.step)
        max_steps = max_steps or (cfg.num_iterations or None)
        images, t_images = 0, time.time()
        for epoch in range(cfg.num_epochs):
            epoch_loss, nbatches = None, 0
            for batch in train_batches(epoch):
                if max_steps and step >= max_steps:
                    break
                if self.train_step is None:
                    self._build_steps("global_image" not in batch)
                g, l = self._views(batch)
                metrics = self.train_step(self.state, self._teacher_idx(cfg.seed, step), g, l)
                step += 1
                total = metrics["total"]
                epoch_loss = total if epoch_loss is None else epoch_loss + total
                nbatches += 1
                images += g.shape[0]
                if on_step is not None:
                    on_step(step, metrics)
                if step % cfg.log_interval == 0 or step == 1:
                    lr_now = float(self.state.schedule(step))
                    history["lr"].append(lr_now)
                    comp = {k: round(float(v), 4) for k, v in metrics.items()
                            if k != "teacher_idx"}
                    rate = images / max(time.time() - t_images, 1e-9)
                    logger.info("step %d | epoch %d | %s | lr %.2e | %.2f img/s | %.1fs",
                                step, epoch + 1, comp, lr_now, rate, time.time() - start)
                    images, t_images = 0, time.time()
            if nbatches:
                history["train_loss"].append(float(epoch_loss) / nbatches)
            if max_steps and step >= max_steps:
                break
            if val_batches is not None:
                val = self.validate(val_batches())
                history["val_loss"].append(val["total"])
                logger.info("epoch %d validation: %s", epoch + 1, val)
                if val["total"] < best_val:
                    best_val = val["total"]
                    epochs_without_improvement = 0
                else:
                    epochs_without_improvement += 1
                    if cfg.early_stopping and epochs_without_improvement >= cfg.early_stopping:
                        logger.info("early stopping at epoch %d", epoch + 1)
                        break
        with open(os.path.join(cfg.output_dir, "history.json"), "w") as f:
            json.dump(history, f)
        return history

    def validate(self, batches: Iterable[dict]) -> dict:
        sums: dict[str, torch.Tensor] = {}
        n = 0
        for i, batch in enumerate(batches):
            if self.eval_loss is None:
                self._build_steps("global_image" not in batch)
            comps = self.eval_loss(self._teacher_idx(self.cfg.seed + 1, i), *self._views(batch))
            for k, v in comps.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        if n == 0:
            # an empty validation stream shows as NaN, not as a KeyError later
            return {"total": float("nan")}
        return {k: float(v) / n for k, v in sums.items()}


def train_nyu(cfg: TrainConfig, root_dir: str | None = None,
              device: str | torch.device = "cuda") -> dict:
    """NYU distillation run: a seeded train/validation split of
    ``nyu2_train.csv``, shuffled epochs, validation when it holds a full
    batch."""
    ds = NYUDataset("train", dataset_dir=cfg.dataset_dir, image_size=cfg.image_size,
                    root_dir=root_dir)
    n_val = int(len(ds) * cfg.val_split)
    indices = list(range(len(ds)))
    np.random.RandomState(cfg.seed).shuffle(indices)
    val_idx, train_idx = indices[:n_val], indices[n_val:]
    trainer = Trainer(cfg, device)
    return trainer.run(
        train_batches=lambda epoch: iterate_batches(
            ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch, indices=train_idx),
        val_batches=((lambda: iterate_batches(ds, cfg.batch_size, shuffle=False,
                                              indices=val_idx))
                     # fewer validation samples than a batch would yield no batch
                     if len(val_idx) >= cfg.batch_size else None),
        max_steps=cfg.num_iterations or None,
    )
