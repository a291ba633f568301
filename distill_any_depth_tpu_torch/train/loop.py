"""Distillation training loop for one process and one device.

Counterpart of distill_any_depth_tpu/train/loop.py (``Trainer.__init__``,
``run``, ``validate``, ``resume``, ``train_nyu``): epochs, ``max_steps``,
the history, log lines, validation, early stopping, ``history.json`` and
the checkpoints: ``student_best`` on a validation improvement,
``student_checkpoint_{step}`` and the train state every
``checkpoint_interval`` steps, ``student_final`` and the train state at the
end, ``student_emergency`` when a step raises (which is then re-raised),
all reference-layout fp32 safetensors but the train state
(``utils/checkpoint``). A resumed run fast-forwards to where the saved one
stopped in its data (``steps_per_epoch``). The loss stays on the device
between log steps (a host read every step would stall the queue of
launches); a save reads the parameters and nothing else.
``cfg.teacher_quant`` builds the teachers with int8 encoder GEMMs
(``ops/quant``), as the JAX Trainer does. Not ported yet: visualisation,
the profiler hook, the device mesh, adapters, the native loader and the
image-folder mode.
"""
from __future__ import annotations

import itertools
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
from distill_any_depth_tpu_torch.utils import checkpoint as ckpt_io

logger = logging.getLogger("distill_any_depth_tpu_torch.train")

__all__ = ["Trainer", "train_nyu"]


class Trainer:
    """Builds the student, the teachers and the step from a ``TrainConfig``
    on ``device`` (the card unless the caller asks for the CPU), and runs
    epochs. The student's weights are seeded random (``cfg.seed``); teacher
    i loads ``cfg.teacher_checkpoints[i]`` where it is given and is seeded
    random (``100 + i``) otherwise. The student runs the plain DPT tail, the
    JAX package's student configuration (its weights train); the teachers,
    without gradient, run the tail kernel and, with ``cfg.teacher_quant``,
    int8 encoder GEMMs."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.student = create_model(cfg.student, dtype=getattr(torch, cfg.student_compute_dtype),
                                    device=self.device, seed=cfg.seed, fused_tail=False)
        self.teachers = []
        for i, name in enumerate(cfg.teachers):
            path = cfg.teacher_checkpoints[i] if i < len(cfg.teacher_checkpoints) else None
            if not path:
                logger.warning("teacher %s: no checkpoint given, random init", name)
            teacher = create_model(model_config(name), dtype=getattr(torch, cfg.teacher_dtype),
                                   device=self.device, seed=None if path else 100 + i,
                                   quant=cfg.teacher_quant)
            if path:
                ckpt_io.load_state_dict_file(teacher, path)
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
            on_step: Callable[[int, dict], None] | None = None,
            steps_per_epoch: int | None = None) -> dict:
        """Train. ``train_batches(epoch)`` yields dicts with ``image`` (or
        ``global_image`` and ``local_image``), NHWC. ``on_step(step,
        metrics)`` is called after each step. Returns the history.

        A run that starts at step s > 0 (after ``resume``) with
        ``steps_per_epoch`` starts at epoch ``s // steps_per_epoch`` and
        skips its first ``s % steps_per_epoch`` batches, so it continues the
        saved run's data order; without it the data restarts at epoch 0."""
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        try:
            history = self._epochs(train_batches, val_batches,
                                   max_steps or (cfg.num_iterations or None), on_step,
                                   steps_per_epoch)
        except Exception:
            self._save_weights("student_emergency")
            logger.exception("training failed; emergency checkpoint written")
            raise
        self._save_weights("student_final")
        ckpt_io.save_train_state(os.path.join(cfg.output_dir, "train_state"), self.state)
        with open(os.path.join(cfg.output_dir, "history.json"), "w") as f:
            json.dump(history, f)
        return history

    def _epochs(self, train_batches, val_batches, max_steps, on_step, steps_per_epoch) -> dict:
        """``run``'s epochs, from the state's step on; returns the history."""
        cfg = self.cfg
        history = {"train_loss": [], "val_loss": [], "lr": []}
        best_val = float("inf")
        epochs_without_improvement = 0
        start = time.time()
        step = int(self.state.step)
        images, t_images = 0, time.time()
        start_epoch, skip_batches = 0, 0
        if step > 0:
            if steps_per_epoch:
                start_epoch, skip_batches = divmod(step, steps_per_epoch)
                logger.info("resuming at step %d -> epoch %d, skipping %d batches",
                            step, start_epoch, skip_batches)
            else:
                logger.warning("resuming at step %d without steps_per_epoch: the optimizer "
                               "state is exact but the data order restarts at epoch 0", step)
        for epoch in range(start_epoch, cfg.num_epochs):
            epoch_loss, nbatches = None, 0
            batches = train_batches(epoch)
            if epoch == start_epoch and skip_batches:
                batches = itertools.islice(batches, skip_batches, None)
            for batch in batches:
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
                if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                    self._save_step_checkpoint(step)
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
                    self._save_weights("student_best")
                else:
                    epochs_without_improvement += 1
                    if cfg.early_stopping and epochs_without_improvement >= cfg.early_stopping:
                        logger.info("early stopping at epoch %d", epoch + 1)
                        break
        return history

    def _save_weights(self, name: str) -> str:
        path = os.path.join(self.cfg.output_dir, f"{name}.safetensors")
        ckpt_io.save_safetensors(path, self.student)
        return path

    def _save_step_checkpoint(self, step: int) -> None:
        """``student_checkpoint_{step}`` and the resumable train state beside
        it. A failed train-state save is logged and the run goes on, as in
        the JAX Trainer: the weights are written."""
        path = self._save_weights(f"student_checkpoint_{step}")
        try:
            ckpt_io.save_train_state(os.path.join(self.cfg.output_dir, "train_state"),
                                     self.state)
        except OSError:
            logger.exception("periodic train_state save failed")
        logger.info("saved checkpoint %s", path)

    def resume(self, path: str) -> None:
        """Continue from the train state saved under ``path`` (a train-state
        directory or a run's output directory)."""
        self.state.load_state_dict(ckpt_io.restore_train_state(path))

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
              device: str | torch.device = "cuda", resume: str | None = None) -> dict:
    """NYU distillation run: a seeded train/validation split of
    ``nyu2_train.csv``, shuffled epochs, validation when it holds a full
    batch. ``resume`` (a run's output directory or its ``train_state``)
    continues a saved run in its parameters, optimizer and data order."""
    ds = NYUDataset("train", dataset_dir=cfg.dataset_dir, image_size=cfg.image_size,
                    root_dir=root_dir)
    n_val = int(len(ds) * cfg.val_split)
    indices = list(range(len(ds)))
    np.random.RandomState(cfg.seed).shuffle(indices)
    val_idx, train_idx = indices[:n_val], indices[n_val:]
    trainer = Trainer(cfg, device)
    if resume:
        trainer.resume(resume)
    return trainer.run(
        train_batches=lambda epoch: iterate_batches(
            ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch, indices=train_idx),
        val_batches=((lambda: iterate_batches(ds, cfg.batch_size, shuffle=False,
                                              indices=val_idx))
                     # fewer validation samples than a batch would yield no batch
                     if len(val_idx) >= cfg.batch_size else None),
        max_steps=cfg.num_iterations or None,
        steps_per_epoch=len(train_idx) // cfg.batch_size,
    )
