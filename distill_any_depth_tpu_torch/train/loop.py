"""Distillation training loop, on one device or over a ``(data, model)``
rank grid.

Counterpart of distill_any_depth_tpu/train/loop.py (``Trainer.__init__``,
``run``, ``validate``, ``resume``, ``train_nyu``, ``train_images``): epochs,
``max_steps``, the history, log lines (images/s over ``utils/profiling.
StepTimer``'s window), validation, early stopping, ``history.json`` and
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
(``ops/quant``), as the JAX Trainer does; ``cfg.adapter_only`` trains the
student's LoRA/SSF parameters alone (``train/state``). A batch of uint8
images (``cfg.device_preprocess``) is copied to the device as it is and
resized and normalized there (``ops/preprocess``). ``run(profile_dir=...)``
traces the first ``PROFILE_STEPS`` steps (``utils/profiling.trace``, with
the program's spans: ``train/batch`` the wait for a batch, ``train/log`` a
log step's host reads, and the step's own); every
``cfg.visualize_interval`` steps the student's and the first teacher's
depth of the local view are drawn, and the loss and LR curves at the end
(``utils/visualize``; a drawing error is logged and the run goes on).

With ``cfg.dp`` or ``cfg.tp`` above 1 (one process per device under
``torchrun``, ``parallel/launch``), the Trainer builds the rank grid
(``parallel/mesh``): every rank builds the full student and teachers from
the seed or the files, then keeps its tensor-parallel shard
(``parallel/tp``), so a run starts from the single-process weights.
``cfg.batch_size`` is the global batch: each data rank steps on
``batch_size / dp`` rows of it (``train_nyu`` through its epoch shard,
``train_images`` by building the global batch and keeping its rows), and
the teacher's ``teacher_chunk`` counts global rows as the batch does.
Validation components are reduced over the data ranks, so early stopping
and ``student_best`` are decided alike everywhere. Rank 0 alone writes
(checkpoints, ``train_state/``, ``history.json``, the drawings and the
profiler trace), the gathered full state with a barrier around each save,
so the files of a run on any grid have the single-process layout.
``train_nyu`` reads NYU through the C++ loader (``data/native_loader``)
where it builds, over the same epoch shards, and through the Python loader
otherwise.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from distill_any_depth_tpu_torch.configs import TrainConfig, model_config
from distill_any_depth_tpu_torch.data.images import ImageFolderDataset
from distill_any_depth_tpu_torch.data.nyu import NYUDataset, iterate_batches
from distill_any_depth_tpu_torch.models.factory import (
    create_model,
    resolve_device,
    resolve_fused_tail,
)
from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device
from distill_any_depth_tpu_torch.parallel import launch
from distill_any_depth_tpu_torch.parallel.mesh import host_local_batch_size, make_mesh, shard_batch
from distill_any_depth_tpu_torch.parallel.tp import shard_model
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_eval_loss_fn, make_train_step
from distill_any_depth_tpu_torch.utils import checkpoint as ckpt_io
from distill_any_depth_tpu_torch.utils.profiling import StepTimer, count, span, trace

logger = logging.getLogger("distill_any_depth_tpu_torch.train")

__all__ = ["PROFILE_STEPS", "Trainer", "train_nyu", "image_batches", "train_images"]

PROFILE_STEPS = 3  # steps a run traces with profile_dir, as in the JAX Trainer


class Trainer:
    """Builds the student, the teachers and the step from a ``TrainConfig``
    on ``device`` (the card unless the caller asks for the CPU), and runs
    epochs. The student's weights are seeded random (``cfg.seed``); teacher
    i loads ``cfg.teacher_checkpoints[i]`` where it is given and is seeded
    random (``100 + i``) otherwise. The student runs the plain DPT tail, the
    JAX package's student configuration (its weights train), and with
    ``cfg.student_remat`` recomputes its blocks in the backward; the
    teachers, without gradient, run the tail kernel unless
    ``cfg.teacher_fused_tail`` is "off" and, with ``cfg.teacher_quant``,
    int8 encoder GEMMs. Every model's attention is ``cfg.attn_impl``. With
    ``cfg.dp * cfg.tp`` above 1 the process group must hold that many ranks
    (``ValueError`` otherwise), and the models keep this rank's shards."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = (make_mesh(cfg.dp, cfg.tp)
                     if cfg.dp * cfg.tp > 1 or launch.process_count() > 1 else None)
        host_local_batch_size(cfg.dp, cfg.batch_size)  # raises unless dp divides the batch
        if cfg.teacher_chunk % cfg.dp:
            raise ValueError(f"teacher_chunk {cfg.teacher_chunk} counts global rows: it must "
                             f"divide over dp={cfg.dp}")
        self.student = create_model(cfg.student, dtype=getattr(torch, cfg.student_compute_dtype),
                                    device=self.device, seed=cfg.seed, fused_tail=False,
                                    attn_impl=cfg.attn_impl, remat=cfg.student_remat)
        self.teachers = []
        for i, name in enumerate(cfg.teachers):
            path = cfg.teacher_checkpoints[i] if i < len(cfg.teacher_checkpoints) else None
            if not path:
                logger.warning("teacher %s: no checkpoint given, random init", name)
            teacher = create_model(model_config(name), dtype=getattr(torch, cfg.teacher_dtype),
                                   device=self.device, seed=None if path else 100 + i,
                                   quant=cfg.teacher_quant, attn_impl=cfg.attn_impl,
                                   fused_tail=resolve_fused_tail(cfg.teacher_fused_tail))
            if path:
                ckpt_io.load_state_dict_file(teacher, path)
            self.teachers.append(teacher.requires_grad_(False))
        plan = shard_model(self.student, self.mesh)
        for teacher in self.teachers:
            shard_model(teacher, self.mesh)
        self.state = create_train_state(self.student, cfg.optimizer, cfg.adapter_only, plan,
                                        self._model_group)
        # the steps are built on the first batch: whether it carries one view
        # or two decides whether the second student forward is skipped
        self.train_step = None
        self.eval_loss = None

    @property
    def _model_group(self):
        return None if self.mesh is None else self.mesh.model_group

    def _build_steps(self, views_shared: bool) -> None:
        args = (self.student, self.teachers, self.cfg.loss)
        kw = dict(views_shared=views_shared, teacher_chunk=self.cfg.teacher_chunk // self.cfg.dp,
                  data_group=None if self.mesh is None else self.mesh.data_group)
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
        use one image for both. uint8 images go to the device as they are
        and are resized to ``cfg.image_size`` and normalized there. Under
        ``utils/profiling.recording()``: the span ``train/views`` over each
        view's ``train/upload``, counted in ``train/upload_bytes``."""
        def put(x):
            with span("train/upload"):
                x = torch.from_numpy(np.ascontiguousarray(x))
                count("train/upload_bytes", x.nbytes)
                x = x.to(self.device)
            if x.dtype == torch.uint8:
                return preprocess_on_device(x, self.cfg.image_size)
            return x.permute(0, 3, 1, 2)

        with span("train/views"):
            if "global_image" in batch:
                return put(batch["global_image"]), put(batch["local_image"])
            x = put(batch["image"])
            return x, x

    def run(self, train_batches: Callable[[int], Iterable[dict]],
            val_batches: Callable[[], Iterable[dict]] | None = None,
            max_steps: int | None = None,
            on_step: Callable[[int, dict], None] | None = None,
            steps_per_epoch: int | None = None, profile_dir: str | None = None) -> dict:
        """Train. ``train_batches(epoch)`` yields dicts with ``image`` (or
        ``global_image`` and ``local_image``), NHWC. ``on_step(step,
        metrics)`` is called after each step. Returns the history.

        A run that starts at step s > 0 (after ``resume``) with
        ``steps_per_epoch`` starts at epoch ``s // steps_per_epoch`` and
        skips its first ``s % steps_per_epoch`` batches, so it continues the
        saved run's data order; without it the data restarts at epoch 0.
        With ``profile_dir``, the first ``PROFILE_STEPS`` steps of the run
        are traced into ``profile_dir/trace.json`` (by rank 0). Over a rank
        grid, ``train_batches`` yields this data rank's rows."""
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        try:
            history = self._epochs(train_batches, val_batches,
                                   max_steps or (cfg.num_iterations or None), on_step,
                                   steps_per_epoch, profile_dir)
        except Exception:
            if cfg.tp == 1:
                self._save_weights("student_emergency", barrier=False)
                logger.exception("training failed; emergency checkpoint written")
            else:
                # gathering the shards would wait on ranks that may not come
                logger.exception("training failed; no emergency checkpoint under tp > 1")
            raise
        self._save_weights("student_final")
        self._save_train_state()
        if not launch.is_main_process():
            return history
        with open(os.path.join(cfg.output_dir, "history.json"), "w") as f:
            json.dump(history, f)
        try:
            from distill_any_depth_tpu_torch.utils.visualize import plot_history

            plot_history(history, cfg.output_dir)
        except Exception:  # drawing must never fail a run
            logger.exception("history plotting failed")
        return history

    def _epochs(self, train_batches, val_batches, max_steps, on_step, steps_per_epoch,
                profile_dir) -> dict:
        """``run``'s epochs, from the state's step on; returns the history."""
        cfg = self.cfg
        history = {"train_loss": [], "val_loss": [], "lr": []}
        best_val = float("inf")
        epochs_without_improvement = 0
        start = time.time()
        step = int(self.state.step)
        timer = StepTimer()
        start_epoch, skip_batches = 0, 0
        if step > 0:
            if steps_per_epoch:
                start_epoch, skip_batches = divmod(step, steps_per_epoch)
                logger.info("resuming at step %d -> epoch %d, skipping %d batches",
                            step, start_epoch, skip_batches)
            else:
                logger.warning("resuming at step %d without steps_per_epoch: the optimizer "
                               "state is exact but the data order restarts at epoch 0", step)
        tracing = contextlib.ExitStack()
        if profile_dir and launch.is_main_process():
            tracing.enter_context(trace(profile_dir, self.device))
        profile_until = step + PROFILE_STEPS
        with tracing:
            for epoch in range(start_epoch, cfg.num_epochs):
                epoch_loss, nbatches = None, 0
                batches = train_batches(epoch)
                if epoch == start_epoch and skip_batches:
                    batches = itertools.islice(batches, skip_batches, None)
                batches = iter(batches)
                while True:
                    with span("train/batch"):  # the loader's wait
                        batch = next(batches, None)
                    if batch is None:
                        break
                    if max_steps and step >= max_steps:
                        break
                    if self.train_step is None:
                        self._build_steps("global_image" not in batch)
                    g, l = self._views(batch)
                    metrics = self.train_step(self.state, self._teacher_idx(cfg.seed, step), g,
                                              l)
                    step += 1
                    total = metrics["total"]
                    epoch_loss = total if epoch_loss is None else epoch_loss + total
                    nbatches += 1
                    timer.tick(g.shape[0] * cfg.dp)
                    if profile_dir and step == profile_until:
                        tracing.close()
                        logger.info("profiler trace written to %s", profile_dir)
                    if on_step is not None:
                        on_step(step, metrics)
                    if step % cfg.log_interval == 0 or step == 1:
                        with span("train/log"):  # host reads: waits for the device
                            lr_now = float(self.state.schedule(step))
                            history["lr"].append(lr_now)
                            comp = {k: round(float(v), 4) for k, v in metrics.items()
                                    if k != "teacher_idx"}
                            logger.info(
                                "step %d | epoch %d | %s | lr %.2e | %.2f img/s | %.1fs",
                                step, epoch + 1, comp, lr_now, timer.images_per_sec,
                                time.time() - start)
                    if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                        self._save_step_checkpoint(step)
                    if cfg.visualize_interval and step % cfg.visualize_interval == 0:
                        self._visualize(l, step)
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

    @torch.no_grad()
    def _visualize(self, local_image: torch.Tensor, step: int) -> None:
        """The student's and the first teacher's depth of the local view
        (rank 0's rows; every model rank runs the forwards), drawn by
        ``utils/visualize``; an error is logged, not raised."""
        try:
            from distill_any_depth_tpu_torch.utils.visualize import visualize_depth_predictions

            s_depth = self.student(local_image)[0].float().cpu().numpy()
            t_depth = self.teachers[0](local_image)[0].float().cpu().numpy()
            if launch.is_main_process():
                visualize_depth_predictions(s_depth, t_depth, step, self.cfg.output_dir)
        except Exception:  # drawing must never fail a run
            logger.exception("visualization failed")

    def _save_weights(self, name: str, barrier: bool = True) -> str:
        """The student's full weights, written by rank 0 between barriers."""
        path = os.path.join(self.cfg.output_dir, f"{name}.safetensors")
        state = ckpt_io.reference_state(self.student, self._model_group)
        if barrier:
            launch.synchronize()
        if launch.is_main_process():
            ckpt_io.write_safetensors(path, state)
        if barrier:
            launch.synchronize()
        return path

    def _save_train_state(self) -> None:
        """The full train state, written by rank 0 between barriers."""
        state = self.state.state_dict()
        launch.synchronize()
        try:
            if launch.is_main_process():
                ckpt_io.save_train_state(os.path.join(self.cfg.output_dir, "train_state"),
                                         state)
        finally:
            launch.synchronize()

    def _save_step_checkpoint(self, step: int) -> None:
        """``student_checkpoint_{step}`` and the resumable train state beside
        it. A failed train-state save is logged and the run goes on, as in
        the JAX Trainer: the weights are written."""
        path = self._save_weights(f"student_checkpoint_{step}")
        try:
            self._save_train_state()
        except OSError:
            logger.exception("periodic train_state save failed")
        logger.info("saved checkpoint %s", path)

    def resume(self, path: str) -> None:
        """Continue from the train state saved under ``path`` (a train-state
        directory or a run's output directory); every rank reads the full
        state and keeps its shard."""
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


def _data_index(cfg: TrainConfig) -> int:
    """This process's data rank: rank r sits at ``divmod(r, tp)``."""
    return launch.process_index() // cfg.tp


def train_nyu(cfg: TrainConfig, root_dir: str | None = None,
              device: str | torch.device = "cuda", resume: str | None = None,
              profile_dir: str | None = None) -> dict:
    """NYU distillation run: a seeded train/validation split of
    ``nyu2_train.csv``, shuffled epochs, validation when it holds a full
    batch. ``resume`` (a run's output directory or its ``train_state``)
    continues a saved run in its parameters, optimizer and data order;
    ``profile_dir`` traces the first 3 steps. With ``cfg.use_native_loader``
    (the default) the batches come from the C++ loader
    (``data/native_loader``), where it can be built: its epochs and shards
    are the Python loader's, batch for batch; where it cannot, a warning is
    logged and the Python loader serves. ``cfg.device_preprocess`` takes
    the Python loader, whose batches then carry uint8 frames at their
    native size. Over a rank grid each data rank reads its round-robin
    shard of every epoch (``data/nyu.epoch_order``) at ``batch_size / dp``
    rows a step, and every rank runs the same number of steps."""
    ds = NYUDataset("train", dataset_dir=cfg.dataset_dir, image_size=cfg.image_size,
                    root_dir=root_dir, device_preprocess=cfg.device_preprocess)
    n_val = int(len(ds) * cfg.val_split)
    indices = list(range(len(ds)))
    np.random.RandomState(cfg.seed).shuffle(indices)
    val_idx, train_idx = indices[:n_val], indices[n_val:]
    b = cfg.batch_size // cfg.dp
    shard = dict(shard_index=_data_index(cfg), num_shards=cfg.dp)
    # every rank runs the same steps: counted from the global row count
    steps_per_epoch = (len(train_idx) // cfg.dp) // b
    # fewer validation samples than a batch would yield no batch
    validate = len(val_idx) // cfg.dp >= b
    loaders = None
    if cfg.use_native_loader and not cfg.device_preprocess:
        # only the set-up may fall back: once training starts a failure
        # propagates (a blanket fallback would restart a long run)
        try:
            loaders = _native_loaders(cfg, ds, train_idx, val_idx if validate else None, b,
                                      shard)
        except (RuntimeError, OSError) as e:
            logger.warning("native loader set-up failed (%s); using the Python loader", e)
    elif cfg.use_native_loader:
        logger.info("device_preprocess: using the Python loader (it ships uint8 frames; the "
                    "native loader resizes on the host)")
    if loaders is None:
        logger.info("Python loader: %d train samples, %d validation samples", len(train_idx),
                    n_val)

        def train_batches(epoch):
            return iterate_batches(ds, b, shuffle=True, seed=cfg.seed + epoch,
                                   indices=train_idx, **shard)

        def val_batches():
            return iterate_batches(ds, b, shuffle=False, indices=val_idx, **shard)
    else:
        logger.info("native loader: %d train samples, %d validation samples", len(train_idx),
                    n_val)

        # epoch-seeded orders delivered in order keep a resume's fast-forward
        # data-exact; epoch 0 replays the same validation order every pass
        def train_batches(epoch):
            return loaders[0].batches(steps_per_epoch, epoch=epoch)

        def val_batches():
            return loaders[1].batches(len(val_idx) // cfg.dp // b, epoch=0)
    try:
        trainer = Trainer(cfg, device)
        if resume:
            trainer.resume(resume)
        return trainer.run(
            train_batches=train_batches, val_batches=val_batches if validate else None,
            max_steps=cfg.num_iterations or None, steps_per_epoch=steps_per_epoch,
            profile_dir=profile_dir)
    finally:
        for loader in loaders or ():
            if loader is not None:
                loader.close()


def _native_loaders(cfg: TrainConfig, ds: NYUDataset, train_idx: list[int],
                    val_idx: list[int] | None, batch: int, shard: dict) -> tuple:
    """The C++ loaders of ``train_nyu``'s split of ``ds``'s CSV (the
    validation one None without ``val_idx``), on this data rank's shard.
    Raises ``RuntimeError`` where the library cannot be built."""
    from distill_any_depth_tpu_torch.data import native_loader

    if not native_loader.available():
        raise RuntimeError("the native loader cannot be built here")
    kw = dict(image_size=cfg.image_size, batch_size=batch, **shard)
    train = native_loader.NativeNYULoader(ds.csv_path, ds.root, shuffle=True, seed=cfg.seed,
                                          indices=train_idx, **kw)
    val = (None if val_idx is None else
           native_loader.NativeNYULoader(ds.csv_path, ds.root, shuffle=False, indices=val_idx,
                                         **kw))
    return train, val


def image_batches(ds: ImageFolderDataset, indices: list[int], batch_size: int,
                  shuffle_seed: int | None = None):
    """The full batches of ``indices`` (shuffled with ``shuffle_seed`` if
    given) as ``{'global_image', 'local_image'}`` NHWC float32 numpy. Each
    sample is read when its batch is asked for, on the caller's thread: the
    dataset's crops follow the order of access."""
    order = list(indices)
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(order)
    n = (len(order) // batch_size) * batch_size
    for start in range(0, n, batch_size):
        samples = [ds[i] for i in order[start:start + batch_size]]
        yield {"global_image": np.stack([s.global_image for s in samples]),
               "local_image": np.stack([s.local_image for s in samples])}


def train_images(cfg: TrainConfig, image_dir: str | None = None, min_local_crop: int = 384,
                 device: str | torch.device = "cuda", resume: str | None = None,
                 profile_dir: str | None = None) -> dict:
    """The paper's distillation on an unlabeled image folder
    (``image_dir``, by default ``cfg.dataset_dir``): a global view and a
    random local crop of each image, both ``cfg.image_size`` square, so the
    step runs the student on both views. The split and the per-epoch
    shuffles are those of ``train_nyu``; validation runs when it holds a
    full batch. A resumed run is data-exact within its first epoch: the
    dataset's crop generator starts afresh in every process, as in the JAX
    package. Over a rank grid every data rank builds the global batch and
    keeps its rows: the crop generator draws in the order of access, so a
    rank that decoded its own images alone would draw other crops."""
    ds = ImageFolderDataset(image_dir or cfg.dataset_dir, global_size=cfg.image_size,
                            local_size=cfg.image_size,
                            min_local_crop=min(min_local_crop, cfg.image_size), seed=cfg.seed)
    n_val = int(len(ds) * cfg.val_split)
    indices = list(range(len(ds)))
    np.random.RandomState(cfg.seed).shuffle(indices)
    val_idx, train_idx = indices[:n_val], indices[n_val:]
    trainer = Trainer(cfg, device)
    if resume:
        trainer.resume(resume)
    d = _data_index(cfg)
    return trainer.run(
        train_batches=lambda epoch: (shard_batch(b, d, cfg.dp) for b in image_batches(
            ds, train_idx, cfg.batch_size, cfg.seed + epoch)),
        val_batches=((lambda: (shard_batch(b, d, cfg.dp)
                               for b in image_batches(ds, val_idx, cfg.batch_size)))
                     if n_val >= cfg.batch_size else None),
        max_steps=cfg.num_iterations or None,
        steps_per_epoch=len(train_idx) // cfg.batch_size,
        profile_dir=profile_dir,
    )
