"""Image-folder distillation, device preprocessing, step timing, the
profiler and the visualisation of the port's training, on the CPU, against
the JAX package where it has the same function.

- ``ImageFolderDataset``: samples (both views, the crop box, the path)
  equal to JAX's bit for bit over a train, validate, train order of
  access, with and without ``square_global``, over PNGs and a JPEG in
  nested folders and an unreadable file (the next index's sample).
- ``train_images``: the batches of two epochs and the validation passes,
  and the Trainer's arguments, equal to JAX's (each package's ``Trainer``
  replaced by one that records what ``run`` is given).
- ``cli.train --data_mode images``: 2 steps and a resume to step 4 end at
  the uninterrupted 4-step run's parameters bit for bit.
- ``--device_preprocess``: the NYU samples equal JAX's uint8 samples; the
  Trainer's views of a uint8 batch equal JAX ``preprocess_on_device``
  within ``tests/test_torch_predict.py``'s tolerance.
- ``StepTimer`` equal to JAX's on a fake clock; ``--profile_dir`` writes a
  Chrome trace of the first 3 steps.
- The visualisation's files written with matplotlib unimportable; a
  drawing error is logged and the run goes on.
"""
import dataclasses
import json
import sys
import types
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import TrainConfig as JTrainConfig
from distill_any_depth_tpu.data.images import ImageFolderDataset as JImageFolderDataset
from distill_any_depth_tpu.data.nyu import NYUDataset as JNYUDataset
from distill_any_depth_tpu.ops.preprocess import preprocess_on_device as jax_preprocess
from distill_any_depth_tpu.train import loop as jax_loop
from distill_any_depth_tpu.utils import profiling as jax_profiling
from distill_any_depth_tpu_torch.cli import train as train_cli
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, TrainConfig
from distill_any_depth_tpu_torch.data.images import ImageFolderDataset
from distill_any_depth_tpu_torch.data.nyu import NYUDataset
from distill_any_depth_tpu_torch.train import loop
from distill_any_depth_tpu_torch.utils import checkpoint as ckpt
from distill_any_depth_tpu_torch.utils import profiling, visualize
from distill_any_depth_tpu_torch.utils.image_util import _magma_lut

ROOT = Path(__file__).resolve().parents[1]
SIZE = 56
TINY = "tiny-images"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """A tiny ViT preset of the port, student and teacher alike."""
    cfg = MODELS["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    MODELS[TINY] = dataclasses.replace(cfg, encoder=enc, features=32,
                                       out_channels=(16, 32, 48, 64))
    yield TINY
    del MODELS[TINY]


def _folder(root: Path, n: int, hw=(120, 160), bad: bool = False) -> Path:
    """``n`` random images: PNGs in two nested folders and one JPEG, and,
    with ``bad``, a file with a .png name that is no image."""
    rng = np.random.RandomState(n)
    for i in range(n):
        sub = root / ("a" if i % 2 else "b/c")
        sub.mkdir(parents=True, exist_ok=True)
        img = rng.randint(0, 256, (*hw, 3), np.uint8)
        cv2.imwrite(str(sub / (f"{i:02d}.jpg" if i == 3 else f"{i:02d}.png")), img)
    if bad:
        (root / "a" / "05_bad.png").write_bytes(b"not an image")
    return root


def _same_sample(got, want) -> None:
    assert got.crop_box == want.crop_box and got.image_path == want.image_path
    for view in ("global_image", "local_image"):
        g, w = getattr(got, view), getattr(want, view)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, view
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), view


@pytest.mark.parametrize("square_global", [True, False], ids=["square", "aspect"])
def test_image_folder_samples_match_jax(tmp_path, square_global):
    root = _folder(tmp_path, 9, bad=True)
    kw = dict(global_size=112, local_size=84, min_local_crop=70, seed=5,
              square_global=square_global)
    port, jax_ds = ImageFolderDataset(str(root), **kw), JImageFolderDataset(str(root), **kw)
    assert port.image_paths == jax_ds.image_paths and len(port) == 10
    bad = next(i for i, p in enumerate(port.image_paths) if p.endswith("_bad.png"))
    # train, validate, train: one generator draws the crops of all three
    order = [0, bad, 4, 7, 2] + [9, 1] + [bad, 0, 6, 12]
    for i in order:
        _same_sample(port[i], jax_ds[i])
    s = port[0]
    gh, gw = s.global_image.shape[:2]
    assert s.local_image.shape == (84, 84, 3)
    assert (gh, gw) == (112, 112) if square_global else (gh % 14 == 0 and gw % 14 == 0)
    assert port[bad].image_path == port.image_paths[bad + 1]


class _Recorder:
    """Stands in for a package's ``Trainer``: ``run`` walks two epochs of
    training batches, each followed by a validation pass, as the Trainer
    asks for them, and returns what it saw."""

    def __init__(self, cfg, *args, **kwargs):
        pass

    def run(self, train_batches, val_batches=None, **kwargs):
        seen = {"kwargs": kwargs, "batches": []}
        for epoch in range(2):
            seen["batches"] += list(train_batches(epoch))
            if val_batches is not None:
                seen["batches"] += list(val_batches())
        return seen


def test_train_images_batches_match_jax(tmp_path, monkeypatch):
    root = _folder(tmp_path, 9)
    kw = dict(batch_size=2, image_size=SIZE, seed=3, val_split=0.25, num_iterations=5,
              dataset_dir=str(root))
    monkeypatch.setattr(jax_loop, "Trainer", _Recorder)
    monkeypatch.setattr(loop, "Trainer", _Recorder)
    want = jax_loop.train_images(JTrainConfig(**kw), min_local_crop=42)
    got = loop.train_images(TrainConfig(**kw), min_local_crop=42, device="cpu")
    # 7 training images: 3 batches an epoch; 2 validation images: 1 batch
    assert len(got["batches"]) == len(want["batches"]) == 2 * (3 + 1)
    for g, w in zip(got["batches"], want["batches"]):
        assert sorted(g) == sorted(w) == ["global_image", "local_image"]
        for k in g:
            assert g[k].shape == (2, SIZE, SIZE, 3)
            assert np.array_equal(g[k].view(np.uint32), w[k].view(np.uint32)), k
    assert got["kwargs"] == want["kwargs"]
    assert got["kwargs"]["steps_per_epoch"] == 3 and got["kwargs"]["max_steps"] == 5


def test_cli_images_resume_is_exact(tmp_path, tiny):
    """Two steps, then ``--resume`` to step 4, against an uninterrupted
    4-step run (a constant learning rate, so that the schedule does not
    depend on ``--num_iterations``): the same parameters and Adam state
    bit for bit. All 4 steps are in the first epoch, where a resume replays
    the crops (the dataset's generator starts afresh in a new run)."""
    root = _folder(tmp_path / "imgs", 10)
    args = ["--device", "cpu", "--data_mode", "images", "--dataset_dir", str(root),
            "--student_arch", tiny, "--teacher_models", tiny, "--batch_size", "2",
            "--image_size", str(SIZE), "--teacher_dtype", "float32", "--use_hdn_loss",
            "--scheduler_type", "none", "--checkpoint_interval", "0",
            "--visualize_interval", "0", "--log_interval", "1", "--lr", "1e-3"]
    full, part = tmp_path / "full", tmp_path / "part"
    history = train_cli.main([*args, "--output_dir", str(full), "--num_iterations", "4"])
    assert len(history["lr"]) == 4 and np.isfinite(history["train_loss"]).all()
    train_cli.main([*args, "--output_dir", str(part), "--num_iterations", "2"])
    train_cli.main([*args, "--output_dir", str(part), "--num_iterations", "4",
                    "--resume", str(part)])
    a, b = ckpt.restore_train_state(str(full)), ckpt.restore_train_state(str(part))
    assert int(a["step"]) == int(b["step"]) == 4
    for x, y in zip(a["params"], b["params"]):
        assert torch.equal(x, y)
    for x, y in zip(a["adam"], b["adam"]):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_two_view_step_has_nonzero_lg(tmp_path, tiny):
    """A ``Trainer`` step on an image-folder batch runs the student on
    both views: LG is not zero (it is with one view)."""
    root = _folder(tmp_path / "imgs", 4)
    ds = ImageFolderDataset(str(root), global_size=SIZE, local_size=SIZE, min_local_crop=SIZE,
                            seed=0)
    cfg = TrainConfig(student=MODELS[tiny], teachers=(tiny,), batch_size=2, image_size=SIZE,
                      output_dir=str(tmp_path / "out"), teacher_dtype="float32",
                      student_compute_dtype="float32", teacher_chunk=0, visualize_interval=0,
                      loss=LossConfig(use_hdn=False))
    trainer = loop.Trainer(cfg, "cpu")
    metrics = []
    trainer.run(lambda epoch: loop.image_batches(ds, [0, 1, 2, 3], 2), max_steps=2,
                on_step=lambda step, m: metrics.append({k: float(v) for k, v in m.items()}))
    assert len(metrics) == 2 and all(m["lg"] > 1e-4 for m in metrics)


def test_device_preprocess_samples_match_jax():
    kw = dict(dataset_dir=str(ROOT / "data/smoke"), image_size=SIZE, root_dir=str(ROOT),
              device_preprocess=True)
    port, jax_ds = NYUDataset("train", **kw), JNYUDataset("train", **kw)
    assert len(port) == len(jax_ds) == 6
    for i in range(len(port)):
        got, want = port[i], jax_ds[i]
        assert got.image.dtype == np.uint8 and got.image.shape == (120, 160, 3)
        assert np.array_equal(got.image, want.image) and got.rgb_path == want.rgb_path
        assert np.array_equal(got.depth, want.depth)


def test_device_preprocess_views_match_jax():
    """``Trainer._views`` of a uint8 NYU batch: the frames go to the device
    as they are and are resized and normalized there (``cfg.image_size``
    square, NCHW fp32), one tensor for both views."""
    batch = np.stack([JNYUDataset("train", dataset_dir=str(ROOT / "data/smoke"), image_size=SIZE,
                                  root_dir=str(ROOT), device_preprocess=True)[i].image
                      for i in range(2)])
    fake = types.SimpleNamespace(device=torch.device("cpu"),
                                 cfg=types.SimpleNamespace(image_size=SIZE))
    g, l = loop.Trainer._views(fake, {"image": batch})
    assert g is l and g.shape == (2, 3, SIZE, SIZE) and g.dtype == torch.float32
    want = np.asarray(jax_preprocess(jnp.asarray(batch), SIZE)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4)


def test_step_timer_matches_jax(monkeypatch):
    now = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.125, 4.0])
    times = []

    def clock():
        times.append(next(now))
        return times[-1]

    monkeypatch.setattr("time.perf_counter", lambda: times[-1])
    port, theirs = profiling.StepTimer(window=3), jax_profiling.StepTimer(window=3)
    for batch in (2, 4, 4, 8, 2, 4, 6):
        clock()
        port.tick(batch)
        theirs.tick(batch)
        assert port.steps_per_sec == theirs.steps_per_sec
        assert port.images_per_sec == theirs.images_per_sec
    assert port.steps_per_sec == 3 / 2.5 and port.images_per_sec == 12 / 2.5


def _run_tiny(tmp_path, tiny, steps: int, **kw):
    cfg = TrainConfig(student=MODELS[tiny], teachers=(tiny,), batch_size=2, image_size=SIZE,
                      output_dir=str(tmp_path), teacher_dtype="float32",
                      student_compute_dtype="float32", teacher_chunk=0,
                      loss=LossConfig(use_hdn=False), **kw)
    rng = np.random.RandomState(0)
    data = [{"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32)} for _ in range(steps)]
    trainer = loop.Trainer(cfg, "cpu")
    return trainer, data


def test_profile_dir_traces_first_steps(tmp_path, tiny):
    """The trace file appears when step 3 ends, not before, and holds the
    ops of the traced steps."""
    trainer, data = _run_tiny(tmp_path / "run", tiny, 4, visualize_interval=0)
    trace_file = tmp_path / "prof" / profiling.TRACE_FILE
    exists = []
    trainer.run(lambda epoch: data, max_steps=4, profile_dir=str(tmp_path / "prof"),
                on_step=lambda step, m: exists.append(trace_file.exists()))
    assert exists == [False, False, True, True]
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any("aten::linear" in e.get("name", "") for e in events)


def test_visualization_without_matplotlib(tmp_path, tiny, monkeypatch):
    """With matplotlib unimportable, ``visualize_interval=1`` draws a panel
    file every step (student | teacher | error for 2 samples) and the run
    ends with the loss and LR plots."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    trainer, data = _run_tiny(tmp_path, tiny, 2, visualize_interval=1, log_interval=1)
    trainer.run(lambda epoch: data, max_steps=2)
    for step in (1, 2):
        img = cv2.imread(str(tmp_path / "visualizations" / f"depth_step_{step}.png"))
        assert img is not None and img.shape[0] == 2 * (SIZE + 28) and img.shape[1] > 3 * SIZE
    for name in ("loss_curves.png", "lr_schedule.png"):
        assert cv2.imread(str(tmp_path / "plots" / name)) is not None, name


def test_drawing_errors_do_not_end_a_run(tmp_path, tiny, monkeypatch, caplog):
    def broken(*args, **kwargs):
        raise RuntimeError("no drawing today")

    monkeypatch.setattr(visualize, "visualize_depth_predictions", broken)
    monkeypatch.setattr(visualize, "plot_history", broken)
    trainer, data = _run_tiny(tmp_path, tiny, 1, visualize_interval=1)
    history = trainer.run(lambda epoch: data, max_steps=1)
    assert len(history["train_loss"]) == 1 and (tmp_path / "student_final.safetensors").exists()
    assert "visualization failed" in caplog.text and "history plotting failed" in caplog.text


def test_magma_table_follows_matplotlib():
    """The error panels' table is within 0.01 of matplotlib's magma."""
    matplotlib = pytest.importorskip("matplotlib")
    want = matplotlib.colormaps["magma"](np.arange(256))[:, :3]
    assert np.abs(_magma_lut() - want).max() < 0.01
