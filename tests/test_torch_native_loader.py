"""The port's native C++ NYU loader (``data/native_loader``) on the CPU.

Each case of the JAX package's ``tests/test_native_loader.py`` for the
port's loader, against the port's Python loader (``data/nyu``) and the JAX
package's ``NativeNYULoader``:

- the batches against the Python loader's: depths bit for bit
  (INTER_NEAREST); RGB within one cubic-resize step where a resize happens
  (the ``cv2`` package's OpenCV and the system's round INTER_CUBIC apart by
  up to one 1/255 step, the JAX test's ``ONE_CUBIC_STEP``) and bit for bit
  where none does (the port's C++ computes in the Python loader's order);
- the same epochs and shards as the Python loader, a multithreaded stream
  that crosses epochs and is the same with 1 and 4 threads, the retry after
  an unreadable file, a missing CSV, shards that partition an epoch;
- against the JAX native loader: depths within 1e-7 and images within
  1e-6, the same epoch and shard (the JAX C++ multiplies by the scale's
  reciprocal where the port divides by it, as the Python loader does);
- ``train_nyu`` on the native path: the Python loader's losses bit for bit
  on images that need no resize, a data rank's batches on its epoch shard
  equal to the Python loader's, and the Python loader with a logged
  warning where the library cannot be built.

The library builds with g++ against ``/usr/include/opencv4``; where it
cannot, the tests that need it skip.
"""
import dataclasses
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from distill_any_depth_tpu.data import native_loader as jax_native  # noqa: E402
from distill_any_depth_tpu_torch import configs  # noqa: E402
from distill_any_depth_tpu_torch.configs import (  # noqa: E402
    LossConfig,
    OptimizerConfig,
    TrainConfig,
)
from distill_any_depth_tpu_torch.data import native_loader  # noqa: E402
from distill_any_depth_tpu_torch.data.nyu import NYUDataset, iterate_batches  # noqa: E402
from distill_any_depth_tpu_torch.parallel import launch  # noqa: E402
from distill_any_depth_tpu_torch.train import loop  # noqa: E402

ONE_CUBIC_STEP = (1.0 / 255.0) / 0.224 + 1e-4
SIZE = 56


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def needs_native():
    if not native_loader.available():
        pytest.skip("the native loader cannot be built here (g++ or OpenCV's headers missing)")


def _tree(root: Path, hw=(48, 64)):
    """6 RGB/depth pairs (uint8 and uint16 depths) and their CSV."""
    rng = np.random.RandomState(0)
    d = root / "data"
    d.mkdir()
    rows = []
    for i in range(6):
        cv2.imwrite(str(d / f"rgb{i}.png"), rng.randint(0, 255, (*hw, 3), np.uint8))
        dep = (rng.randint(0, 255, hw, np.uint8) if i % 2 == 0
               else rng.randint(0, 65535, hw).astype(np.uint16))
        cv2.imwrite(str(d / f"dep{i}.png"), dep)
        rows.append(f"data/rgb{i}.png,data/dep{i}.png")
    csv = d / "nyu2_train.csv"
    csv.write_text("\n".join(rows))
    return root, str(csv)


@pytest.fixture
def nyu_tree(tmp_path):
    return _tree(tmp_path)


@pytest.fixture
def square_tree(tmp_path):
    """Frames already at the target size: neither loader resizes."""
    return _tree(tmp_path, (SIZE, SIZE))


def _python(csv: str, root) -> NYUDataset:
    return NYUDataset("train", dataset_dir=os.path.dirname(csv), image_size=SIZE,
                      root_dir=str(root))


@pytest.mark.parametrize("tree", ["nyu_tree", "square_tree"])
def test_native_matches_python_loader(needs_native, request, tree):
    root, csv = request.getfixturevalue(tree)
    with native_loader.NativeNYULoader(csv, str(root), image_size=SIZE, batch_size=6,
                                       num_threads=1, shuffle=False) as loader:
        assert len(loader) == 6
        batch = loader.next_batch()
    py = _python(csv, root)
    for i in range(6):
        s = py[i]
        assert np.array_equal(batch["depth"][i], s.depth), i
        if tree == "square_tree":
            assert np.array_equal(batch["image"][i], s.image), i
        else:
            np.testing.assert_allclose(batch["image"][i], s.image, atol=ONE_CUBIC_STEP)


def test_native_and_python_loaders_yield_identical_shards(needs_native, nyu_tree):
    root, csv = nyu_tree
    py = _python(csv, root)
    seed = 7
    for shard in range(2):
        with native_loader.NativeNYULoader(csv, str(root), image_size=SIZE, batch_size=1,
                                           num_threads=3, seed=seed, shard_index=shard,
                                           num_shards=2) as loader:
            assert loader.shard_len() == 3
            for epoch in range(2):
                native = list(loader.batches(3, epoch=epoch))
                python = list(iterate_batches(py, 1, shuffle=True, seed=seed + epoch,
                                              shard_index=shard, num_shards=2))
                assert len(native) == len(python) == 3
                for nb, pb in zip(native, python):
                    assert np.array_equal(nb["depth"], pb["depth"]), (shard, epoch)
                    np.testing.assert_allclose(nb["image"], pb["image"], atol=ONE_CUBIC_STEP)


def test_native_multithreaded_stream(needs_native, nyu_tree):
    root, csv = nyu_tree
    streams = []
    for threads in (1, 4):
        with native_loader.NativeNYULoader(csv, str(root), image_size=SIZE, batch_size=4,
                                           num_threads=threads, seed=1) as loader:
            streams.append(list(loader.batches(5)))  # 20 samples: crosses epochs
    one, four = streams
    assert len(four) == 5
    for a, b in zip(one, four):
        assert a["image"].shape == (4, SIZE, SIZE, 3) and np.isfinite(a["image"]).all()
        assert 0 <= a["depth"].min() and a["depth"].max() <= 1.0
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["depth"], b["depth"])


def test_native_corrupt_file_retry(needs_native, nyu_tree):
    root, csv = nyu_tree
    (root / "data" / "rgb2.png").write_bytes(b"garbage")
    with native_loader.NativeNYULoader(csv, str(root), image_size=SIZE, batch_size=6,
                                       num_threads=2, seed=2) as loader:
        batch = loader.next_batch()
    assert np.isfinite(batch["image"]).all()


def test_native_missing_csv(needs_native, tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.NativeNYULoader(str(tmp_path / "nope.csv"), str(tmp_path),
                                      image_size=SIZE, batch_size=2)


def test_native_loader_sharding(needs_native, nyu_tree):
    root, csv = nyu_tree
    covered = []
    for idx in range(2):
        with native_loader.NativeNYULoader(csv, str(root), image_size=SIZE, batch_size=1,
                                           num_threads=1, seed=5, num_shards=2,
                                           shard_index=idx) as loader:
            assert len(loader) == 6 and loader.shard_len() == 3
            covered += [b["depth"][0].tobytes() for b in loader.batches(3, epoch=0)]
    assert len(covered) == len(set(covered)) == 6


def test_native_matches_jax_native_loader(needs_native, nyu_tree):
    if not jax_native.available():
        pytest.skip("the JAX package's native loader cannot be built here")
    root, csv = nyu_tree
    kw = dict(image_size=SIZE, batch_size=2, num_threads=2, seed=3, shard_index=1,
              num_shards=2)
    with native_loader.NativeNYULoader(csv, str(root), **kw) as ours:
        got = list(ours.batches(1, epoch=1))
    theirs = jax_native.NativeNYULoader(csv, str(root), **kw)
    want = list(theirs.batches(1, epoch=1))
    theirs.close()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["depth"], b["depth"], atol=1e-7, rtol=0)
        np.testing.assert_allclose(a["image"], b["image"], atol=1e-6, rtol=0)


def test_build_names_no_path_of_the_jax_package(monkeypatch, tmp_path):
    """The port builds its own copy of the source into its build directory."""
    text = native_loader.SOURCE.read_text()
    assert native_loader.SOURCE.parent.parent.name == "distill_any_depth_tpu_torch"
    assert "distill_any_depth_tpu/" not in text and "jax" not in text.lower()
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        raise OSError("no compiler")

    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="no compiler"):
        native_loader.build()
    (cmd,) = seen
    assert str(native_loader.SOURCE) in cmd
    assert not [a for a in cmd if "distill_any_depth_tpu/" in a]
    assert cmd[cmd.index("-o") + 1].startswith(str(tmp_path))


def _train_cfg(tmp_path, csv: str, **kw) -> TrainConfig:
    tiny = configs.MODELS["depthanything-small"]
    enc = dataclasses.replace(tiny.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 1, 1, 1))
    tiny = dataclasses.replace(tiny, encoder=enc, features=32, out_channels=(16, 32, 48, 64))
    return TrainConfig(student=tiny, teachers=("tiny-native-teacher",),
                       loss=LossConfig(use_hdn=False),
                       optimizer=OptimizerConfig(total_steps=4), batch_size=2, image_size=SIZE,
                       num_epochs=2, num_iterations=3, val_split=0.34, checkpoint_interval=0,
                       log_interval=1, visualize_interval=0, output_dir=str(tmp_path),
                       dataset_dir=os.path.dirname(csv), teacher_dtype="float32",
                       student_compute_dtype="float32", teacher_chunk=0, **kw)


@pytest.fixture
def tiny_teacher(monkeypatch):
    cfg = configs.MODELS["depthanything-small"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 1, 1, 1))
    monkeypatch.setitem(configs.MODELS, "tiny-native-teacher", dataclasses.replace(
        cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64)))


def test_train_nyu_native_matches_python_loader(needs_native, tiny_teacher, square_tree,
                                                tmp_path, caplog):
    """3 steps over two epochs and a validation pass each way: the native
    run's history is the Python loader's, bit for bit."""
    root, csv = square_tree
    histories = {}
    for native in (True, False):
        cfg = _train_cfg(tmp_path / str(native), csv, use_native_loader=native)
        with caplog.at_level(logging.INFO, "distill_any_depth_tpu_torch.train"):
            histories[native] = loop.train_nyu(cfg, root_dir=str(root), device="cpu")
    assert "native loader: 4 train samples" in caplog.text
    assert "Python loader: 4 train samples" in caplog.text
    assert histories[True] == histories[False]
    assert len(histories[True]["train_loss"]) == 2 and len(histories[True]["val_loss"]) == 1


def test_train_nyu_loaders_take_the_data_rank_shard(needs_native, square_tree, tmp_path,
                                                    monkeypatch, caplog):
    """Rank 3 of a dp=2 x tp=2 grid is data rank 1: through ``train_nyu``
    (its Trainer replaced by one that reads two epochs of batches), the
    native loader yields the Python loader's rows of that rank, shard 1 of
    2 at batch_size / dp rows, bit for bit."""
    root, csv = square_tree

    class Reader:
        def __init__(self, cfg, device):
            pass

        def run(self, train_batches, val_batches, max_steps, steps_per_epoch, profile_dir):
            return {"steps": steps_per_epoch, "val": val_batches is not None,
                    "epochs": [list(train_batches(epoch)) for epoch in range(2)]}

    monkeypatch.setattr(loop, "Trainer", Reader)
    monkeypatch.setattr(launch, "process_index", lambda: 3)
    runs = {}
    for native in (True, False):
        cfg = _train_cfg(tmp_path, csv, dp=2, tp=2, use_native_loader=native)
        with caplog.at_level(logging.INFO, "distill_any_depth_tpu_torch.train"):
            runs[native] = loop.train_nyu(cfg, root_dir=str(root), device="cpu")
    assert "native loader: 4 train samples" in caplog.text
    native, python = runs[True], runs[False]
    assert native["steps"] == python["steps"] == 2 and native["val"] and python["val"]
    for a, b in zip(sum(native["epochs"], []), sum(python["epochs"], [])):
        assert a["image"].shape[0] == 1
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["depth"], b["depth"])
    assert len(sum(native["epochs"], [])) == 4


def test_train_nyu_falls_back_to_python_loader(tiny_teacher, square_tree, tmp_path, caplog,
                                               monkeypatch):
    root, csv = square_tree
    monkeypatch.setattr(native_loader, "available", lambda: False)
    cfg = _train_cfg(tmp_path, csv, use_native_loader=True)
    with caplog.at_level(logging.INFO):
        history = loop.train_nyu(cfg, root_dir=str(root), device="cpu")
    assert "using the Python loader" in caplog.text
    assert "Python loader: 4 train samples" in caplog.text
    assert np.isfinite(history["train_loss"]).all()
