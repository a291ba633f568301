"""The port's checkpoint I/O (``utils/checkpoint``), saves and resume
(``train/loop``), ``cli.convert`` and the checkpoint flags of ``cli.train``,
against the ``safetensors`` package and the JAX package on the CPU.

- Safetensors format: files the port writes read through
  ``safetensors.numpy``/``safetensors.torch`` equal bit for bit (and are
  byte for byte the files ``safetensors.torch`` writes); files from
  ``safetensors`` read through the port equal bit for bit; other dtypes
  raise.
- Across packages: JAX ``load_safetensors(strict=True)`` reads a student the
  port wrote into params equal (bit for bit) to the JAX params it came
  from; the port's ``convert_checkpoint`` equals JAX ``convert_checkpoint``
  in keys, bytes and count.
- Train state: a bit-exact round trip, the run-dir layout, and the resume
  contract of the JAX package (``tests/test_pipeline.py``): a Trainer
  resumed at step 5 of 3-batch epochs sees the uninterrupted run's batches
  and ends at its parameters bit for bit.
- Saves: periodic, final, best and emergency files; teacher checkpoints.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy
from safetensors import torch as st_torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.utils import checkpoint as jax_ckpt
from distill_any_depth_tpu.utils.torch_interop import params_to_torch
from distill_any_depth_tpu_torch.cli import convert as convert_cli
from distill_any_depth_tpu_torch.cli import train as train_cli
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.train.loop import Trainer
from distill_any_depth_tpu_torch.utils import checkpoint as ckpt
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
SIZE = 56
TEACHER = "tiny-ckpt-io-teacher"


def _tiny(models):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models here on one thread: Tier-1 runs several test files at
    once, and torch's default of a thread per core oversubscribes the CPU
    (the training tests ran 10x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_student():
    """Seeded JAX params of the tiny model and their config."""
    jcfg = _tiny(JAX_MODELS)
    params = jax.jit(jax_create_model(jcfg).init)(jax.random.PRNGKey(5),
                                                  jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def teacher_name():
    """The tiny config registered as a teacher preset for the Trainer."""
    MODELS[TEACHER] = _tiny(MODELS)
    yield TEACHER
    del MODELS[TEACHER]


def _mixed_tensors() -> dict:
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=gen), "h": torch.randn(7, generator=gen).half(),
            "b": torch.randn(2, 4, generator=gen).bfloat16(),
            "i": torch.randint(-9, 9, (4,), generator=gen),
            "j": torch.randint(-9, 9, (2, 2), generator=gen, dtype=torch.int32),
            "s": torch.tensor(2.5), "e": torch.zeros(0, 3)}


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), k


def test_port_file_reads_through_safetensors(tmp_path):
    """Every dtype, a 0-d and an empty tensor: read back by ``safetensors``
    equal bit for bit (BF16 through its torch API, numpy having no bf16),
    and the file equals the one ``safetensors`` writes."""
    tensors = _mixed_tensors()
    mine, theirs = tmp_path / "mine.safetensors", tmp_path / "theirs.safetensors"
    ckpt.write_safetensors(str(mine), tensors)
    st_torch.save_file(tensors, str(theirs))
    _assert_same(st_torch.load_file(str(mine)), tensors)
    no_bf16 = {k: v for k, v in tensors.items() if v.dtype != torch.bfloat16}
    ckpt.write_safetensors(str(tmp_path / "np.safetensors"), no_bf16)
    loaded = st_numpy.load_file(str(tmp_path / "np.safetensors"))
    _assert_same({k: torch.from_numpy(v) for k, v in loaded.items()}, no_bf16)
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_safetensors_files_read_through_port(tmp_path, dtype):
    gen = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn(5, 3, generator=gen).to(dtype),
               "a.bias": torch.randn(5, generator=gen).to(dtype),
               "z": torch.randn(2, 3, 4, generator=gen).to(dtype)}
    path = str(tmp_path / "f.safetensors")
    st_torch.save_file(tensors, path, metadata={"source": "safetensors", "n": "3"})
    _assert_same(ckpt.read_safetensors(path), tensors)


@pytest.mark.parametrize("dtype", [np.float64, np.uint8, np.bool_], ids=["F64", "U8", "BOOL"])
def test_unknown_dtype_raises(tmp_path, dtype):
    path = str(tmp_path / "f.safetensors")
    st_numpy.save_file({"ok": np.zeros(2, np.float32), "bad": np.zeros(3, dtype)}, path)
    name = {np.float64: "F64", np.uint8: "U8", np.bool_: "BOOL"}[dtype]
    with pytest.raises(ValueError, match=f"'bad' has dtype {name}"):
        ckpt.read_safetensors(path)
    with pytest.raises(ValueError, match="only"):
        ckpt.write_safetensors(str(tmp_path / "g.safetensors"),
                               {"bad": torch.from_numpy(np.zeros(3, dtype))})


def test_jax_reads_port_written_student(tmp_path, jax_student):
    """JAX params -> the port's model -> ``save_safetensors`` -> JAX
    ``load_safetensors(strict=True)``: the params come back bit for bit."""
    jcfg, params = jax_student
    model = create_model(_tiny(MODELS), device="cpu")
    model.load_state_dict(params_from_jax(params, _tiny(MODELS)), strict=True)
    path = str(tmp_path / "student.safetensors")
    ckpt.save_safetensors(path, model)
    loaded = jax_ckpt.load_safetensors(path, jcfg, strict=True)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(loaded))
    assert len(got) == len(want)
    for path_, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path_]), leaf, err_msg=str(path_))
    assert set(st_numpy.load_file(path)) == set(params_to_torch(params, jcfg))


def test_convert_matches_jax(tmp_path, jax_student):
    """``cli.convert`` and JAX ``convert_checkpoint`` on one JAX-written
    file: the same renamed count, keys and bytes."""
    jcfg, params = jax_student
    src = str(tmp_path / "in.safetensors")
    jax_ckpt.save_safetensors(src, params, jcfg)
    n_jax = jax_ckpt.convert_checkpoint(src, str(tmp_path / "jax.safetensors"))
    n_port = convert_cli.main([src, str(tmp_path / "port.safetensors")])
    assert n_port == n_jax > 0
    want = st_numpy.load_file(str(tmp_path / "jax.safetensors"))
    got = ckpt.read_safetensors(str(tmp_path / "port.safetensors"))
    assert any(k.startswith("backbone.") for k in got)
    assert not any(k.startswith("pretrained.") for k in got)
    _assert_same(got, {k: torch.from_numpy(v) for k, v in want.items()})
    assert (tmp_path / "port.safetensors").read_bytes() == (
        tmp_path / "jax.safetensors").read_bytes()


def _cfg(tmp_path, teacher_name, **kw) -> TrainConfig:
    base = dict(student=_tiny(MODELS), teachers=(teacher_name,), loss=LossConfig(use_hdn=False),
                optimizer=OptimizerConfig(total_steps=100), batch_size=1, image_size=SIZE,
                num_epochs=4, val_split=0.0, checkpoint_interval=0, log_interval=100,
                output_dir=str(tmp_path), student_compute_dtype="float32",
                teacher_dtype="float32")
    return TrainConfig(**{**base, **kw})


DATA = np.random.RandomState(0).rand(3, SIZE, SIZE, 3).astype(np.float32)  # 3 batches an epoch


def _logged_batches(log: list):
    def train_batches(epoch):
        for i in range(3):
            log.append((epoch, i))
            yield {"image": DATA[i][None]}
    return train_batches


def _params(trainer) -> list[torch.Tensor]:
    return [p.detach().clone() for p in trainer.state.params]


def test_train_state_round_trip(tmp_path, teacher_name):
    """After 2 steps, the state saved and restored into a fresh Trainer is
    equal bit for bit (parameters, Adam moments and counts, lr, counters),
    through the state directory and through the run's output directory;
    the restored parameters' versions moved."""
    trainer = Trainer(_cfg(tmp_path / "a", teacher_name), "cpu")
    trainer.run(_logged_batches([]), max_steps=2)
    want = trainer.state.state_dict()
    assert int(want["step"]) == 2 and all(a for a in want["adam"])
    ckpt.save_train_state(str(tmp_path / "state"), trainer.state)
    for path in (tmp_path / "state", tmp_path / "a"):  # the state dir, the run dir
        fresh = Trainer(_cfg(tmp_path / "b", teacher_name), "cpu")
        versions = [p._version for p in fresh.state.params]
        fresh.resume(str(path))
        got = fresh.state.state_dict()
        assert [p._version for p in fresh.state.params] != versions
        for key in want:
            if key == "adam":
                for g, w in zip(got[key], want[key]):
                    _assert_same(g, w)
            elif key == "params":
                _assert_same(dict(enumerate(got[key])), dict(enumerate(want[key])))
            else:
                _assert_same({key: got[key]}, {key: want[key]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "nothing"))


def test_resume_continues_exact_data_order_and_parameters(tmp_path, teacher_name):
    """The contract of the JAX package's ``test_resume_continues_exact_data_
    order``: interrupted at step 5 of 3-batch epochs and resumed from its
    files, the run continues at (epoch 1, batch 2), trains on exactly the
    batches the uninterrupted run did, and its parameters after step 12
    equal the uninterrupted run's bit for bit."""
    full_log = []
    full = Trainer(_cfg(tmp_path / "full", teacher_name), "cpu")
    full.run(_logged_batches(full_log), max_steps=12, steps_per_epoch=3)

    part_log = []
    Trainer(_cfg(tmp_path / "part", teacher_name), "cpu").run(
        _logged_batches(part_log), max_steps=5, steps_per_epoch=3)
    resumed_log = []
    resumed = Trainer(_cfg(tmp_path / "resumed", teacher_name), "cpu")
    resumed.resume(str(tmp_path / "part"))
    assert int(resumed.state.step) == 5
    resumed.run(_logged_batches(resumed_log), max_steps=12, steps_per_epoch=3)
    # the producer logs the 2 batches the fast-forward skips too
    assert resumed_log[2] == (1, 2)
    assert part_log[:5] + resumed_log[2:] == full_log
    for a, b in zip(_params(resumed), _params(full)):
        assert torch.equal(a, b)


def test_trainer_writes_checkpoints(tmp_path, teacher_name):
    """Periodic (every 2 steps), best (validation improved) and final
    weights and the train state; every file holds the student's weights in
    the reference layout and the final one equals its parameters."""
    trainer = Trainer(_cfg(tmp_path, teacher_name, checkpoint_interval=2, num_epochs=2), "cpu")
    trainer.run(_logged_batches([]), val_batches=lambda: [{"image": DATA[:1]}])
    names = {p.name for p in tmp_path.iterdir()}
    assert {"student_checkpoint_2.safetensors", "student_checkpoint_4.safetensors",
            "student_checkpoint_6.safetensors", "student_best.safetensors",
            "student_final.safetensors", "train_state", "history.json"} <= names
    assert "student_emergency.safetensors" not in names
    final = ckpt.read_safetensors(str(tmp_path / "student_final.safetensors"))
    _assert_same(final, {k: v.detach() for k, v in trainer.student.state_dict().items()})
    assert len(json.loads((tmp_path / "history.json").read_text())["val_loss"]) == 2


def test_failed_run_leaves_emergency_checkpoint(tmp_path, teacher_name):
    def failing(epoch):
        yield {"image": DATA[:1]}
        raise OSError("disk gone")

    trainer = Trainer(_cfg(tmp_path, teacher_name), "cpu")
    with pytest.raises(OSError, match="disk gone"):
        trainer.run(failing)
    saved = ckpt.read_safetensors(str(tmp_path / "student_emergency.safetensors"))
    _assert_same(saved, {k: v.detach() for k, v in trainer.student.state_dict().items()})
    assert not (tmp_path / "student_final.safetensors").exists()


def test_teacher_checkpoints_load(tmp_path, teacher_name):
    """Teacher i loads ``teacher_checkpoints[i]`` (backbone keys, as
    ``cli.convert`` writes them); a teacher without one keeps seed 100 + i."""
    source = create_model(teacher_name, device="cpu", seed=7)
    ckpt.save_safetensors(str(tmp_path / "t.safetensors"), source)
    assert convert_cli.main([str(tmp_path / "t.safetensors"),
                             str(tmp_path / "t_backbone.safetensors")]) > 0
    cfg = _cfg(tmp_path, teacher_name, teachers=(teacher_name, teacher_name),
               teacher_checkpoints=(str(tmp_path / "t_backbone.safetensors"),))
    trainer = Trainer(cfg, "cpu")
    seeded = create_model(teacher_name, device="cpu", seed=101)
    for (k, a), b in zip(trainer.teachers[0].state_dict().items(),
                         source.state_dict().values()):
        assert torch.equal(a, b), k
    for a, c in zip(trainer.teachers[1].state_dict().values(), seeded.state_dict().values()):
        assert torch.equal(a, c)


def test_cli_saves_and_resumes_on_smoke_data(tmp_path, monkeypatch, teacher_name):
    """``cli.train --checkpoint_interval 1`` writes the periodic and final
    files and the train state; ``--resume`` continues at step 2 and runs to
    ``--num_iterations 4`` (the tiny model as student and teacher)."""
    monkeypatch.chdir(ROOT)  # the smoke CSV names its images relative to the repository
    out = tmp_path / "run"
    args = ["--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(out),
            "--student_arch", teacher_name, "--teacher_models", teacher_name,
            "--batch_size", "2", "--image_size", "56", "--teacher_dtype", "float32",
            "--log_interval", "1"]
    train_cli.main([*args, "--num_iterations", "2", "--checkpoint_interval", "1"])
    names = {p.name for p in out.iterdir()}
    assert {"student_checkpoint_1.safetensors", "student_checkpoint_2.safetensors",
            "student_final.safetensors", "train_state"} <= names
    assert int(ckpt.restore_train_state(str(out))["step"]) == 2
    history = train_cli.main([*args, "--num_iterations", "4", "--resume", str(out)])
    assert len(history["lr"]) == 2  # steps 3 and 4
    assert int(ckpt.restore_train_state(str(out))["step"]) == 4
    assert np.isfinite(history["train_loss"]).all()
