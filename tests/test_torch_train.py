"""The port's distillation step, optimizer and training CLI on the CPU.

- A 3-step trajectory of the port's train step against the JAX
  ``make_train_step`` on a tiny ViT student/teacher pair with the same
  weights (``params_from_jax``) and batches, in fp32. The teacher is wider
  than the student (its features are nearest-resized) and carries the
  ViT-L head's flags. The limits are about 3x the readings, far inside
  those that the JAX package's ``tests/test_train_parity.py`` allows a
  trajectory held against another framework (loss components rtol up to
  5e-2, final parameters within a mean distance of 2 * lr * steps), and
  every step must move the parameters by about its learning rate (see
  ``test_train_trajectory_matches_jax``).
- The optimizer (clip, guard, L2 decay, Adam, schedule) against optax on
  a gradient sequence with a non-finite step.
- The same trajectory with an int8 teacher (``teacher_quant="int8"``)
  against the JAX step with ``create_model(quant="int8")``, and the
  teacher-free loss components of an int8-teacher step equal to those of
  the unquantized-teacher step.
- The teacher draws of a ``Trainer`` with two teachers: a train step's
  draw depends only on ``(seed, step)`` and a validation batch's only on
  ``(seed + 1, batch index)``, as the JAX step's ``fold_in`` keys.
- ``cli.train`` over ``data/smoke`` for 2 steps, with the ViT-B and the
  windowed student and with ``--teacher_quant int8_pallas``, and its
  refusal of the flags of features not ported yet.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.configs import OptimizerConfig as JOptimizerConfig
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.train.state import create_train_state as jax_create_train_state
from distill_any_depth_tpu.train.state import make_lr_schedule as jax_make_lr_schedule
from distill_any_depth_tpu.train.state import make_optimizer as jax_make_optimizer
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu_torch.cli import train as train_cli
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.train.state import (
    apply_gradients,
    create_train_state,
    make_lr_schedule,
)
from distill_any_depth_tpu_torch.train.loop import Trainer
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, STEPS, LR = 56, 4, 3, 1e-4
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_MEAN_DIST = 6e-5, 1e-4, 2e-8


def _tiny(models, role: str):
    cfg = models["depthanything-base"]
    dim, heads = (128, 2) if role == "student" else (192, 3)
    enc = dataclasses.replace(cfg.encoder, embed_dim=dim, depth=3, num_heads=heads,
                              out_indices=(0, 1, 2, 2))
    extra = {} if role == "student" else dict(trailing_head_relu=False, interp_to_input=True)
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64),
                               **extra)


def _pair(role: str, seed: int, quant: str = "none"):
    jcfg, tcfg = _tiny(JAX_MODELS, role), _tiny(MODELS, role)
    jmodel = jax_create_model(jcfg, attn_impl="reference", quant=quant)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    model = create_model(tcfg, device="cpu", fused_tail=False, quant=quant)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, model


def _flat(params: dict, cfg) -> np.ndarray:
    sd = params_from_jax(params, cfg)
    return np.concatenate([sd[k].numpy().ravel() for k in sorted(sd)])


def _student_flat(student) -> np.ndarray:
    sd = {k: v.detach().numpy().ravel() for k, v in student.state_dict().items()}
    return np.concatenate([sd[k] for k in sorted(sd)])


@pytest.mark.parametrize("views_shared", [True, False], ids=["shared_views", "two_views"])
def test_train_trajectory_matches_jax(views_shared):
    """Each step against the JAX step: the loss components, the gradient
    norm, and the parameters after the last update. The JAX package's
    cross-framework limits are far looser than the readings here, so the
    limits are about 3x the readings (largest over the steps and both
    cases): loss components 1.8e-5 relative (limit 6e-5), gradient norm
    3.4e-5 relative (1e-4), final parameters 5.1e-9 mean distance (2e-8).
    So that a port that applies no update fails, each step must also move
    the parameters by about its learning rate: Adam moves an element by
    up to about lr, and the mean move read 0.64-0.80 lr; the limits are
    0.2 lr and lr (and no move at step 0, whose warmup lr is 0)."""
    _trajectory(views_shared, "none", LOSS_RTOL, GRAD_NORM_RTOL, PARAM_MEAN_DIST)


def _trajectory(views_shared: bool, teacher_quant: str, loss_rtol: float, grad_norm_rtol: float,
                param_mean_dist: float) -> None:
    """``test_train_trajectory_matches_jax``'s steps with the teacher built
    with ``teacher_quant`` on both sides."""
    jstudent, sp, student = _pair("student", 0)
    jteacher, tp, teacher = _pair("teacher", 1, teacher_quant)
    teacher.requires_grad_(False)
    opt = dict(lr=LR, weight_decay=1e-5, warmup_steps=1, schedule="cosine", total_steps=10,
               max_grad_norm=1.0)
    schedule = make_lr_schedule(OptimizerConfig(**opt))
    # global normalization: the hybrid one divides by near-zero segment MADs
    # at random init and amplifies fp-level differences chaotically (the JAX
    # package's trajectory test makes the same choice)
    loss = dict(normalization="global")
    chunk = 2 if views_shared else 0

    state_j, tx = jax_create_train_state(sp, JOptimizerConfig(**opt))
    step_j = jax_make_train_step(
        lambda p, x: jstudent.apply({"params": p}, x),
        [lambda p, x: jteacher.apply({"params": p}, x)],
        tx, JLossConfig(**loss), seed=0, views_shared=views_shared, teacher_chunk=chunk)
    state_t = create_train_state(student, OptimizerConfig(**opt))
    step_t = make_train_step(student, [teacher], LossConfig(**loss), views_shared=views_shared,
                             teacher_chunk=chunk)

    rng = np.random.RandomState(0)
    before = _student_flat(student)
    for i in range(STEPS):
        xg, xl = (rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32) for _ in range(2))
        if views_shared:
            xg = xl
        state_j, mj = step_j(state_j, (tp,), jnp.asarray(xg), jnp.asarray(xl))
        mt = step_t(state_t, 0, *(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (xg, xl)))
        if not views_shared:
            assert float(mj["lg"]) > 1e-3  # a non-vacuous LG component
        for key in ("sc", "lg", "feat", "grad", "hdn", "total"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=loss_rtol,
                                       atol=1e-7, err_msg=f"step {i} loss {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                                   rtol=grad_norm_rtol, err_msg=f"step {i} gradient norm")
        after = _student_flat(student)
        lr, moved = float(schedule(i)), np.mean(np.abs(after - before))
        assert (moved == 0.0) if lr == 0 else (0.2 * lr < moved < lr), (i, lr, moved)
        before = after
    theirs = _flat(jax.tree_util.tree_map(np.asarray, state_j.params), _tiny(MODELS, "student"))
    assert np.mean(np.abs(before - theirs)) < param_mean_dist
    assert int(state_t.step) == STEPS and int(state_t.applied) == STEPS


def test_int8_teacher_trajectory_matches_jax():
    """The 3-step trajectory with an int8 teacher on both sides (shared
    views, the teacher in chunks of 2). The teacher's activations differ
    by an ulp between the frameworks as in the unquantized trajectory, and
    about 1 in 10^5 of its int8 values then sits on the other side of a
    round-half-even tie: each such flip moves a GEMM output by one scale
    step, and the teacher's features (about 1.3e-2 apart at step 2) and the
    teacher-fed losses follow. Readings: loss components 1.5e-4 relative
    (feat, step 2), gradient norm 1.3e-5, final parameters 2.5e-8 mean
    distance; the limits are about 3x those."""
    _trajectory(True, "int8", 5e-4, 5e-5, 8e-8)


def test_int8_teacher_leaves_teacher_free_components():
    """As ``tests/test_quant.py``: an int8-teacher step against an
    unquantized-teacher step from the same student and batch. The
    teacher-free components (lg, grad) are equal; the others move by less
    than the JAX package's documented 2% pseudo-label shift."""
    _, _, teacher = _pair("teacher", 1)
    _, _, qteacher = _pair("teacher", 1, "int8")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, SIZE, SIZE).astype(np.float32))
    metrics = []
    for t in (qteacher, teacher):
        _, _, student = _pair("student", 0)
        state = create_train_state(student, OptimizerConfig(lr=1e-4, warmup_steps=0,
                                                            schedule="none", total_steps=10))
        step = make_train_step(student, [t.requires_grad_(False)],
                               LossConfig(use_hdn=True, hdn_variant="dr"))
        metrics.append({k: float(v) for k, v in step(state, 0, x, x).items()})
    quant, plain = metrics
    assert np.isfinite(quant["total"])
    for key in ("total", "sc", "hdn", "feat"):
        assert abs(quant[key] - plain[key]) / (abs(plain[key]) + 1e-9) < 0.02, key
    for key in ("lg", "grad"):
        assert quant[key] == plain[key], key


@pytest.mark.parametrize("schedule,warmup", [("cosine", 0), ("cosine", 2), ("step", 0),
                                             ("none", 1)])
def test_optimizer_matches_optax(schedule, warmup):
    """Clip from one norm, skip a non-finite step (moments, Adam's count and
    the schedule stay put), L2 decay before Adam, and the schedule."""
    cfg = dict(lr=1e-2, weight_decay=1e-3, warmup_steps=warmup, schedule=schedule,
               total_steps=6, step_size=2, gamma=0.5, max_grad_norm=1.0)
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (0.3, 3.0, 1.0, 0.5, 2.0)]
    grads[2]["a"][0, 0] = np.nan

    tx = jax_make_optimizer(JOptimizerConfig(**cfg))
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()})
    state = create_train_state(module, OptimizerConfig(**cfg))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        for k, p in module.items():
            p.grad = torch.tensor(g[k])
        norm = apply_gradients(state)
        np.testing.assert_allclose(float(norm), float(opt_state.last_norm), rtol=1e-6)
        assert int(state.notfinite_count) == int(opt_state.notfinite_count)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=2e-6,
                                       atol=1e-7)
    assert int(state.step) == 5 and int(state.applied) == 4

    jsched, tsched = jax_make_lr_schedule(JOptimizerConfig(**cfg)), make_lr_schedule(
        OptimizerConfig(**cfg))
    for count in range(12):
        np.testing.assert_allclose(float(tsched(count)), float(jsched(count)), rtol=1e-6)


def _recording_trainer(tmp_path, draws: dict) -> Trainer:
    """A ``Trainer`` with two ``depthanything-small`` teachers at 56^2 in
    fp32 whose steps append ``(step, teacher)`` to ``draws["train"]`` and
    whose validation batches append their teacher to ``draws["val"]``."""
    cfg = TrainConfig(student=MODELS["depthanything-small"],
                      teachers=("depthanything-small", "depthanything-small"), batch_size=2,
                      image_size=SIZE, num_epochs=2, seed=7, output_dir=str(tmp_path),
                      teacher_dtype="float32", student_compute_dtype="float32", teacher_chunk=0,
                      log_interval=100)
    trainer = Trainer(cfg, device="cpu")
    trainer._build_steps(views_shared=True)
    train_step, eval_loss = trainer.train_step, trainer.eval_loss

    def record_train(state, teacher_idx, g, l):
        draws["train"].append((int(state.step), teacher_idx))
        return train_step(state, teacher_idx, g, l)

    def record_val(teacher_idx, g, l):
        draws["val"].append(teacher_idx)
        return eval_loss(teacher_idx, g, l)

    trainer.train_step, trainer.eval_loss = record_train, record_val
    return trainer


def _fixed_batches() -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32)} for _ in range(4)]


def test_teacher_draws_depend_on_step_and_batch_alone(tmp_path):
    """F1: two validation passes give equal totals and equal draws; the
    train draws of steps 0-5 are the same with and without a validation
    pass between epochs (4 batches an epoch); a second ``Trainer`` whose
    step is set to 3 draws what the first drew at step 3."""
    batches = _fixed_batches()
    draws = {"train": [], "val": []}
    trainer = _recording_trainer(tmp_path / "a", draws)
    first, second = trainer.validate(batches), trainer.validate(batches)
    assert first == second and np.isfinite(first["total"])
    assert draws["val"][:4] == draws["val"][4:]
    assert set(draws["val"]) == {0, 1}  # the seed draws both teachers: not vacuous
    trainer.run(lambda epoch: batches, val_batches=lambda: batches, max_steps=6)
    with_val = draws["train"]
    assert [s for s, _ in with_val] == list(range(6)) and len(draws["val"]) == 12

    quiet = {"train": [], "val": []}
    _recording_trainer(tmp_path / "b", quiet).run(lambda epoch: batches, max_steps=6)
    assert quiet["train"] == with_val and not quiet["val"]
    assert {t for _, t in with_val} == {0, 1}

    late = {"train": [], "val": []}
    trainer = _recording_trainer(tmp_path / "c", late)
    trainer.state.step.fill_(3)
    trainer.run(lambda epoch: batches[:1], max_steps=4)
    assert late["train"] == [with_val[3]]


def test_cli_trains_on_smoke_data(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)  # the smoke CSV names its images relative to the repository
    out = tmp_path / "run"
    history = train_cli.main([
        "--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(out),
        "--student_arch", "depthanything-small", "--teacher_models", "depthanything-small",
        "--batch_size", "2", "--num_iterations", "2", "--image_size", "56", "--use_hdn_loss",
        "--teacher_dtype", "float32", "--log_interval", "1",
    ])
    saved = json.loads((out / "history.json").read_text())
    assert saved == history
    assert len(history["lr"]) == 2 and np.isfinite(history["train_loss"]).all()


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--profile_dir", "run"], ["--lora_rank", "4"],
                                  ["--data_mode", "images"], ["--visualize_interval", "10"],
                                  ["--device_preprocess"]],
                         ids=lambda f: f[0])
def test_cli_refuses_features_not_ported(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0]):
        train_cli.main(["--output_dir", str(tmp_path), *flag])


def test_cli_trains_with_int8_teacher_on_smoke_data(tmp_path, monkeypatch):
    """``--teacher_quant int8_pallas``: the teacher's encoder GEMMs through
    the W8A8 wrapper (its plain version on the CPU; kernel 9 on the card)."""
    monkeypatch.chdir(ROOT)
    history = train_cli.main([
        "--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(tmp_path),
        "--student_arch", "depthanything-small", "--teacher_models", "depthanything-small",
        "--batch_size", "2", "--num_iterations", "2", "--image_size", "56", "--use_hdn_loss",
        "--teacher_dtype", "float32", "--teacher_quant", "int8_pallas", "--log_interval", "1",
    ])
    assert len(history["lr"]) == 2 and np.isfinite(history["train_loss"]).all()


def test_cli_trains_windowed_student_on_smoke_data(tmp_path, monkeypatch):
    """The windowed student trains through the CLI (on the CPU, through the
    plain attention; on the card, kernels 5 and 6 at this size)."""
    monkeypatch.chdir(ROOT)
    history = train_cli.main([
        "--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(tmp_path),
        "--student_arch", "depthanything-base-window", "--teacher_models", "depthanything-small",
        "--image_size", "126", "--batch_size", "2", "--num_iterations", "2",
    ])
    assert len(history["lr"]) == 1 and np.isfinite(history["train_loss"]).all()


def test_student_plain_tail_and_teacher_kernel_tail():
    """The student runs the plain DPT tail (its weights train), a teacher
    the tail kernel's wrapper, whose plain version on the CPU gives the
    same depth."""
    _, _, student = _pair("student", 0)
    fused = create_model(_tiny(MODELS, "student"), device="cpu", fused_tail=True)
    fused.load_state_dict(student.state_dict())
    assert not student.depth_head.fused_tail and fused.depth_head.fused_tail
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(student(x)[0].numpy(), fused(x)[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
