"""Student remat (``TrainConfig.student_remat``, ``create_model(remat=True)``)
on the CPU, one torch thread.

- The step with and without remat, from the same weights and batch, for
  the plain student, the windowed student (the biased attention, and the
  banded one with the port's threshold lowered) and a LoRA + SSF student:
  equal loss components, gradient norm and gradients, bit for bit (the
  recompute runs the same operations in the same order on the CPU).
- Remat recomputes the blocks: the attention runs twice a block in the
  step with it, once without.
- The port's remat step against the JAX package's ``student_remat=True``
  step (``create_model(remat=True)``) on the same weights, at the limits
  of ``tests/test_torch_train.py``.
- ``Trainer`` builds its student with the config's ``student_remat``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.configs import OptimizerConfig as JOptimizerConfig
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.train.state import create_train_state as jax_create_train_state
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models import vit
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.train.loop import Trainer
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

from test_torch_train import GRAD_NORM_RTOL, LOSS_RTOL

OPT = dict(lr=1e-4, weight_decay=1e-5, warmup_steps=0, schedule="none", total_steps=10,
           max_grad_norm=1.0)
# student kind -> (image size, encoder overrides)
STUDENTS = {
    "plain": (56, dict()),
    "window": (126, dict(window_size=3)),
    "window_banded": (126, dict(window_size=3)),
    "lora_ssf": (56, dict(lora_rank=4, use_ssf=True)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(models, kind: str):
    preset = "depthanything-base-window" if kind.startswith("window") else "depthanything-base"
    cfg = models[preset]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64 if kind.startswith("window") else 128,
                              depth=2, num_heads=1 if kind.startswith("window") else 2,
                              out_indices=(0, 1, 1, 1), **STUDENTS[kind][1])
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


def _teacher():
    return create_model(_cfg(MODELS, "plain"), device="cpu", seed=1).requires_grad_(False)


def _step(kind: str, remat: bool, x: torch.Tensor):
    student = create_model(_cfg(MODELS, kind), device="cpu", seed=0, fused_tail=False,
                           remat=remat)
    state = create_train_state(student, OptimizerConfig(**OPT))
    step = make_train_step(student, [_teacher()], LossConfig(), views_shared=True)
    metrics = step(state, 0, x, x)
    grads = [p.grad.clone() for p in student.parameters()]
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("kind", list(STUDENTS))
def test_remat_step_equals_plain_step(monkeypatch, kind):
    if kind == "window_banded":
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    size = STUDENTS[kind][0]
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, size, size).astype(np.float32))
    calls = []
    real = vit.multi_head_attention_packed
    monkeypatch.setattr(vit, "multi_head_attention_packed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    plain_metrics, plain_grads = _step(kind, False, x)
    plain_calls, calls[:] = len(calls), []
    remat_metrics, remat_grads = _step(kind, True, x)
    # student forward + teacher forward; remat adds the student's recompute
    assert len(calls) == plain_calls + 2, (plain_calls, len(calls))
    assert remat_metrics == plain_metrics
    assert len(remat_grads) == len(plain_grads)
    for a, b in zip(remat_grads, plain_grads):
        assert torch.equal(a, b)


def test_remat_step_matches_jax():
    """One shared-view step of the remat student on both sides, from the
    same weights: loss components and gradient norm at
    ``tests/test_torch_train.py``'s limits."""
    size = 56
    jcfg_s, jcfg_t = _cfg(JAX_MODELS, "plain"), _cfg(JAX_MODELS, "plain")
    jstudent = jax_create_model(jcfg_s, attn_impl="reference", remat=True)
    jteacher = jax_create_model(jcfg_t, attn_impl="reference")
    zeros = jnp.zeros((1, size, size, 3))
    sp = jax.tree_util.tree_map(np.asarray, jax.jit(jstudent.init)(jax.random.PRNGKey(0),
                                                                    zeros)["params"])
    tp = jax.tree_util.tree_map(np.asarray, jax.jit(jteacher.init)(jax.random.PRNGKey(1),
                                                                    zeros)["params"])
    student = create_model(_cfg(MODELS, "plain"), device="cpu", fused_tail=False, remat=True)
    student.load_state_dict(params_from_jax(sp, _cfg(MODELS, "plain")), strict=True)
    teacher = create_model(_cfg(MODELS, "plain"), device="cpu")
    teacher.load_state_dict(params_from_jax(tp, _cfg(MODELS, "plain")), strict=True)
    teacher.requires_grad_(False)
    loss = dict(normalization="global")
    state_j, tx = jax_create_train_state(sp, JOptimizerConfig(**OPT))
    step_j = jax_make_train_step(lambda p, x: jstudent.apply({"params": p}, x),
                                 [lambda p, x: jteacher.apply({"params": p}, x)], tx,
                                 JLossConfig(**loss), seed=0, views_shared=True)
    step_t = make_train_step(student, [teacher], LossConfig(**loss), views_shared=True)
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    _, mj = step_j(state_j, (tp,), jnp.asarray(x), jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mt = step_t(create_train_state(student, OptimizerConfig(**OPT)), 0, xt, xt)
    for key in ("sc", "lg", "feat", "grad", "hdn", "total"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)


def test_trainer_builds_remat_student(tmp_path):
    cfg = TrainConfig(student=MODELS["depthanything-small"], teachers=("depthanything-small",),
                      student_remat=True, teacher_fused_tail="off", attn_impl="reference",
                      output_dir=str(tmp_path), teacher_dtype="float32",
                      student_compute_dtype="float32")
    trainer = Trainer(cfg, "cpu")
    assert trainer.student.pretrained.remat
    assert not trainer.teachers[0].pretrained.remat
    assert not trainer.teachers[0].depth_head.fused_tail
    assert {b.attn.attn_impl for m in (trainer.student, trainer.teachers[0])
            for b in m.pretrained.blocks} == {"reference"}
