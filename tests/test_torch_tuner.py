"""The port's loss-weight tuner (``train/tuner``) and the step's
``loss_weights`` on the CPU, one torch thread.

- ``generate_experiment_configs`` gives the JAX function's configurations,
  in its order.
- ``tune_loss_weights`` ranks by the last validation loss, and a run that
  raises or ends in NaN ranks last (``tests/test_utils.py``), with the
  report written.
- ``tune_loss_weights_traced`` on a tiny pair: sorted finite scores, the
  report, and an experiment's train losses equal to a ``Trainer`` whose
  ``LossConfig`` carries the same lambdas (rtol 1e-6, the JAX test's).
- The step with ``loss_weights`` against the same step with the lambdas in
  its ``LossConfig`` (bit for bit), and against the JAX step with
  ``loss_weights`` on the same weights at ``tests/test_torch_train.py``'s
  limits.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import TrainConfig as JTrainConfig
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.configs import OptimizerConfig as JOptimizerConfig
from distill_any_depth_tpu.train import tuner as jax_tuner
from distill_any_depth_tpu.train.state import create_train_state as jax_create_train_state
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu_torch import configs
from distill_any_depth_tpu_torch.configs import LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.train import tuner
from distill_any_depth_tpu_torch.train.loop import Trainer
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step

from test_torch_train import GRAD_NORM_RTOL, LOSS_RTOL, _pair, _tiny

SIZE = 56
WEIGHTS = {"sc": 0.25, "lg": 0.75, "feat": 0.5, "grad": 0.1, "hdn": 0.4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("grid,limit", [(None, None), ({"lambda_sc": (0.1, 0.9),
                                                       "lambda_grad": (0.3, 0.2, 0.1)}, 4)],
                         ids=["default", "custom"])
def test_generate_experiment_configs_matches_jax(grid, limit):
    ours = tuner.generate_experiment_configs(TrainConfig(), grid, limit)
    theirs = jax_tuner.generate_experiment_configs(JTrainConfig(), grid, limit)
    assert len(ours) == len(theirs) == (48 if grid is None else 4)
    assert [dataclasses.asdict(c.loss) for c in ours] == [dataclasses.asdict(c.loss)
                                                          for c in theirs]


@pytest.mark.parametrize("bad", ["raises", "nan"])
def test_tune_loss_weights_ranks_failures_last(tmp_path, bad):
    grid = {"lambda_sc": (0.1, 0.5, 0.9)}

    def run(cfg):
        if cfg.loss.lambda_sc == 0.1:  # the best score, were it not broken
            if bad == "raises":
                raise RuntimeError("diverged")
            return {"val_loss": [float("nan")]}
        return {"val_loss": [9.0, cfg.loss.lambda_sc]}

    results = tuner.tune_loss_weights(TrainConfig(output_dir=str(tmp_path)), run, grid=grid)
    assert [r["lambdas"]["lambda_sc"] for r in results] == [0.5, 0.9, 0.1]
    assert results[-1]["score"] == math.inf
    assert ("error" in results[-1]) == (bad == "raises")
    saved = json.loads((tmp_path / "tuning_results.json").read_text())
    assert [r["experiment"] for r in saved] == [1, 2, 0]


def _sweep_cfg(tmp_path):
    tiny = _tiny_cfg()
    return TrainConfig(student=tiny, teachers=("tiny-tuner-teacher",),
                       loss=LossConfig(use_hdn=True, hdn_variant="dr", hdn_level=2),
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=0, schedule="none",
                                                 total_steps=50),
                       batch_size=2, image_size=SIZE, seed=0, teacher_chunk=0,
                       student_compute_dtype="float32", teacher_dtype="float32",
                       output_dir=str(tmp_path))


def _tiny_cfg():
    cfg = configs.MODELS["depthanything-small"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 1, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


def _batches():
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32)} for _ in range(2)]


def test_traced_sweep_ranks_and_equals_baked(tmp_path, monkeypatch):
    monkeypatch.setitem(configs.MODELS, "tiny-tuner-teacher", _tiny_cfg())
    base = _sweep_cfg(tmp_path)
    batches = _batches()
    grid = {"lambda_sc": (1.0, 0.25), "lambda_hdn": (0.4,)}
    results = tuner.tune_loss_weights_traced(base, batches, batches[:1], grid=grid,
                                             steps_per_experiment=2, device="cpu")
    assert len(results) == 2
    assert results[0]["score"] <= results[1]["score"]
    assert all(np.isfinite(r["score"]) for r in results)
    assert all(len(r["history"]["train_loss"]) == 2 and len(r["history"]["val_loss"]) == 1
               for r in results)
    assert (tmp_path / "tuning_results.json").exists()

    # the experiment with lambda_sc = 0.25 against a Trainer with it baked in
    traced = next(r for r in results if r["lambdas"]["lambda_sc"] == 0.25)
    baked_cfg = dataclasses.replace(base, loss=dataclasses.replace(base.loss, lambda_sc=0.25,
                                                                   lambda_hdn=0.4))
    trainer = Trainer(baked_cfg, "cpu")
    totals = []
    trainer.run(lambda epoch: batches, max_steps=2,
                on_step=lambda step, m: totals.append(float(m["total"])))
    np.testing.assert_allclose(traced["history"]["train_loss"], totals, rtol=1e-6)
    val = trainer.validate(batches[:1])
    np.testing.assert_allclose(traced["history"]["val_loss"], [val["total"]], rtol=1e-6)


def _port_step(weights, loss_cfg, x, student=None, teacher=None):
    """One shared-view step of the tiny pair (seeded port weights unless
    given)."""
    if student is None:
        student = create_model(_tiny(configs.MODELS, "student"), device="cpu", seed=0,
                               fused_tail=False)
        teacher = create_model(_tiny(configs.MODELS, "teacher"), device="cpu", seed=1)
    state = create_train_state(student, OptimizerConfig(lr=1e-4, warmup_steps=0,
                                                        schedule="none", total_steps=10))
    step = make_train_step(student, [teacher.requires_grad_(False)], loss_cfg,
                           views_shared=True)
    return step(state, 0, x, x, loss_weights=weights)


def test_step_loss_weights_equal_baked_lambdas():
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, SIZE, SIZE).astype(np.float32))
    traced = _port_step(WEIGHTS, LossConfig(), x)
    baked = _port_step(None, LossConfig(lambda_sc=0.25, lambda_lg=0.75, lambda_feat=0.5,
                                        lambda_grad=0.1, lambda_hdn=0.4), x)
    assert {k: float(v) for k, v in traced.items()} == {k: float(v) for k, v in baked.items()}


def test_step_loss_weights_match_jax():
    """One shared-view step with the same ``loss_weights`` on both sides
    (the JAX step's as traced fp32 scalars), from the same weights."""
    jstudent, sp, student = _pair("student", 0)
    jteacher, tp, teacher = _pair("teacher", 1)
    opt = dict(lr=1e-4, warmup_steps=0, schedule="none", total_steps=10)
    loss = dict(normalization="global")
    state_j, tx = jax_create_train_state(sp, JOptimizerConfig(**opt))
    step_j = jax_make_train_step(lambda p, x: jstudent.apply({"params": p}, x),
                                 [lambda p, x: jteacher.apply({"params": p}, x)], tx,
                                 JLossConfig(**loss), seed=0, views_shared=True)
    x = np.random.RandomState(3).rand(2, SIZE, SIZE, 3).astype(np.float32)
    _, mj = step_j(state_j, (tp,), jnp.asarray(x), jnp.asarray(x),
                   loss_weights={k: jnp.float32(v) for k, v in WEIGHTS.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mt = _port_step(WEIGHTS, LossConfig(**loss), xt, student, teacher)
    for key in ("sc", "lg", "feat", "grad", "hdn", "total"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    # the weights moved the total: not the default lambdas'
    default = sum(getattr(LossConfig(), f"lambda_{k}") * float(mt[k]) for k in WEIGHTS)
    assert abs(default - float(mt["total"])) > 1e-3 * abs(float(mt["total"]))
