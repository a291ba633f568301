"""The port's LoRA/SSF adapters and adapter-only training against the JAX
package, in fp32 on the CPU.

- ``LoRALinear`` and ``SSF`` against JAX ``LoRADense`` and ``ssf`` on the
  same weights, with a non-zero B (at init B is 0 and the update vanishes).
- A tiny ViT with ``lora_rank=4, use_ssf=True`` against JAX through
  ``params_from_jax`` (the JAX init perturbed so that B and SSF are not the
  identity), at ``tests/test_torch_model.py``'s tolerance; at init, the
  same model gives the plain model's output.
- A 3-step adapter-only trajectory against the JAX step with the JAX
  Trainer's ``optax.multi_transform`` (Adam on the adapters,
  ``set_to_zero`` elsewhere): loss components, the gradient norm (the
  global norm of every gradient, frozen ones included, as the JAX step
  reports it) and the adapters within ``tests/test_torch_train.py``'s
  limits; the frozen parameters equal to their initial values bit for bit.
- Adapter files: a file the port writes equals JAX ``params_to_torch`` key
  for key and bit for bit; a file the JAX package writes loads into the
  port, whose forward then equals the forward of the weights it came from.
- The ``Trainer``: a student without adapters raises; adapter-only steps
  leave the frozen parameters bit-equal and move every adapter; the saved
  ``student_final`` gives the trained model's forward bit for bit (the
  contract of the JAX package's ``test_trainer_adapter_only_finetuning``);
  a resume is exact; ``cli.train`` takes the adapter flags.
"""
import dataclasses
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
from distill_any_depth_tpu.models.adapters import LoRADense, adapter_label_tree, ssf
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.train.state import TrainState as JTrainState
from distill_any_depth_tpu.train.state import make_optimizer as jax_make_optimizer
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu.utils import checkpoint as jax_ckpt
from distill_any_depth_tpu.utils.torch_interop import params_to_torch
from distill_any_depth_tpu_torch.cli import train as train_cli
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models.adapters import (
    SSF,
    LoRALinear,
    adapter_parameters,
    is_adapter_name,
)
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.train.loop import Trainer
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils import checkpoint as ckpt
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

from test_torch_train import GRAD_NORM_RTOL, LOSS_RTOL, PARAM_MEAN_DIST

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, STEPS, LR, RANK = 56, 4, 3, 1e-4, 4
TOL = 2e-5  # tests/test_torch_model.py: |err| <= TOL * (1 + |ref|)
STUDENT, TEACHER = "tiny-adapter-student", "tiny-adapter-teacher"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(models, role: str, lora_rank: int = RANK, use_ssf: bool = True):
    cfg = models["depthanything-base"]
    dim, heads = (128, 2) if role == "student" else (192, 3)
    enc = dataclasses.replace(cfg.encoder, embed_dim=dim, depth=3, num_heads=heads,
                              out_indices=(0, 1, 2, 2))
    extra = {} if role == "student" else dict(trailing_head_relu=False, interp_to_input=True)
    if role == "student":
        enc = dataclasses.replace(enc, lora_rank=lora_rank, use_ssf=use_ssf)
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64),
                               **extra)


@pytest.fixture(scope="module")
def presets():
    """The tiny student (LoRA + SSF) and teacher as presets of the port."""
    MODELS[STUDENT], MODELS[TEACHER] = _tiny(MODELS, "student"), _tiny(MODELS, "teacher")
    yield STUDENT, TEACHER
    del MODELS[STUDENT], MODELS[TEACHER]


def _perturb(params, seed: int) -> dict:
    """The JAX init with every LoRA B and SSF parameter drawn at random (at
    init they leave the model as it is)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "lora_b":
                out[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
            elif any(str(p).startswith("ssf_") for p in path):
                out[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(params)


def _pair(role: str, seed: int, perturb: bool = True):
    """A JAX model and its params, and the port's model with the same
    weights (loaded through ``utils/checkpoint.load_state_dict``)."""
    jcfg, tcfg = _tiny(JAX_MODELS, role), _tiny(MODELS, role)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    if perturb and role == "student":
        params = _perturb(params, seed)
    model = create_model(tcfg, device="cpu", fused_tail=False)
    ckpt.load_state_dict(model, params_from_jax(params, tcfg))
    return jmodel, params, model


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(np.float32)


@pytest.mark.parametrize("rank", [1, 4, 8])
def test_lora_linear_and_ssf_match_jax(rank):
    rng = np.random.RandomState(rank)
    din, dout = 48, 80
    x = rng.randn(2, 7, din).astype(np.float32)
    p = {"kernel": rng.randn(din, dout).astype(np.float32) * 0.1,
         "bias": rng.randn(dout).astype(np.float32),
         "lora_a": rng.randn(din, rank).astype(np.float32) / rank,
         "lora_b": rng.randn(rank, dout).astype(np.float32)}
    want = np.asarray(LoRADense(dout, rank).apply({"params": p}, jnp.asarray(x)))
    lin = LoRALinear(din, dout, rank)
    with torch.no_grad():
        for name, v in (("weight", p["kernel"].T), ("bias", p["bias"]),
                        ("lora_A", p["lora_a"].T), ("lora_B", p["lora_b"].T)):
            getattr(lin, name).copy_(torch.from_numpy(np.ascontiguousarray(v)))
        got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want - x @ p["kernel"] - p["bias"]).max() > 0.1  # the update is not vacuous

    s = {"gamma": rng.randn(dout).astype(np.float32), "beta": rng.randn(dout).astype(np.float32)}
    y = rng.randn(3, dout).astype(np.float32)
    want = np.asarray(ssf().apply({"params": s}, jnp.asarray(y)))
    layer = SSF(dout)
    with torch.no_grad():
        layer.gamma.copy_(torch.from_numpy(s["gamma"]))
        layer.beta.copy_(torch.from_numpy(s["beta"]))
        np.testing.assert_array_equal(layer(torch.from_numpy(y)).numpy(), want)


def test_adapter_names_and_init():
    """The adapter parameters are LoRA's A and B and every SSF parameter
    (JAX ``adapter_label_tree``'s "adapter" leaves, in number); at init A
    has standard deviation 1/r, B and SSF are the identity, and the model
    gives the plain model's output on the same base weights."""
    _, params, _ = _pair("student", 0, perturb=False)
    labels = jax.tree_util.tree_leaves(adapter_label_tree(params))
    model = create_model(_tiny(MODELS, "student"), device="cpu", seed=3, fused_tail=False)
    names = [n for n, _ in model.named_parameters() if is_adapter_name(n)]
    assert len(names) == labels.count("adapter") == 3 * (2 * 2 + 4 * 2)
    assert len(adapter_parameters(model)) == len(names)
    a = torch.cat([m.lora_A.reshape(-1) for m in model.modules() if isinstance(m, LoRALinear)])
    assert abs(a.std().item() * RANK - 1.0) < 0.05
    plain = create_model(_tiny(MODELS, "student", lora_rank=0, use_ssf=False), device="cpu",
                         seed=None, fused_tail=False)
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not is_adapter_name(k)}, strict=True)
    x = torch.from_numpy(_images(2, 1)).permute(0, 3, 1, 2)
    with torch.no_grad():
        for a_out, b_out in zip(model(x), plain(x)):
            torch.testing.assert_close(a_out, b_out, rtol=0, atol=0)


def test_adapter_vit_matches_jax():
    """Depth and features of the tiny LoRA + SSF model against JAX."""
    jmodel, params, model = _pair("student", 0)
    x = _images(2, 2)
    jd, jf = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        d, f = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((d.numpy(), np.asarray(jd)), (f.numpy(), np.asarray(jf))):
        assert (np.abs(got - want) <= TOL * (1 + np.abs(want))).all()
    # not the plain model: the perturbed adapters move the depth
    _, plain_params, _ = _pair("student", 0, perturb=False)
    plain = np.asarray(jmodel.apply({"params": plain_params}, jnp.asarray(x))[0])
    assert np.abs(plain - np.asarray(jd)).max() > 1e-3


def _flat_adapters(model) -> np.ndarray:
    return np.concatenate([p.detach().numpy().ravel() for p in adapter_parameters(model)])


def _frozen(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if not is_adapter_name(n)}


def test_adapter_only_trajectory_matches_jax():
    """Three adapter-only steps (shared views, the teacher in chunks of 2)
    against the JAX step with the JAX Trainer's ``multi_transform``. The
    adapters are held at ``tests/test_torch_train.py``'s limits (loss
    components, gradient norm, mean distance of the parameters); the frozen
    parameters never move; every step moves the adapters."""
    jstudent, sp, student = _pair("student", 0)
    jteacher, tp, teacher = _pair("teacher", 1)
    teacher.requires_grad_(False)
    opt = dict(lr=LR, weight_decay=1e-5, warmup_steps=1, schedule="cosine", total_steps=10,
               max_grad_norm=1.0)
    # no order statistic: a median puts its whole derivative on the pixel it
    # selects, and this student's depth has pixels 3e-7 apart at the median,
    # whose order an ulp of difference between the frameworks flips (the
    # global normalization moved 17% of the gradient so)
    loss = dict(normalization="none", use_hdn=False)

    labels = adapter_label_tree(sp)
    tx = optax.multi_transform({"adapter": jax_make_optimizer(JOptimizerConfig(**opt)),
                                "frozen": optax.set_to_zero()}, labels)
    state_j = JTrainState(step=jnp.zeros((), jnp.int32), params=sp, opt_state=tx.init(sp))
    step_j = jax_make_train_step(
        lambda p, x: jstudent.apply({"params": p}, x),
        [lambda p, x: jteacher.apply({"params": p}, x)],
        tx, JLossConfig(**loss), seed=0, views_shared=True, teacher_chunk=2)
    state_t = create_train_state(student, OptimizerConfig(**opt), adapter_only=True)
    assert len(state_t.params) == len(list(student.parameters()))
    assert len(state_t.trained) == len(adapter_parameters(student))
    step_t = make_train_step(student, [teacher], LossConfig(**loss), views_shared=True,
                             teacher_chunk=2)

    frozen = _frozen(student)
    rng = np.random.RandomState(0)
    before = _flat_adapters(student)
    for i in range(STEPS):
        x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        state_j, mj = step_j(state_j, (tp,), jnp.asarray(x), jnp.asarray(x))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        mt = step_t(state_t, 0, xt, xt)
        for key in ("sc", "lg", "feat", "grad", "total"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {i} loss {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL, err_msg=f"step {i} gradient norm")
        # the reported norm is every gradient's: above the adapters' own
        assert float(mt["grad_norm"]) > float(state_t.last_norm) * 1.01
        after = _flat_adapters(student)
        assert (np.all(after == before) if i == 0 else np.any(after != before)), i
        before = after
    for name, p in student.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params),
                            _tiny(MODELS, "student"))
    ref = create_model(_tiny(MODELS, "student"), device="cpu", seed=None, fused_tail=False)
    ckpt.load_state_dict(ref, jflat)
    assert np.mean(np.abs(before - _flat_adapters(ref))) < PARAM_MEAN_DIST
    for name, p in ref.named_parameters():
        if name in frozen:  # JAX's frozen leaves stayed put too
            assert torch.equal(p.detach(), frozen[name]), name


def test_adapter_files_match_jax(tmp_path):
    """The port's file equals JAX ``params_to_torch`` (LoRA under the
    reference's ``lora_A``/``lora_B`` with B times 8, SSF under
    ``adapters.``); a JAX-written file loads into the port with the same
    forward."""
    jmodel, params, model = _pair("student", 0)
    path = tmp_path / "port.safetensors"
    ckpt.save_safetensors(str(path), model)
    got = ckpt.read_safetensors(str(path))
    want = params_to_torch(params, _tiny(JAX_MODELS, "student"))
    assert sorted(got) == sorted(want)
    assert any(k.endswith(".lora_B") for k in want) and any(k.startswith("adapters.")
                                                             for k in want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape, k
        assert np.array_equal(got[k].numpy().view(np.uint32), v.view(np.uint32)), k

    jax_path = tmp_path / "jax.safetensors"
    jax_ckpt.save_safetensors(str(jax_path), params, _tiny(JAX_MODELS, "student"))
    loaded = create_model(_tiny(MODELS, "student"), device="cpu", seed=None, fused_tail=False)
    ckpt.load_state_dict_file(loaded, str(jax_path))
    for (name, a), b in zip(loaded.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.fixture
def adapter_cfg(presets, tmp_path):
    def make(out: str, **kw) -> TrainConfig:
        base = dict(student=MODELS[STUDENT], teachers=(TEACHER,), batch_size=2, image_size=SIZE,
                    num_epochs=1, seed=3, output_dir=str(tmp_path / out), teacher_chunk=0,
                    student_compute_dtype="float32", teacher_dtype="float32",
                    checkpoint_interval=0, log_interval=100, visualize_interval=0,
                    adapter_only=True, loss=LossConfig(use_hdn=False),
                    optimizer=OptimizerConfig(lr=1e-2, total_steps=4, warmup_steps=0,
                                              schedule="none"))
        return TrainConfig(**{**base, **kw})
    return make


def test_adapter_only_without_adapters_raises(adapter_cfg):
    plain = _tiny(MODELS, "student", lora_rank=0, use_ssf=False)
    with pytest.raises(ValueError, match="no LoRA/SSF"):
        Trainer(adapter_cfg("plain", student=plain), "cpu")


def _batches(epoch):
    rng = np.random.RandomState(epoch)
    for _ in range(3):
        yield {"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32)}


def test_trainer_adapter_only_freezes_saves_and_resumes(adapter_cfg, tmp_path):
    """Adapter-only ``Trainer`` steps: the frozen parameters bit-equal,
    every adapter moved; ``student_final`` read back gives the trained
    model's forward bit for bit; a run resumed at step 2 ends where the
    uninterrupted 4-step run ends, every parameter bit for bit."""
    trainer = Trainer(adapter_cfg("a", num_epochs=2), "cpu")
    frozen = _frozen(trainer.student)
    start = [p.detach().clone() for p in adapter_parameters(trainer.student)]
    trainer.run(_batches, max_steps=4, steps_per_epoch=3)
    for name, p in trainer.student.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
    assert all(not torch.equal(p.detach(), s)
               for p, s in zip(adapter_parameters(trainer.student), start))

    loaded = create_model(MODELS[STUDENT], device="cpu", seed=None, fused_tail=False)
    ckpt.load_state_dict_file(loaded, str(tmp_path / "a" / "student_final.safetensors"))
    x = torch.from_numpy(_images(2, 5)).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(loaded(x)[0], trainer.student(x)[0])

    Trainer(adapter_cfg("b", num_epochs=2), "cpu").run(_batches, max_steps=2, steps_per_epoch=3)
    resumed = Trainer(adapter_cfg("c", num_epochs=2), "cpu")
    resumed.resume(str(tmp_path / "b"))
    resumed.run(_batches, max_steps=4, steps_per_epoch=3)
    for (name, a), b in zip(resumed.student.named_parameters(), trainer.student.parameters()):
        assert torch.equal(a.detach(), b.detach()), name


def test_cli_trains_adapters_on_smoke_data(presets, tmp_path, monkeypatch):
    """``--lora_rank``, ``--use_ssf`` and ``--adapter_only`` through
    ``cli.train`` (a preset without adapters given them by the flags): the
    final file carries the adapters in the JAX package's layout and the
    base weights as they were."""
    monkeypatch.chdir(ROOT)  # the smoke CSV names its images relative to the repository
    plain = "tiny-adapter-plain"
    MODELS[plain] = _tiny(MODELS, "student", lora_rank=0, use_ssf=False)
    try:
        out = tmp_path / "run"
        history = train_cli.main([
            "--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(out),
            "--student_arch", plain, "--teacher_models", TEACHER, "--batch_size", "2",
            "--num_iterations", "2", "--image_size", str(SIZE), "--teacher_dtype", "float32",
            "--lora_rank", "2", "--use_ssf", "--adapter_only", "--log_interval", "1",
            "--visualize_interval", "0", "--checkpoint_interval", "0"])
    finally:
        del MODELS[plain]
    assert np.isfinite(history["train_loss"]).all()
    saved = ckpt.read_safetensors(str(out / "student_final.safetensors"))
    assert saved["pretrained.blocks.0.attn.qkv.lora_A"].shape == (2, 128)
    assert saved["pretrained.blocks.2.attn.proj.lora_B"].shape == (128, 2)
    assert "adapters.pretrained.blocks_1.ssf_mlp.gamma" in saved
    # a seed gives the same base weights with adapters as without
    seeded = create_model(_tiny(MODELS, "student", lora_rank=0, use_ssf=False), device="cpu",
                          seed=42, fused_tail=False)
    for k, v in seeded.state_dict().items():
        assert torch.equal(saved[k], v), k
