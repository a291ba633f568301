"""The DINOv2 register/SwiGLU family (``depthanything-giant``,
``-large-reg``, ``-giant-reg``) in the port against the JAX package, in
fp32 on the CPU, with the same weights (loaded through ``params_from_jax``).

Tiny configs from each preset: 4 blocks, width 128, two 64-wide heads, taps
after every block, small DPT projections; the preset's FFN, register
tokens, pre-norm taps, LayerScale init, DPT features (384 for the giant
heads, so their tail is the C = 384 tail) and head kind are kept.
Tolerance: |err| <= 2e-5 * (1 + |ref|), as ``tests/test_torch_model.py``;
the int8 GEMMs at the bound of ``tests/test_torch_quant.py``, and the
distillation step at the limits of ``tests/test_torch_train.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.configs import OptimizerConfig as JOptimizerConfig
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.models.vit import DinoViT as JaxDinoViT
from distill_any_depth_tpu.models.vit import SwiGLU as JaxSwiGLU
from distill_any_depth_tpu.ops.dpt_tail import fused_dpt_tail_v2
from distill_any_depth_tpu.ops.dpt_tail import tail_reference as jax_tail_reference
from distill_any_depth_tpu.train.state import create_train_state as jax_create_train_state
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu.utils.torch_interop import load_safetensors_params, params_to_torch
from distill_any_depth_tpu_torch.cli import convert as convert_cli
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.models.vit import SwiGLU
from distill_any_depth_tpu_torch.ops.dpt_tail import pack_conv_weight, tail_reference
from distill_any_depth_tpu_torch.train.state import create_train_state, make_lr_schedule
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file
from distill_any_depth_tpu_torch.utils.convert import params_from_jax
from distill_any_depth_tpu_torch.utils.profiling import recording

TOL = 2e-5
QUANT_TOL = 1e-4  # tests/test_torch_quant.py's MODEL_TOL
ARCHS = ("depthanything-giant", "depthanything-large-reg", "depthanything-giant-reg")


@pytest.fixture(autouse=True)
def one_thread():
    """The models here on one thread: Tier-1 runs several test files at
    once, and torch's thread per core would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(models, arch: str, dim: int = 128, heads: int = 2, **head):
    cfg = models[arch]
    enc = dataclasses.replace(cfg.encoder, embed_dim=dim, depth=4, num_heads=heads,
                              out_indices=(0, 1, 2, 3))
    return dataclasses.replace(cfg, encoder=enc, out_channels=(32, 64, 96, 128), **head)


def _jax_params(jmodel, size: int, seed: int = 0) -> dict:
    x = jnp.zeros((1, size, size, 3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    jcfg, tcfg = tiny(JAX_MODELS, arch), tiny(MODELS, arch)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = _jax_params(jmodel, 98)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, tmodel


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * (1 + np.abs(ref))), err.max()


def _inputs(h, w, seed=0):
    x = np.random.RandomState(seed).rand(2, h, w, 3).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def test_presets_match_jax():
    """The three presets are the JAX package's, field for field, the
    encoder's adapter fields (``lora_rank``, ``use_ssf``) included."""
    for arch in ARCHS:
        port, want = dataclasses.asdict(MODELS[arch]), dataclasses.asdict(JAX_MODELS[arch])
        enc, want_enc = port.pop("encoder"), want.pop("encoder")
        assert port == want, arch
        assert {"lora_rank", "use_ssf"} <= set(enc)
        assert enc == want_enc, arch


@pytest.mark.parametrize("quant", ["none", "int8", "int8_pallas"])
@pytest.mark.parametrize("dim", [48, 128])
def test_swiglu_matches_jax(dim, quant):
    """``SwiGLU`` against the JAX module: the hidden width (2/3 of 4 dim
    rounded up to a multiple of 8: 128 at dim 48, 344 at dim 128), the
    packed w12 split in halves, and the int8 GEMMs (both port routes
    against the JAX ``int8`` route, whose GEMMs they equal bit for bit in
    fp32; silu in the two frameworks may differ by an ulp, which can flip a
    w3 activation's round-half-even tie)."""
    x = np.random.RandomState(dim).randn(2, 7, dim).astype(np.float32)
    jmod = JaxSwiGLU(dim=dim, mlp_ratio=4.0, quant="none" if quant == "none" else "int8")
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = SwiGLU(dim, 4.0, quant)
    hidden = params["w3"]["kernel"].shape[0]
    assert hidden == {48: 128, 128: 344}[dim] and mod.w3.in_features == hidden
    mod.load_state_dict({f"{name}.{leaf}": torch.from_numpy(
        np.array(params[name]["kernel"].T if leaf == "weight" else params[name]["bias"]))
        for name in ("w12", "w3") for leaf in ("weight", "bias")}, strict=True)
    with torch.no_grad(), recording() as rec:
        got = mod(torch.from_numpy(x)).numpy()
    assert "kernels/w8a8" not in rec.counts  # on the CPU: the plain version
    _close(got, want, TOL if quant == "none" else QUANT_TOL)


@pytest.mark.parametrize("hw", [(98, 126), (56, 56)])
@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_taps_and_cls_tokens(arch, hw):
    """Taps and cls tokens against JAX ``DinoViT``: the registers are in
    neither (the taps hold the patch grid's tokens alone), and with
    ``tap_norm=False`` both are pre-norm."""
    jmodel, params, tmodel = _pair(arch)
    x, xt = _inputs(*hw)
    encoder = JaxDinoViT(jmodel.cfg.encoder, attn_impl="reference")
    jtaps, jcls = jax.jit(encoder.apply)({"params": params["pretrained"]}, jnp.asarray(x))
    with torch.no_grad():
        taps, cls = tmodel.pretrained(xt)
    assert len(taps) == len(jtaps) == 4
    for a, b in zip(taps, jtaps):
        assert a.shape[1] == (hw[0] // 14) * (hw[1] // 14)
        _close(a.numpy(), b)
    for a, b in zip(cls, jcls):
        _close(a.numpy(), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_model_matches_jax(arch):
    jmodel, params, tmodel = _pair(arch)
    x, xt = _inputs(98, 126, seed=1)
    jdepth, jfeat = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        depth, feat = tmodel(xt)
    _close(depth.numpy(), jdepth)
    _close(feat.numpy(), jfeat)
    assert (depth >= 0).all()


def _tail_params(rng, ci, cm):
    return dict(k1=rng.randn(3, 3, ci, cm) * 0.05, b1=rng.randn(cm) * 0.1,
                k2=rng.randn(3, 3, cm, 32) * 0.05, b2=rng.randn(32) * 0.1,
                kd=rng.randn(32, 1) * 0.2, bd=rng.randn(1) * 0.1)


@pytest.mark.parametrize("jax_tail", ["tail_reference", "fused_dpt_tail_v2"])
def test_plain_tail_c384_matches_jax(jax_tail):
    """The plain tail at ViT-g's C = 384 on t [1, 8, 8, 384] -> 28^2 (a 2 x 2
    patch grid) against JAX ``tail_reference`` and against the TPU kernel
    ``fused_dpt_tail_v2`` in interpret mode, both trailing-ReLU forms."""
    rng = np.random.RandomState(0)
    p = {k: v.astype(np.float32) for k, v in _tail_params(rng, 384, 192).items()}
    t = (rng.randn(1, 8, 8, 384) * 0.5).astype(np.float32)
    for trailing in (True, False):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        if jax_tail == "tail_reference":
            want = jax_tail_reference(jnp.asarray(t), (28, 28), trailing_relu=trailing,
                                      dtype=jnp.float32, **jp)
        else:
            want = fused_dpt_tail_v2(jnp.asarray(t), (28, 28), trailing_relu=trailing,
                                     interpret=True, **jp)
        got = tail_reference(torch.from_numpy(t), (28, 28), trailing_relu=trailing,
                             **{k: torch.from_numpy(v) for k, v in p.items()})
        _close(got.numpy(), want)


@pytest.mark.parametrize("cin,cout", [(384, 192), (192, 32)])
def test_pack_conv_weight_at_vitg_widths(cin, cout):
    """``pack_conv_weight`` at the C = 384 tail's conv1 (6 chunks of 64) and
    head conv (3 chunks): element ``(n, (cc * 9 + tap) * 64 + ci)`` is
    ``k[tap // 3, tap % 3, 64 * cc + ci, n]`` in bf16."""
    k = torch.from_numpy(np.random.RandomState(cin).randn(3, 3, cin, cout).astype(np.float32))
    packed = pack_conv_weight(k)
    chunks = cin // 64
    assert packed.shape == (cout, chunks * 9 * 64) and packed.dtype == torch.bfloat16
    n, col = np.meshgrid(np.arange(cout), np.arange(chunks * 9 * 64), indexing="ij")
    cc, tap, ci = col // (9 * 64), col // 64 % 9, col % 64
    want = k.to(torch.bfloat16)[tap // 3, tap % 3, 64 * cc + ci, n]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_file_with_mask_token_loads(tmp_path, arch):
    """A reference-layout file of the tiny preset (JAX ``params_to_torch``,
    ``register_tokens`` and SwiGLU's ``mlp.w12`` / ``mlp.w3`` where the
    preset has them) plus the reference's ``pretrained.mask_token`` loads
    strict through ``load_state_dict_file``, and so does its
    ``cli.convert`` output (``backbone.*``); the JAX loader reads both to
    the same params."""
    jcfg, tcfg = tiny(JAX_MODELS, arch), tiny(MODELS, arch)
    params = _jax_params(jax_create_model(jcfg), 56, seed=3)
    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
             for k, v in params_to_torch(params, jcfg).items()}
    enc = tcfg.encoder
    assert ("pretrained.register_tokens" in state) == (enc.num_register_tokens > 0)
    assert ("pretrained.blocks.0.mlp.w12.weight" in state) == (enc.ffn == "swiglu")
    state["pretrained.mask_token"] = torch.zeros(1, enc.embed_dim)
    path = str(tmp_path / "reference.safetensors")
    save_file(state, path)
    converted = str(tmp_path / "backbone.safetensors")
    assert convert_cli.main([path, converted]) == sum(k.startswith("pretrained.") for k in state)
    want = params_from_jax(params, tcfg)
    for file in (path, converted):
        model = create_model(tcfg, device="cpu", seed=None)
        load_state_dict_file(model, file)
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert torch.equal(got[key], value), key
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               load_safetensors_params(file, jcfg, strict=True), params)


# tests/test_torch_train.py's trajectory limits
SIZE, BATCH, STEPS, LR = 56, 4, 3, 1e-4
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_MEAN_DIST = 6e-5, 1e-4, 2e-8


def _train_pair(arch: str, dim: int, heads: int, seed: int, **head):
    jcfg, tcfg = tiny(JAX_MODELS, arch, dim, heads, **head), tiny(MODELS, arch, dim, heads, **head)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = _jax_params(jmodel, SIZE, seed)
    model = create_model(tcfg, device="cpu", fused_tail=False)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, model, tcfg


def _flat_state(sd: dict) -> np.ndarray:
    return np.concatenate([sd[k].detach().numpy().ravel() for k in sorted(sd)])


def test_register_teacher_step_matches_jax():
    """Three distillation steps of a tiny ViT-B student under a tiny
    ``depthanything-giant-reg`` teacher (registers, SwiGLU, pre-norm taps,
    the teacher head, 192 wide: its features are nearest-resized to the
    student's 128) against the JAX step, shared views and the teacher in
    chunks of 2 as ``tests/test_torch_train.py`` runs them: the loss
    components, the gradient norm, each step's move of the parameters, and
    the parameters after the last update."""
    jstudent, sp, student, scfg = _train_pair("depthanything-base", 128, 2, 0, features=32)
    jteacher, tp, teacher, _ = _train_pair("depthanything-giant-reg", 192, 3, 1)
    teacher.requires_grad_(False)
    opt = dict(lr=LR, weight_decay=1e-5, warmup_steps=1, schedule="cosine", total_steps=10,
               max_grad_norm=1.0)
    loss = dict(normalization="global")
    state_j, tx = jax_create_train_state(sp, JOptimizerConfig(**opt))
    step_j = jax_make_train_step(
        lambda p, x: jstudent.apply({"params": p}, x),
        [lambda p, x: jteacher.apply({"params": p}, x)],
        tx, JLossConfig(**loss), seed=0, views_shared=True, teacher_chunk=2)
    schedule = make_lr_schedule(OptimizerConfig(**opt))
    state_t = create_train_state(student, OptimizerConfig(**opt))
    step_t = make_train_step(student, [teacher], LossConfig(**loss), views_shared=True,
                             teacher_chunk=2)
    rng = np.random.RandomState(0)
    before = _flat_state(student.state_dict())
    for i in range(STEPS):
        x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        state_j, mj = step_j(state_j, (tp,), jnp.asarray(x), jnp.asarray(x))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        mt = step_t(state_t, 0, xt, xt)
        for key in ("sc", "lg", "feat", "grad", "hdn", "total"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {i} loss {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL, err_msg=f"step {i} gradient norm")
        after = _flat_state(student.state_dict())
        lr, moved = float(schedule(i)), np.mean(np.abs(after - before))
        assert (moved == 0.0) if lr == 0 else (0.2 * lr < moved < lr), (i, lr, moved)
        before = after
    theirs = _flat_state(params_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params),
                                         scfg))
    assert np.mean(np.abs(before - theirs)) < PARAM_MEAN_DIST
