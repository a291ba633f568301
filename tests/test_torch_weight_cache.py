"""The weights kept in the compute dtype under ``torch.inference_mode()``.

``models/vit.cast_weights`` keeps each layer's bf16 copy of its fp32
parameters (and the pos-embed of a grid) in an ``ops/derived.Derived`` of
the module while inference mode is on. On the
CPU, tiny, one thread: the outputs equal the ``no_grad`` forward's bit for
bit (the same rounding of the same tensors); the second call hits at every
cast site and misses at none; a ``load_state_dict``, an in-place update or
a ``.to()`` makes the next call miss and read the new weights; grad mode,
``no_grad`` and an fp32 model keep nothing; a training step is the one that
casts in every forward, and a model that ``predict`` ran trains.
"""
import dataclasses

import numpy as np
import pytest
import torch

from distill_any_depth_tpu_torch.cli import infer
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig
from distill_any_depth_tpu_torch.models import dpt, vit
from distill_any_depth_tpu_torch.models.dpt import ConvTranspose2d
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.models.vit import Conv2d, LayerNorm, LayerScale, Linear
from distill_any_depth_tpu_torch.ops.window import local_window_bias
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.profiling import recording

SIZE = 98  # a 7x7 grid: the pos-embed is resampled from the 37x37 base
SITES = (Linear, LayerNorm, Conv2d, LayerScale, ConvTranspose2d)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: tier-1 runs several test files at once, and two
    forwards of one batch sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(arch: str):
    """``depthanything-small`` at its widths, 4 blocks; the ViT-g-like
    ``depthanything-giant`` (SwiGLU, LayerScale, DPT features 384) at width
    128, 4 blocks; the windowed teacher at width 128, window 3."""
    cfg = MODELS[arch]
    if arch == "depthanything-small":
        enc = dataclasses.replace(cfg.encoder, depth=4, out_indices=(0, 1, 2, 3))
        return dataclasses.replace(cfg, encoder=enc)
    kw = dict(window_size=3) if arch == "depthanything-base-window" else {}
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=4, num_heads=2,
                              out_indices=(0, 1, 2, 3), **kw)
    return dataclasses.replace(cfg, encoder=enc, out_channels=(32, 64, 96, 128),
                               features=min(cfg.features, 64) if kw else cfg.features)


def _model(arch: str, dtype=torch.bfloat16, seed: int = 0, **kw):
    return create_model(_config(arch), dtype=dtype, device="cpu", seed=seed, **kw).eval()


def _input(seed: int = 0, batch: int = 2) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 3, SIZE, SIZE, generator=gen)


def _cast_calls(model, x) -> tuple[int, int]:
    """The forward's casts and the layers they cast for: each call of a
    layer (the final norm runs at every tap), the pos-embed, and the cls and
    register tokens (one cast for both)."""
    calls = []
    hooks = [m.register_forward_hook(lambda mod, *_: calls.append(mod))
             for m in model.modules() if isinstance(m, SITES)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    enc = model.pretrained
    own = 1 + (enc.cls_token is not None or enc.register_tokens is not None)
    return len(calls) + own, len(set(calls)) + own


def _forward(model, x, mode):
    with recording() as rec, mode():
        depth, feat = model(x)
    return depth, feat, rec.counts


def _derived(counts) -> tuple[int, int]:
    return counts.get("derived/hit", 0), counts.get("derived/miss", 0)


@pytest.mark.parametrize("arch", ["depthanything-small", "depthanything-giant"])
def test_inference_mode_equals_no_grad_and_hits_every_site(arch):
    model, x = _model(arch), _input()
    calls, sites = _cast_calls(model, x)
    want_depth, want_feat, counts = _forward(model, x, torch.no_grad)
    assert _derived(counts) == (0, 0)
    for call, (hits, misses) in enumerate([(calls - sites, sites), (calls, 0), (calls, 0)]):
        depth, feat, counts = _forward(model, x, torch.inference_mode)
        assert _derived(counts) == (hits, misses), call
        assert torch.equal(depth, want_depth) and torch.equal(feat, want_feat), call


def _scaled_state(model):
    return {k: v * 1.5 if v.is_floating_point() else v for k, v in model.state_dict().items()}


def _bump_one(model):
    with torch.no_grad():
        model.pretrained.blocks[0].mlp.w12.weight.add_(0.25)


def _to_float64(model):
    model.to(torch.float64)


@pytest.mark.parametrize("change,missed", [
    (lambda m: m.load_state_dict(_scaled_state(m)), "all"),
    (_bump_one, 1),
    (_to_float64, "all"),
], ids=["load_state_dict", "add_", "to"])
def test_a_weight_change_misses_and_reads_the_new_weights(change, missed):
    model, x = _model("depthanything-giant"), _input(1)
    calls, sites = _cast_calls(model, x)
    before, _, _ = _forward(model, x, torch.inference_mode)
    _forward(model, x, torch.inference_mode)
    change(model)
    depth, feat, counts = _forward(model, x, torch.inference_mode)
    missed = sites if missed == "all" else missed
    assert _derived(counts) == (calls - missed, missed)
    want_depth, want_feat, _ = _forward(model, x, torch.no_grad)
    assert torch.equal(depth, want_depth) and torch.equal(feat, want_feat)
    if change is not _to_float64:  # float64 holds the fp32 weights exactly
        assert not torch.equal(depth, before)


@pytest.mark.parametrize("mode", ["no_grad", "grad"])
def test_no_grad_and_grad_mode_keep_nothing(mode):
    model, x = _model("depthanything-giant"), _input(2)
    if mode == "grad":
        model.train()
    for _ in range(2):
        with recording() as rec, torch.set_grad_enabled(mode == "grad"):
            model(x)
        assert _derived(rec.counts) == (0, 0)
    assert all(m._value is None for m in _caches(model))


def _caches(model):
    for m in model.modules():
        for name in ("casts", "pe_casts", "token_casts"):
            if hasattr(m, name):
                yield getattr(m, name)


def test_an_fp32_model_keeps_nothing():
    model, x = _model("depthanything-giant", dtype=torch.float32), _input(3)
    want, _, _ = _forward(model, x, torch.no_grad)
    for _ in range(2):
        depth, _, counts = _forward(model, x, torch.inference_mode)
        assert _derived(counts) == (0, 0)
        assert torch.equal(depth, want)
    assert all(m._value is None for m in _caches(model))


def test_a_model_made_under_inference_mode_casts_every_call():
    """Parameters made under inference mode are inference tensors, which
    keep no version counter to key on: every call casts them again."""
    with torch.inference_mode():
        model = _model("depthanything-giant")
    x = _input(6)
    want, _, _ = _forward(model, x, torch.no_grad)
    for _ in range(2):
        depth, _, counts = _forward(model, x, torch.inference_mode)
        assert _derived(counts) == (0, 0)
        assert torch.equal(depth, want)


def _plain_casts(monkeypatch):
    """Every forward casts anew, in every mode: the code path before the
    weights were kept."""
    def cast(kept, dtype, tensors, compute=None, extra=None):
        return compute() if compute else [None if t is None else t.to(dtype) for t in tensors]

    monkeypatch.setattr(vit, "cast_weights", cast)
    monkeypatch.setattr(dpt, "cast_weights", cast)


def _student_step():
    """One bf16 distillation step from fixed weights and images: its loss
    components and the student's gradients."""
    student = _model("depthanything-small", seed=0, fused_tail=False).train()
    teacher = _model("depthanything-giant", seed=1).requires_grad_(False)
    state = create_train_state(student, OptimizerConfig(lr=1e-4, warmup_steps=0,
                                                        schedule="none", total_steps=10))
    step = make_train_step(student, [teacher], LossConfig(use_hdn=True, hdn_variant="dr"))
    x = _input(4)
    with recording() as rec:
        metrics = step(state, 0, x, x)
    grads = [p.grad.clone() for p in student.parameters()]
    return {k: float(v) for k, v in metrics.items()}, grads, rec.counts


def test_student_step_equals_the_step_that_casts_every_forward(monkeypatch):
    metrics, grads, counts = _student_step()
    assert _derived(counts) == (0, 0)
    with monkeypatch.context() as m:
        _plain_casts(m)
        want_metrics, want_grads, _ = _student_step()
    assert metrics == want_metrics
    assert all(torch.equal(g, w) for g, w in zip(grads, want_grads, strict=True))


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(60, 80, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("arch", ["depthanything-giant", "depthanything-base-window"])
def test_a_model_that_predict_ran_trains(arch):
    """``predict`` (inference mode: kept weights, the pos-embed matrices of
    the grid, the window bias) and then a training forward and backward on
    the same model: nothing made under inference mode reaches autograd."""
    model = _model(arch, fused_tail=False)
    first = infer.predict(model, _frames(3, 5), SIZE, batch_size=2)
    model.train()
    depth, _ = model(_input(5))
    depth.float().mean().backward()
    assert model.pretrained.blocks[0].attn.qkv.weight.grad is not None
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert not any(m.is_inference() for mats in model.pretrained._pe_mats.values()
                   for m in mats)
    model.eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    again = infer.predict(model, _frames(3, 5), SIZE, batch_size=2)
    assert not np.array_equal(first, again)


def test_window_bias_made_under_inference_mode_is_plain():
    with torch.inference_mode():
        bias = local_window_bias(5, 6, 3, 1, "cpu", torch.bfloat16)
    assert not bias.is_inference()
