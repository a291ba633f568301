"""The windowed model's gradients against the JAX package, in fp32 on the CPU.

- The plain backward of the biased attention (the plain version of
  kernel 6, from the plain forward's output and row log-sum-exp) against
  ``jax.grad`` of the JAX ``mha_flash`` in interpret mode (its Pallas
  forward and ``_flash_bwd_impl``), with a window, a random and a segment
  bias, at N = 71 and at a multi-tile N.
- The plain banded backward (kernel 8's) against ``jax.grad`` of the JAX
  banded path (``_banded_fwd_impl`` with lse and ``_banded_bwd_impl``),
  with the JAX banded threshold lowered so that it runs at these grids,
  and the plain lse against the JAX kernel's.
- A bias that requires a gradient: the port's ``mha_flash`` (the plain
  attention) returns dbias equal to the JAX einsum fallback's.
- The autograd Function of the card's training path (kernels 5 + 6 and
  7 + 8 on the packed qkv), its kernel launches stood in for by the plain
  versions, with kernel 5's saved bias terms feeding the backward,
  against ``jax.grad`` of the JAX ``mha_flash``.
- The explicit banded plain backward equal to autograd of the dense plain
  attention with the window bias.
- A 3-step trajectory of a tiny windowed student (2 blocks, width 64,
  window 3) under a tiny ViT teacher against the JAX ``make_train_step``,
  from the same weights (``params_from_jax``), on the dense and the
  banded attention path.

Tolerances, |err| <= tol * (1 + |ref|), about 3x the readings: 5e-6 for
the attention gradients against the JAX package (readings up to 1.4e-6:
fp32 sums in other orders; the JAX dense backward also divides by the row
sum in another place), 3e-6 for the banded plain backward against dense
autograd (9.2e-7), 1e-6 for the lse; the trajectory's limits are stated
at its test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.configs import OptimizerConfig as JOptimizerConfig
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.ops import flash_attention as jax_fa
from distill_any_depth_tpu.ops import window as jax_window
from distill_any_depth_tpu.train.state import create_train_state as jax_create_train_state
from distill_any_depth_tpu.train.step import make_train_step as jax_make_train_step
from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.ops.window import local_window_bias, segment_bias
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

TOL = 5e-6


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / (1 + np.abs(ref))
    assert np.all(err <= tol), err.max()


def _inputs(b, n, h, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, 64).astype(np.float32) for _ in range(4)]  # q, k, v, g


def _bias(kind, n, seed):
    if kind == "window":  # a grid behind one prefix token: 7 x 10 (N = 71), 12 x 12 (145)
        gh, gw = {71: (7, 10), 145: (12, 12)}[n]
        return local_window_bias(gh, gw, 3, n_prefix=1).numpy()
    if kind == "random":
        return np.random.RandomState(seed).randn(n, n).astype(np.float32)
    sizes = [20, 1, 30, n - 51]  # a 1-token segment too
    return segment_bias(torch.from_numpy(np.repeat(np.arange(4), sizes))).numpy()


def _jax_grads(q, k, v, g, bias, band=None):
    def f(q, k, v):
        out = jax_fa.mha_flash(q, k, v, jnp.asarray(bias), interpret=True, band=band)
        return jnp.sum(out * jnp.asarray(g))

    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("n", [71, 145])
@pytest.mark.parametrize("kind", ["window", "random", "segment"])
def test_bias_backward_matches_jax_flash(kind, n):
    """Kernel 6's plain version, and autograd of the plain forward (the CPU
    training path), against the JAX Pallas backward."""
    q, k, v, g = _inputs(2, n, 2, seed=n)
    bias = _bias(kind, n, seed=n + 1)
    want = _jax_grads(q, k, v, g, bias)
    qt, kt, vt, gt, bt = map(torch.from_numpy, (q, k, v, g, bias))
    out, lse = fa.mha_bias_reference(qt, kt, vt, bt, with_lse=True)
    assert lse.shape == (2, 2, n) and torch.isfinite(lse).all()
    got = fa.bias_attention_backward(qt, kt, vt, bt, out, lse, gt)  # CPU: the plain version
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    xs = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    fa.mha_flash(*xs, bt).backward(gt)
    for x, b in zip(xs, want):
        _close(x.grad.numpy(), b)


@pytest.mark.parametrize("gh,gw,window", [
    (9, 9, 3), (7, 12, 3), (3, 5, 7), (12, 20, 7), (20, 9, 5),
])
def test_banded_backward_matches_jax_banded(monkeypatch, gh, gw, window):
    monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
    n = gh * gw
    q, k, v, g = _inputs(2, n, 2, seed=gh * gw)
    bias = np.asarray(jax_window.local_window_bias(gh, gw, window, n_prefix=0))
    want = _jax_grads(q, k, v, g, bias, band=(gw, window))
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out, lse = fa.mha_banded_reference(qt, kt, vt, (gw, window), with_lse=True)
    got = fa.banded_attention_backward(qt, kt, vt, (gw, window), out, lse, gt)
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    # the row log-sum-exp against the JAX kernel's (_banded_kernel_lse)
    fold = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(4, n, 64)) for x in (q, k, v)]
    _, jlse = jax_fa._banded_fwd_impl(*fold, jnp.asarray(bias)[None], (gw, window),
                                      interpret=True, with_lse=True)
    _close(lse.reshape(4, n).numpy(), np.asarray(jlse)[:, 0], 1e-6)


@pytest.mark.parametrize("banded", [False, True])
def test_trainable_bias_grad_matches_jax_einsum(monkeypatch, banded):
    """A bias that requires a gradient takes the plain attention, whose
    autograd returns dbias: equal to the JAX einsum fallback's, banded grid
    or not."""
    if banded:
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    gh, gw, window = 9, 9, 3
    n = gh * gw
    q, k, v, g = _inputs(2, n, 2, seed=3)
    bias = local_window_bias(gh, gw, window, 0).numpy()
    bias = np.where(np.isfinite(bias), np.random.RandomState(4).randn(n, n), bias)
    bias = bias.astype(np.float32)

    def f(q, k, v, b):
        out = jax_fa.mha_flash(q, k, v, b, interpret=True, band=(gw, window))
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    fa.mha_flash(*xs, band=(gw, window)).backward(torch.from_numpy(g))
    for x, b in zip(xs, want):
        _close(x.grad.numpy(), b)


@pytest.mark.parametrize("gh,gw,window", [
    (9, 9, 3), (7, 12, 3), (3, 5, 7), (12, 20, 7), (13, 29, 5),
])
def test_banded_plain_backward_equals_dense_autograd(gh, gw, window):
    n = gh * gw
    q, k, v, g = map(torch.from_numpy, _inputs(2, n, 2, seed=gh + gw))
    bias = local_window_bias(gh, gw, window, 0)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.mha_bias_reference(*xs, bias).backward(g)
    out, lse = fa.mha_banded_reference(q, k, v, (gw, window), with_lse=True)
    got = fa.banded_attention_backward_reference(q, k, v, (gw, window), out, lse, g)
    for a, x in zip(got, xs):
        _close(a.numpy(), x.grad.numpy(), 3e-6)


def _plain_kernels(monkeypatch, calls):
    """Stand in for the four kernel launches of ``_MaskedAttention`` with
    their plain versions, as the card runs them: kernel 5 returns padded
    fp32 terms (N rounded up to 128, -inf past N) for the backward, and
    kernel 6 reads its bias from them. ``calls`` records what each got."""
    def bias_forward(q, k, v, bias, with_lse):
        n = q.shape[1]
        tn = -(-n // 128) * 128
        terms = torch.full((tn, tn), -torch.inf)
        terms[:n, :n] = 0.0 if bias is None else bias
        calls["terms"] = terms
        return (*fa.mha_bias_reference(q, k, v, bias, with_lse=True), None, terms)

    def bias_backward(q, k, v, bias, out, lse, g, live, terms, dqkv):
        n = q.shape[1]
        calls["backward_terms"] = terms
        dqkv.copy_(torch.stack(fa.bias_attention_backward_reference(
            q, k, v, terms[:n, :n], out, lse, g), dim=2))

    def banded_backward(q, k, v, band, out, lse, g, dqkv):
        dqkv.copy_(torch.stack(fa.banded_attention_backward_reference(
            q, k, v, band, out, lse, g), dim=2))

    monkeypatch.setattr(fa, "_bias_forward", bias_forward)
    monkeypatch.setattr(fa, "_bias_backward", bias_backward)
    monkeypatch.setattr(fa, "_banded_forward",
                        lambda q, k, v, band, with_lse: fa.mha_banded_reference(
                            q, k, v, band, with_lse=True))
    monkeypatch.setattr(fa, "_banded_backward", banded_backward)


@pytest.mark.parametrize("banded", [False, True], ids=["bias", "banded"])
def test_masked_attention_function_matches_jax(monkeypatch, banded):
    """The autograd Function of the card's training path (kernels 5 + 6 or
    7 + 8 on the packed qkv), its kernel launches stood in for by their
    plain versions: d(qkv) against ``jax.grad`` of the JAX ``mha_flash``,
    and kernel 5's terms handed to kernel 6 as they were saved."""
    if banded:
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        gh, gw, window = 12, 20, 7
        n, band, bias = gh * gw, (gw, window), None
        jbias = local_window_bias(gh, gw, window, 0).numpy()
    else:
        n, band = 145, None
        jbias = _bias("window", n, seed=0)
        bias = torch.from_numpy(jbias)
    calls = {}
    _plain_kernels(monkeypatch, calls)
    q, k, v, g = _inputs(2, n, 2, seed=n + 5)
    want = _jax_grads(q, k, v, g, jbias, band=band)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2).reshape(2, n, 3 * 2 * 64))
    qkv.requires_grad_()
    fa._MaskedAttention.apply(qkv, 2, bias, band).backward(torch.from_numpy(g))
    for a, b in zip(qkv.grad.view(2, n, 3, 2, 64).unbind(2), want):
        _close(a.numpy(), b)
    if not banded:
        assert calls["backward_terms"] is calls["terms"]


# ---------------------------------------------------------------- trajectory
SIZE, BATCH, STEPS, LR = 126, 2, 3, 1e-4  # a 9 x 9 grid
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_MEAN_DIST = 5e-5, 2e-5, 5e-9


def _tiny(models, role: str):
    if role == "student":
        cfg = models["depthanything-base-window"]
        enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                                  window_size=3)
    else:
        cfg = models["depthanything-base"]
        enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                                  out_indices=(0, 1, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


@functools.lru_cache(maxsize=None)
def _params(role: str, seed: int):
    jmodel = jax_create_model(_tiny(JAX_MODELS, role),
                              attn_impl="flash" if role == "student" else "reference")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    return jmodel, jax.tree_util.tree_map(np.asarray, params["params"])


def _torch_model(role: str, params):
    cfg = _tiny(MODELS, role)
    model = create_model(cfg, device="cpu", fused_tail=False)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _flat_state(model) -> np.ndarray:
    sd = {k: v.detach().numpy().ravel() for k, v in model.state_dict().items()}
    return np.concatenate([sd[k] for k in sorted(sd)])


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_windowed_student_trajectory_matches_jax(monkeypatch, banded):
    """Each step's loss components and gradient norm, and the parameters
    after the last update, against the JAX step (the windowed student on
    its Pallas attention in interpret mode, forward and backward). The
    limits are about 3x the readings, the same on both paths: loss
    components 1.6e-5 relative (the gradient loss; the others up to
    1.5e-6), gradient norm 5.7e-6, final parameters 1.7e-9 mean distance.
    Each step must move the parameters by 0.2-1 lr: the pos-embed, which
    the loss does not reach past the PE schedule, included, as optax's
    decay and Adam move it from a zero gradient."""
    if banded:
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    jstudent, sp = _params("student", 0)
    jteacher, tp = _params("teacher", 1)
    student, teacher = _torch_model("student", sp), _torch_model("teacher", tp)
    teacher.requires_grad_(False)
    opt = dict(lr=LR, weight_decay=1e-5, warmup_steps=0, schedule="cosine", total_steps=10,
               max_grad_norm=1.0)
    loss = dict(normalization="global")
    state_j, tx = jax_create_train_state(sp, JOptimizerConfig(**opt))
    # fresh lambdas: a jit cache entry per test, traced under this test's threshold
    step_j = jax_make_train_step(
        lambda p, x: jstudent.apply({"params": p}, x),
        [lambda p, x: jteacher.apply({"params": p}, x)],
        tx, JLossConfig(**loss), seed=0, views_shared=True, teacher_chunk=0)
    state_t = create_train_state(student, OptimizerConfig(**opt))
    step_t = make_train_step(student, [teacher], LossConfig(**loss), views_shared=True)

    rng = np.random.RandomState(0)
    before = _flat_state(student)
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
        after = _flat_state(student)
        lr, moved = float(state_t.schedule(i)), np.mean(np.abs(after - before))
        assert 0.2 * lr < moved < lr, (i, lr, moved)
        before = after
    theirs = params_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params),
                             _tiny(MODELS, "student"))
    theirs = np.concatenate([theirs[k].numpy().ravel() for k in sorted(theirs)])
    assert np.mean(np.abs(before - theirs)) < PARAM_MEAN_DIST
