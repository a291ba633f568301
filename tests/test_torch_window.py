"""The windowed model's pieces against the JAX package, in fp32 on the CPU.

- ``ops/window``: ``local_window_bias`` and ``segment_bias`` equal to the
  JAX functions exactly.
- The plain versions of the biased (kernel 5) and banded (kernel 7)
  attention against the JAX ``mha_flash`` in interpret mode (its Pallas
  kernels), with the JAX banded threshold lowered so that its banded kernel
  runs at these sizes: |err| <= 2e-5 * (1 + |ref|), fp32 sums in other
  orders.
- A tiny windowed model (2 blocks, width 64, window 3) against the JAX
  ``DepthModel`` with ``attn_impl="flash"``, on the same weights through
  ``params_from_jax``: depth and the four taps within 2e-5 * (1 + |ref|),
  at ``pe_step=None`` and mid-schedule, on the dense and the banded path.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.models.vit import DinoViT as JaxDinoViT
from distill_any_depth_tpu.ops import flash_attention as jax_fa
from distill_any_depth_tpu.ops import window as jax_window
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.ops.window import local_window_bias, segment_bias
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

TOL = 2e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= tol * (1 + np.abs(ref))), np.abs(got - ref).max()


@pytest.mark.parametrize("gh,gw,window,n_prefix", [
    (9, 9, 3, 0), (7, 12, 3, 1), (3, 5, 7, 0), (5, 4, 7, 1), (14, 14, 7, 0), (10, 3, 5, 2),
])
def test_local_window_bias_matches_jax(gh, gw, window, n_prefix):
    got = local_window_bias(gh, gw, window, n_prefix)
    want = np.asarray(jax_window.local_window_bias(gh, gw, window, n_prefix))
    np.testing.assert_array_equal(got.numpy(), want)
    # cached per grid, device and dtype; cast on request
    assert local_window_bias(gh, gw, window, n_prefix) is got
    bf16 = local_window_bias(gh, gw, window, n_prefix, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("ids", [[0, 0, 1, 1, 1, 2], [3, 1, 3, 1, 0, 0, 0], [5]])
def test_segment_bias_matches_jax(ids):
    got = segment_bias(torch.tensor(ids))
    want = np.asarray(jax_window.segment_bias(jnp.asarray(ids)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _qkv(b, n, h, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, 64).astype(np.float32) for _ in range(3)]


def _bias(kind, n, seed):
    if kind == "window":  # a 7 x 10 grid behind one prefix token
        return local_window_bias(7, 10, 3, n_prefix=1).numpy()
    if kind == "random":
        return np.random.RandomState(seed).randn(n, n).astype(np.float32)
    ids = np.repeat(np.arange(4), [20, 1, 30, 20])  # a 1-token segment too
    return segment_bias(torch.from_numpy(ids)).numpy()


@pytest.mark.parametrize("kind", ["window", "random", "segment"])
def test_bias_plain_matches_jax_flash(kind):
    n = 71  # not a multiple of the 64-key tile
    q, k, v = _qkv(2, n, 2, seed=3)
    bias = _bias(kind, n, seed=4)
    want = jax_fa.mha_flash(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias), interpret=True)
    qt, kt, vt, bt = map(torch.from_numpy, (q, k, v, bias))
    got = fa.mha_bias_reference(qt, kt, vt, bt)
    _close(got.numpy(), want)
    # the dispatch takes [N, N] and [1, N, N] to the same function
    torch.testing.assert_close(fa.mha_flash(qt, kt, vt, bt[None]), got, rtol=0, atol=0)


def test_per_head_bias_goes_to_plain_attention():
    q, k, v = _qkv(1, 20, 3, seed=5)
    bias = np.random.RandomState(6).randn(3, 20, 20).astype(np.float32)
    want = jax_fa.mha_flash(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias), interpret=True)
    got = fa.mha_flash(*map(torch.from_numpy, (q, k, v, bias)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("gh,gw,window", [
    (9, 9, 3),     # q tiles straddle grid rows; a ragged last q tile
    (7, 12, 3),    # non-square
    (3, 5, 7),     # grid shorter than the window on both axes
    (12, 20, 7),   # the clamp bites at both ends, 4 q tiles
    (20, 9, 5),
])
def test_banded_plain_matches_jax_banded(monkeypatch, gh, gw, window):
    monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
    n = gh * gw
    q, k, v = _qkv(2, n, 2, seed=gh)
    jbias = jax_window.local_window_bias(gh, gw, window, n_prefix=0)
    want = jax_fa.mha_flash(*map(jnp.asarray, (q, k, v)), jbias, interpret=True,
                            band=(gw, window))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = fa.mha_banded_reference(qt, kt, vt, (gw, window))
    _close(got.numpy(), want)
    # and the dense plain version with the window bias
    dense = fa.mha_bias_reference(qt, kt, vt, local_window_bias(gh, gw, window, 0))
    _close(got.numpy(), dense.numpy())


def test_band_dispatch(monkeypatch):
    """A band takes the banded path only on a whole grid of at least
    ``_BANDED_MIN_SEQ`` tokens, as in the JAX package."""
    calls = []
    monkeypatch.setattr(fa, "mha_banded_reference", lambda *a: calls.append("banded") or 0)
    monkeypatch.setattr(fa, "mha_bias_reference", lambda *a: calls.append("bias") or 0)
    q = torch.zeros(1, 84, 1, 64)
    fa.mha_flash(q, q, q, torch.zeros(84, 84), band=(12, 3))  # 84 < 3000
    monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    fa.mha_flash(q, q, q, None, band=(12, 3))
    fa.mha_flash(q, q, q, torch.zeros(84, 84), band=(11, 3))  # 84 % 11
    assert calls == ["bias", "banded", "bias"]


def _tiny(models):
    cfg = models["depthanything-base-window"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1, window_size=3)
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg, tcfg = _tiny(JAX_MODELS), _tiny(MODELS)
    jmodel = jax_create_model(jcfg, attn_impl="flash")
    x = jnp.zeros((1, 126, 126, 3))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)["params"])
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("pe_step", [None, 6000])
@pytest.mark.parametrize("hw", [(126, 126), (98, 168)])  # 9x9 and 7x12 grids
def test_windowed_model_matches_jax(monkeypatch, hw, pe_step, banded):
    if banded:
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    jmodel, params, tmodel = _pair()
    x = np.random.RandomState(7).rand(2, *hw, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    step = None if pe_step is None else jnp.asarray(pe_step)
    encoder = JaxDinoViT(jmodel.cfg.encoder, attn_impl="flash")
    # fresh lambdas: a jit cache entry per test, traced under this test's threshold
    jdepth, _ = jax.jit(lambda p, x, s: jmodel.apply(p, x, s))({"params": params}, x, step)
    jtaps, jcls = jax.jit(lambda p, x, s: encoder.apply(p, x, s))(
        {"params": params["pretrained"]}, x, step)
    with torch.no_grad():
        depth, _ = tmodel(xt, pe_step)
        taps, cls = tmodel.pretrained(xt, pe_step)
    _close(depth.numpy(), jdepth)
    assert len(taps) == len(jtaps) == 4
    for a, b in zip(taps + cls, list(jtaps) + list(jcls)):
        _close(a.numpy(), b)


def test_windowed_model_builds_no_bias_for_a_banded_grid(monkeypatch):
    _, _, tmodel = _pair()
    enc = tmodel.pretrained
    bias, band = enc._attention_mask(9, 9, 81, torch.device("cpu"), torch.float32)
    assert band == (9, 3) and bias.shape == (81, 81)
    monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    assert enc._attention_mask(9, 9, 81, torch.device("cpu"), torch.float32) == (None, (9, 3))


@pytest.mark.parametrize("banded", [False, True])
def test_packed_entry_with_bias_and_band_matches_jax(monkeypatch, banded):
    """``multi_head_attention_packed`` with a window bias (and band) views q,
    k, v in the packed tensor in place: equal to the JAX entry point."""
    from distill_any_depth_tpu.ops.attention import (
        multi_head_attention_packed as jax_packed,
    )
    from distill_any_depth_tpu_torch.ops.attention import multi_head_attention_packed

    if banded:
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    gh, gw, window = 6, 11, 5
    qkv = np.random.RandomState(8).randn(2, gh * gw, 3 * 128).astype(np.float32)
    bias = local_window_bias(gh, gw, window, 0)
    want = jax_packed(jnp.asarray(qkv), 2, jnp.asarray(bias.numpy()), impl="flash",
                      band=(gw, window))
    got = multi_head_attention_packed(torch.from_numpy(qkv), 2, bias, (gw, window))
    assert got.shape == (2, gh * gw, 128)
    _close(got.numpy(), want)
