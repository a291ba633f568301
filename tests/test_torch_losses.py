"""The port's loss stack against the JAX package, in fp32 on the CPU.

Fixed ``[2, 56, 56]`` depth maps and ``[2, 16, 32]`` token features, made
with numpy, go through each JAX loss and its port; values and gradients
(with respect to the student depth and features) must agree to
``|err| <= 1e-5 * (1 + |ref|)``: the two packages sum in other orders.
Readings: 5.9e-6 for the dense SSI map's sum (6,272 aligned values), 3.9e-6
for the hybrid normalization (values divided by segment MADs), at most
1.4e-6 elsewhere. Context masks are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu import losses as J
from distill_any_depth_tpu.configs import LossConfig as JLossConfig
from distill_any_depth_tpu.losses import feature as jfeature
from distill_any_depth_tpu_torch.configs import LossConfig
from distill_any_depth_tpu_torch.losses import distill, feature, gradient, hdn, normalization, ssi

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref)
    assert np.all(err <= tol * (1 + np.abs(ref))), err.max()


def _maps(seed=0, b=2, h=56, w=56):
    """A smooth positive depth map with noise: no accidental ties."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / h
    base = np.stack([1.5 + np.sin(rng.uniform(2, 6) * xx + rng.uniform(1, 4) * yy)
                     for _ in range(b)])
    return (base + 0.1 * rng.rand(b, h, w)).astype(np.float32)


def _feats(seed=1, b=2, n=16, c=32):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def _grads(jfn, tfn, *arrays, argnums=(0,)):
    """Value and gradients (w.r.t. ``argnums``) of a scalar loss in both
    packages on the same numpy ``arrays``."""
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a).requires_grad_(i in argnums) if a.dtype.kind == "f"
          else torch.tensor(a) for i, a in enumerate(arrays)]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, [ts[i] for i in argnums])
    return (tv.item(), [g.numpy() for g in tg]), (float(jv), [np.asarray(g) for g in jg])


def _check(jfn, tfn, *arrays, argnums=(0,)):
    (tv, tg), (jv, jg) = _grads(jfn, tfn, *arrays, argnums=argnums)
    _close(tv, jv)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("strategy", ["global", "hybrid", "none"])
def test_distillation_loss(strategy):
    s, t = _maps(0), _maps(1)
    _check(lambda a, b: J.distillation_loss(a, b, strategy),
           lambda a, b: distill.distillation_loss(a, b, strategy), s, t)


@pytest.mark.parametrize("strategy", ["global", "hybrid"])
def test_normalize_depth(strategy):
    d = _maps(2)
    want = np.asarray(J.normalize_depth(jnp.asarray(d), strategy))
    _close(normalization.normalize_depth(torch.from_numpy(d), strategy).numpy(), want)


def test_gradient_preservation_loss():
    _check(J.gradient_preservation_loss, gradient.gradient_preservation_loss, _maps(3))


@pytest.mark.parametrize("dense", [False, True])
def test_ssi_mae_loss(dense):
    p, g = _maps(4), _maps(5)
    m = np.random.RandomState(6).rand(*p.shape) > 0.3
    if dense:  # a dense map: hold the sum and its gradient
        _check(lambda a, b, c: jnp.sum(J.ssi_mae_loss(a, b, c, dense=True)),
               lambda a, b, c: ssi.ssi_mae_loss(a, b, c, dense=True).sum(), p, g, m)
    else:
        _check(lambda a, b, c: J.ssi_mae_loss(a, b, c),
               lambda a, b, c: ssi.ssi_mae_loss(a, b, c), p, g, m)


@pytest.mark.parametrize("variant", ["dr", "dp", "ds"])
def test_hdn_contexts_and_loss(variant):
    p, g = _maps(7), _maps(8)
    mask = np.random.RandomState(9).rand(*g.shape) > 0.1
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if variant == "dr":
        jctx = J.get_contexts_dr(3, jnp.asarray(g), jm)
        tctx = hdn.get_contexts_dr(3, torch.from_numpy(g), tm)
    elif variant == "dp":
        jctx = J.get_contexts_dp(3, jnp.asarray(g), jm)
        tctx = hdn.get_contexts_dp(3, torch.from_numpy(g), tm)
    else:
        jctx = J.get_contexts_ds(3, jm)
        tctx = hdn.get_contexts_ds(3, tm)
    np.testing.assert_array_equal(tctx.numpy(), np.asarray(jctx))
    ctx = np.asarray(jctx)
    _check(lambda a, b, c: J.hdn_loss(a, b, c), lambda a, b, c: hdn.hdn_loss(a, b, c),
           p, g, ctx)


def test_feature_loss_same_width():
    _check(J.feature_distillation_loss, feature.feature_distillation_loss,
           _feats(1), _feats(2), argnums=(0,))


def test_feature_loss_channel_resize():
    """A wider teacher is nearest-resized down to the student's channels."""
    _check(J.feature_distillation_loss, feature.feature_distillation_loss,
           _feats(1, c=32), _feats(2, c=48), argnums=(0,))


def test_feature_loss_token_projection():
    """Token counts differ: the port takes the projection the JAX package
    draws from its fixed key."""
    s, t = _feats(1, n=16), _feats(2, n=24)
    proj = jax.random.normal(jax.random.PRNGKey(jfeature._PROJ_SEED + 1), (24, 16)) / 24 ** 0.5
    _check(J.feature_distillation_loss,
           lambda a, b: feature.feature_distillation_loss(
               a, b, projections=(None, torch.tensor(np.asarray(proj)))),
           s, t, argnums=(0,))
    with pytest.raises(ValueError, match="projection"):
        feature.feature_distillation_loss(torch.from_numpy(s), torch.from_numpy(t))


@pytest.mark.parametrize("cfg", [
    dict(),  # the default stack: hybrid normalization, HDN dr/3
    dict(normalization="global", hdn_variant="dp"),
    dict(normalization="local", hdn_variant="ds", lambda_grad=0.7),
    dict(normalization="none", use_hdn=False),
], ids=["default", "global_dp", "local_ds", "none_nohdn"])
def test_combined_distillation_loss(cfg):
    jcfg, tcfg = JLossConfig(**cfg), LossConfig(**cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    sg, sl, t = _maps(10), _maps(11), _maps(12)
    sf, tf = _feats(13), _feats(14)

    def jfn(a, b, c, d, e):
        total, comps = J.combined_distillation_loss(jcfg, a, b, c, d, e)
        return total, comps

    def tfn(a, b, c, d, e):
        return distill.combined_distillation_loss(tcfg, a, b, c, d, e)

    (jt, jc), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (sg, sl, sf, t, tf)))
    ins = [torch.from_numpy(x).requires_grad_(i < 3) for i, x in enumerate((sg, sl, sf, t, tf))]
    tt, tc = tfn(*ins)
    tg = torch.autograd.grad(tt, ins[:3])
    assert sorted(tc) == sorted(jc)
    for k in jc:
        _close(tc[k].item(), float(jc[k]))
    for a, b in zip(tg, jg):
        _close(a.numpy(), np.asarray(b))
