"""The port's encoder and DepthModel against the JAX package, in fp32 on the
CPU, with the same weights (loaded through ``params_from_jax``).

Tiny configs (4 blocks, width 128, two 64-wide heads) cover the student
head, the teacher head (no trailing ReLU, resize to the input), the cls
readout and a multi-channel head. Tolerance: |err| <= 2e-5 * (1 + |ref|);
the two packages sum in other orders and resize with fp32 (torch) against
fp64-built (JAX) interpolation weights.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.models.vit import DinoViT as JaxDinoViT
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models import dpt
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops.resize import resize_nchw
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

TOL = 2e-5

HEADS = {
    "student": dict(),
    "teacher": dict(trailing_head_relu=False, interp_to_input=True),
    "clstoken": dict(use_clstoken=True),
    "multichannel": dict(head_out_channels=3, wo_relu_1_2_channel=True,
                         trailing_head_relu=False),
}


def tiny(models, head: str):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=4, num_heads=2,
                              out_indices=(0, 1, 2, 3))
    return dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128),
                               **HEADS[head])


def _jax_params(jmodel, size: int) -> dict:
    x = jnp.zeros((1, size, size, 3))
    return jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)["params"])


@functools.lru_cache(maxsize=None)
def _pair(head: str, image_size: int = 98):
    jcfg, tcfg = tiny(JAX_MODELS, head), tiny(MODELS, head)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = _jax_params(jmodel, image_size)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, tmodel


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= tol * (1 + np.abs(ref))), np.abs(got - ref).max()


def _inputs(h, w, seed=0):
    x = np.random.RandomState(seed).rand(2, h, w, 3).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(98, 126), (56, 56)])
def test_encoder_taps_and_cls_tokens(hw):
    jmodel, params, tmodel = _pair("student")
    x, xt = _inputs(*hw)
    encoder = JaxDinoViT(jmodel.cfg.encoder, attn_impl="reference")
    jtaps, jcls = jax.jit(encoder.apply)({"params": params["pretrained"]}, jnp.asarray(x))
    with torch.no_grad():
        taps, cls = tmodel.pretrained(xt)
    assert len(taps) == len(jtaps) == 4
    for a, b in zip(taps, jtaps):
        _close(a.numpy(), b)
    for a, b in zip(cls, jcls):
        _close(a.numpy(), b)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_depth_model_matches_jax(head):
    jmodel, params, tmodel = _pair(head)
    x, xt = _inputs(98, 126, seed=1)
    jdepth, jfeat = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        depth, feat = tmodel(xt)
    jdepth = np.asarray(jdepth)
    if jdepth.ndim == 4:  # multi-channel head: JAX is channels-last
        jdepth = jdepth.transpose(0, 3, 1, 2)
    _close(depth.numpy(), jdepth)
    _close(feat.numpy(), jfeat)
    if head != "multichannel":
        assert (depth >= 0).all()


def test_tail_kernel_branch_marshals_weights(monkeypatch):
    """A 1-channel head hands its tail to ``fused_dpt_tail`` (NHWC ``t``, HWIO
    weights), which runs its plain version on the CPU: the depth must be the
    plain NCHW chain's over the head's own modules."""
    _, _, tmodel = _pair("teacher")
    _, xt = _inputs(98, 98, seed=2)
    s = tmodel.depth_head.scratch
    calls, taps = [], []
    wrapper = dpt.fused_dpt_tail
    monkeypatch.setattr(dpt, "fused_dpt_tail",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    hook = s.refinenet1.register_forward_hook(lambda m, i, o: taps.append(o))
    try:
        with torch.no_grad():
            depth, _ = tmodel(xt)
    finally:
        hook.remove()
    t = taps[0]
    with torch.no_grad():
        x = s.output_conv1(resize_nchw(t, (2 * t.shape[2], 2 * t.shape[3])))
        # teacher head: no trailing ReLU in the head, the model's ReLU after it
        plain = F.relu(s.output_conv2(resize_nchw(x, (98, 98))))[:, 0]
    assert calls == [1]
    _close(depth.numpy(), plain.numpy(), 1e-5)


def test_patch_multiple_enforced():
    _, _, tmodel = _pair("student")
    with pytest.raises(ValueError, match="multiple of patch"):
        tmodel(torch.zeros(1, 3, 100, 98))
