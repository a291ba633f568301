"""The port's DepthModel at ViT-B width (768 wide, 12 heads, DPT features
128) with 2 blocks at 98^2, against the JAX package in fp32 on the CPU,
same weights. Tolerance: |err| <= 5e-5 * (1 + |ref|) (fp32 summation order
over 768/3072-wide products, fp32 against fp64-built resize weights)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.utils.convert import params_from_jax


def _jax_params(jmodel, size: int) -> dict:
    x = jnp.zeros((1, size, size, 3))
    return jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)["params"])


def _cut(models):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, depth=2, out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, encoder=enc)


def test_vitb_width_two_blocks_matches_jax():
    jcfg, tcfg = _cut(JAX_MODELS), _cut(MODELS)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = _jax_params(jmodel, 98)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    x = np.random.RandomState(0).rand(2, 98, 98, 3).astype(np.float32)
    jdepth, jfeat = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        depth, feat = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, ref in ((depth.numpy(), np.asarray(jdepth)), (feat.numpy(), np.asarray(jfeat))):
        assert got.shape == ref.shape
        err = np.abs(got.astype(np.float64) - ref)
        assert np.all(err <= 5e-5 * (1 + np.abs(ref))), err.max()
