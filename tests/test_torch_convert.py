"""``params_from_jax`` against the JAX package's ``params_to_torch``: the
same keys and equal arrays, and a strict ``load_state_dict`` into the
port's model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.utils.torch_interop import params_to_torch
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.models.vit import QuantLinear
from distill_any_depth_tpu_torch.utils.convert import params_from_jax


def _jax_params(jmodel, size: int) -> dict:
    x = jnp.zeros((1, size, size, 3))
    return jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)["params"])


def _tiny(models, arch, **head):
    cfg = models[arch]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(16, 32, 48, 64),
                               **head)


@pytest.mark.parametrize("arch,head", [
    ("depthanything-base", {}),
    ("depthanything-large", {"use_clstoken": True}),  # LayerScale 1e-5, cls readout
    ("depthanything-base-window", {}),  # PEG conv, no cls token, 224-based pos-embed
    ("depthanything-giant", {}),  # SwiGLU: mlp.w12, mlp.w3
    ("depthanything-large-reg", {}),  # register tokens
    ("depthanything-giant-reg", {}),  # registers, SwiGLU, pre-norm taps
])
def test_params_from_jax_matches_params_to_torch(arch, head):
    jcfg, tcfg = _tiny(JAX_MODELS, arch, **head), _tiny(MODELS, arch, **head)
    params = _jax_params(jax_create_model(jcfg), 56)
    want = params_to_torch(params, jcfg)
    got = params_from_jax(params, tcfg)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)

    model = create_model(tcfg, device="cpu")
    missing, unexpected = model.load_state_dict(got, strict=True)
    assert not missing and not unexpected
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_params_from_jax_serves_quantized_models(quant):
    """``QuantDense`` declares ``nn.Dense``'s params, so ``params_from_jax``
    needs nothing new: a JAX int8 model's params map to the same state dict
    as the unquantized model's, which the port's int8 model loads with
    ``strict=True``."""
    jcfg, tcfg = _tiny(JAX_MODELS, "depthanything-large"), _tiny(MODELS, "depthanything-large")
    want = params_from_jax(_jax_params(jax_create_model(jcfg), 56), tcfg)
    got = params_from_jax(_jax_params(jax_create_model(jcfg, quant=quant), 56), tcfg)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr.numpy(), err_msg=key)
    model = create_model(tcfg, device="cpu", quant=quant)
    missing, unexpected = model.load_state_dict(got, strict=True)
    assert not missing and not unexpected
    block = model.pretrained.blocks[0]
    assert all(isinstance(m, QuantLinear) for m in (block.attn.qkv, block.attn.proj,
                                                    block.mlp.fc1, block.mlp.fc2))


def test_unknown_param_raises():
    with pytest.raises(KeyError, match="unmapped"):
        params_from_jax({"pretrained": {"mask_token": np.zeros((1, 64))}},
                        MODELS["depthanything-base"])
