"""The port's checkpoint loader (``utils/checkpoint``) against the JAX
package's ``torch_to_params``, on safetensors files written from JAX
``params_to_torch`` of seeded params: both load the same files and refuse
the same files."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.utils.torch_interop import load_safetensors_params, params_to_torch
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file

SIZE = 56


def _tiny(models):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


@pytest.fixture(scope="module")
def reference_state() -> dict:
    """The reference-layout state dict of seeded JAX params."""
    jcfg = _tiny(JAX_MODELS)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    params = jax.jit(jax_create_model(jcfg).init)(jax.random.PRNGKey(3), x)["params"]
    sd = params_to_torch(jax.tree_util.tree_map(np.asarray, params), jcfg)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def _write(tmp_path, name: str, state: dict) -> str:
    path = str(tmp_path / f"{name}.safetensors")
    save_file(state, path)
    return path


def _port_depth(path: str) -> torch.Tensor:
    model = create_model(_tiny(MODELS), device="cpu")
    load_state_dict_file(model, path)
    x = torch.rand(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model(x)[0]


@pytest.mark.parametrize("prefix", ["pretrained.blocks.0.", "backbone.blocks.0."])
def test_chunked_block_keys_load(tmp_path, reference_state, prefix):
    """Block keys in the chunked namespace (``blocks.0.{i}``, under either
    prefix) load, and the forward equals that of the plain keys."""
    chunked = {re.sub(r"^pretrained\.blocks\.(\d+)\.", rf"{prefix}\1.", k): v
               for k, v in reference_state.items()}
    assert sum(k.startswith(prefix) for k in chunked) > 0
    want = _port_depth(_write(tmp_path, "plain", reference_state))
    got = _port_depth(_write(tmp_path, "chunked", chunked))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unused_reference_keys_load_in_both(tmp_path, reference_state):
    """``pretrained.mask_token`` and ``refinenet4.resConfUnit1.*`` (a unit
    refinenet4 does not have): ``torch_to_params`` maps them, the port drops
    them, and the forward equals that of the file without them."""
    gen = torch.Generator().manual_seed(1)
    extra = {"pretrained.mask_token": torch.randn(1, 64, generator=gen)}
    for conv in ("conv1", "conv2"):
        base = f"depth_head.scratch.refinenet4.resConfUnit1.{conv}"
        extra[f"{base}.weight"] = torch.randn(32, 32, 3, 3, generator=gen)
        extra[f"{base}.bias"] = torch.randn(32, generator=gen)
    path = _write(tmp_path, "extra", {**reference_state, **extra})
    load_safetensors_params(path, _tiny(JAX_MODELS), strict=True)
    torch.testing.assert_close(_port_depth(path),
                               _port_depth(_write(tmp_path, "plain", reference_state)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("change", ["unknown key", "missing key"])
def test_foreign_or_missing_keys_raise(tmp_path, reference_state, change):
    """A key neither package maps raises in both; a missing key raises in
    the port (JAX ``torch_to_params`` only finds out when the model runs)."""
    if change == "unknown key":
        state = {**reference_state, "depth_head.foo.weight": torch.zeros(4, 4)}
        path = _write(tmp_path, "foreign", state)
        with pytest.raises(KeyError, match="unmapped"):
            load_safetensors_params(path, _tiny(JAX_MODELS), strict=True)
        match = "unmapped"
    else:
        state = {k: v for k, v in reference_state.items() if k != "pretrained.norm.weight"}
        path = _write(tmp_path, "missing", state)
        match = "lacks"
    with pytest.raises(KeyError, match=match):
        _port_depth(path)
