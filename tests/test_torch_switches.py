"""The port's attention and fused-tail switches, the point cloud and PLY
writer, and the HDN demo, against the JAX package on the CPU.

- ``attn_impl="reference"``: the port's model against the JAX
  ``create_model(..., attn_impl="reference")`` on the same weights, plain
  and windowed (dense bias and band): |err| <= 1e-5 * (1 + |ref|); the
  attention wrappers are not called; an unknown ``impl`` raises
  ``ValueError`` as the JAX function does.
- ``resolve_fused_tail`` maps bools, "on" and "off" as the JAX function;
  "auto" is on (kernel 2 on the card).
- ``--fused_tail off`` through ``cli.infer`` and ``cli.pseudo_label`` equals
  ``on`` within 1e-5 (the plain chain against the tail's plain version,
  whose resizes are built in another precision).
- The four ``TrainConfig`` fields of this slice default as in JAX.
- ``depth_to_point_cloud`` and ``write_ply``: the JAX arrays and bytes.
- ``cli.hdn_demo.main(size=64)`` on the CPU against the JAX demo at 1e-5
  relative.
"""
import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.cli import hdn_demo as jax_hdn_demo
from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.configs import TrainConfig as JTrainConfig
from distill_any_depth_tpu.models import factory as jax_factory
from distill_any_depth_tpu.ops import flash_attention as jax_fa
from distill_any_depth_tpu.utils import image_util as jax_image_util
from distill_any_depth_tpu_torch.cli import hdn_demo, infer, pseudo_label
from distill_any_depth_tpu_torch.configs import MODELS, TrainConfig
from distill_any_depth_tpu_torch.models import factory
from distill_any_depth_tpu_torch.ops import attention
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.utils import image_util
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
CASES = {"plain": ("depthanything-base", 56), "window": ("depthanything-base-window", 126),
         "window_banded": ("depthanything-base-window", 126)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(models, preset: str):
    cfg = models[preset]
    window = {"window_size": 3} if cfg.encoder.window_size else {}
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 1, 1, 1), **window)
    return dataclasses.replace(cfg, encoder=enc, features=32, out_channels=(16, 32, 48, 64))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_attention_matches_jax(monkeypatch, case):
    preset, size = CASES[case]
    if case == "window_banded":
        monkeypatch.setattr(jax_fa, "_BANDED_MIN_SEQ", 0)
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)

    def refused(*args, **kwargs):
        raise AssertionError("attn_impl='reference' reached a kernel wrapper")

    monkeypatch.setattr(attention, "mha_flash_packed", refused)
    monkeypatch.setattr(attention, "mha_flash_qkv", refused)
    jmodel = jax_factory.create_model(_tiny(JAX_MODELS, preset), attn_impl="reference")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    model = factory.create_model(_tiny(MODELS, preset), device="cpu", attn_impl="reference")
    model.load_state_dict(params_from_jax(params, _tiny(MODELS, preset)), strict=True)
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x))[0], np.float64)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy().astype(np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * (1 + np.abs(want))), np.abs(got - want).max()


def test_unknown_attention_impl_raises():
    qkv = torch.zeros(1, 5, 3 * 64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.multi_head_attention_packed(qkv, 1, impl="pallas")
    model = factory.create_model(_tiny(MODELS, "depthanything-base"), device="cpu",
                                 attn_impl="pallas")
    with pytest.raises(ValueError, match="unknown attention impl"):
        model(torch.zeros(1, 3, 28, 28))


@pytest.mark.parametrize("mode", [True, False, "on", "off"])
def test_resolve_fused_tail_maps_as_jax(mode):
    assert factory.resolve_fused_tail(mode) == jax_factory.resolve_fused_tail(mode)


def test_resolve_fused_tail_auto_is_on():
    # the JAX package's "auto" is on where its kernel runs natively (a TPU);
    # the port's kernel is the card's, and the CPU runs its plain version
    assert factory.resolve_fused_tail("auto") is True
    assert factory.resolve_fused_tail(None) is True


@pytest.fixture(scope="module")
def smoke_images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    for name in ("000_colors.png", "001_colors.png"):
        shutil.copy(ROOT / "data" / "smoke" / "imgs" / name, d / name)
    return d


@pytest.mark.parametrize("cli", ["infer", "pseudo_label"])
def test_fused_tail_off_equals_on(tmp_path, smoke_images, cli):
    outs = {}
    for mode in ("on", "off"):
        out = tmp_path / mode
        common = ["--device", "cpu", "--arch_name", "depthanything-small", "--input",
                  str(smoke_images), "--output_dir", str(out), "--dtype", "float32",
                  "--fused_tail", mode, "--processing_res", "56"]
        if cli == "infer":
            infer.main(common + ["--save_npy"])
            files = sorted((out / "image_logs").glob("*.npy"))
        else:
            pseudo_label.main(common)
            files = sorted(out.glob("*_depth.npy"))
        outs[mode] = [np.load(f) for f in files]
    assert len(outs["on"]) == len(outs["off"]) == 2
    for a, b in zip(outs["on"], outs["off"]):
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL * (1 + np.abs(a).max()))


def test_train_config_new_defaults_equal_jax():
    ours, theirs = TrainConfig(), JTrainConfig()
    for field in ("teacher_fused_tail", "use_native_loader", "student_remat", "attn_impl"):
        assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("extras", ["plain", "color_mask", "float_color"])
def test_point_cloud_and_ply_equal_jax(tmp_path, extras):
    rng = np.random.RandomState(0)
    depth = rng.rand(4, 6).astype(np.float32) * 5
    kw = dict(fx=3.0, fy=2.5)
    if extras == "color_mask":
        kw.update(rgb=rng.randint(0, 255, (4, 6, 3)).astype(np.uint8),
                  mask=rng.rand(4, 6) > 0.3, cx=2.0)
    elif extras == "float_color":
        kw.update(rgb=rng.rand(4, 6, 3), cy=1.0)
    pts, colors = image_util.depth_to_point_cloud(depth, **kw)
    jpts, jcolors = jax_image_util.depth_to_point_cloud(depth, **kw)
    assert pts.dtype == jpts.dtype and np.array_equal(pts, jpts)
    assert (colors is None) == (jcolors is None)
    if colors is not None:
        assert np.array_equal(colors, jcolors)
    image_util.write_ply(str(tmp_path / "port.ply"), pts, colors)
    jax_image_util.write_ply(str(tmp_path / "jax.ply"), jpts, jcolors)
    text = (tmp_path / "port.ply").read_bytes()
    assert text == (tmp_path / "jax.ply").read_bytes()
    assert f"element vertex {len(pts)}".encode() in text


def test_hdn_demo_matches_jax(capsys):
    ours = hdn_demo.main(size=64, batch=2, seed=0, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    theirs = jax_hdn_demo.main(size=64, batch=2, seed=0)
    assert set(ours) == set(theirs) == {"dr", "dp", "ds"}
    assert printed == [f"hdn_{k}: {ours[k]:.6f}" for k in ("dr", "dp", "ds")]
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=TOL, err_msg=k)
