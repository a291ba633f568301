"""Preprocessing, ``predict`` and the CLI shell of the port, on the CPU.

``preprocess_on_device`` and ``predict`` are held against the JAX package
on the same uint8 images and weights (fp32). The port returns NCHW where
JAX returns NHWC. Tolerances are stated per test.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.ops.preprocess import preprocess_on_device as jax_preprocess
from distill_any_depth_tpu_torch.cli import infer
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model, resolve_device
from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device, snap_to_bucket
from distill_any_depth_tpu_torch.utils.convert import params_from_jax
from distill_any_depth_tpu_torch.utils.profiling import recording


def _images(n, h=60, w=80, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("target", [28, 98])
def test_preprocess_matches_jax(target):
    ims = np.stack(_images(2))
    got = preprocess_on_device(torch.from_numpy(ims), target)
    want = np.asarray(jax_preprocess(jnp.asarray(ims), target)).transpose(0, 3, 1, 2)
    assert got.shape == (2, 3, target, target) and got.dtype == torch.float32
    # fp32: torch computes the resize's source coordinates in fp32 (weights
    # off by up to ~in_size * 2**-24), JAX builds its matrix in fp64; the
    # ImageNet std (~0.22) scales that by ~4.4 on values in [-2.2, 2.7]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert preprocess_on_device(torch.from_numpy(ims), target, dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def test_snap_to_bucket():
    assert [snap_to_bucket(s) for s in (1, 196, 197, 392, 5000)] == [196, 196, 266, 392, 924]


def _tiny(models):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                              out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128))


def test_predict_matches_jax_forward():
    jcfg, tcfg = _tiny(JAX_MODELS), _tiny(MODELS)
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 98, 98, 3)))
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    ims = _images(3, 50, 70)
    # batch 2: the second batch is padded with a copy of its last image
    got = infer.predict(model, ims, 98, batch_size=2)
    x = jax_preprocess(jnp.asarray(np.stack(ims)), 98)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x)[0])
    assert got.shape == (3, 98, 98) and got.dtype == np.float32
    # fp32 through preprocessing and the whole model (see test_torch_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * (1 + np.abs(want).max()))


@pytest.fixture
def one_thread():
    """One torch thread, so that two forwards of one batch sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_predict_equals_per_batch_depths_stacked(one_thread):
    """``predict`` writes each batch's depth into one output: bit for bit the
    per-batch depths (the last batch padded) concatenated on the host."""
    model = create_model(_tiny(MODELS), device="cpu").eval()
    ims = _images(5, 50, 70, seed=5)
    got = infer.predict(model, ims, 56, batch_size=2)
    xs = torch.cat([preprocess_on_device(torch.from_numpy(im)[None], 56) for im in ims])
    preds = []
    with torch.no_grad():
        for i in range(0, 5, 2):
            chunk = xs[i : i + 2]
            n = chunk.shape[0]
            if n < 2:
                chunk = torch.cat([chunk, chunk[-1:]])
            preds.append(model(chunk)[0][:n].float().cpu().numpy())
    want = np.concatenate(preds)
    assert got.shape == (5, 56, 56) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_predict_returns_a_new_array_each_call(one_thread):
    """Two calls give arrays that share no memory; the first keeps its values
    through the second."""
    model = create_model(_tiny(MODELS), device="cpu").eval()
    first = infer.predict(model, _images(3, 50, 70, seed=6), 56, batch_size=2)
    kept = first.copy()
    second = infer.predict(model, _images(3, 50, 70, seed=7), 56, batch_size=2)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(first, kept)


def test_predict_windowed_matches_jax_forward():
    """The windowed teacher's head flags (no trailing ReLU, resize to the
    input) and the bias path through ``predict``, tiny: window 3 on a 7x7
    grid, JAX attention in interpret mode."""
    def tiny(models):
        cfg = models["depthanything-base-window"]
        enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                                  window_size=3)
        return dataclasses.replace(cfg, encoder=enc, features=64,
                                   out_channels=(32, 64, 96, 128))

    jcfg, tcfg = tiny(JAX_MODELS), tiny(MODELS)
    jmodel = jax_create_model(jcfg, attn_impl="flash")
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 98, 98, 3)))
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    ims = _images(3, 50, 70, seed=3)
    got = infer.predict(model, ims, 98, batch_size=2)
    x = jax_preprocess(jnp.asarray(np.stack(ims)), 98)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x)[0])
    assert got.shape == (3, 98, 98)
    # fp32 through preprocessing and the whole model (see test_torch_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * (1 + np.abs(want).max()))


def test_predict_vitb_392_on_cpu():
    """The slice's main path at full width on the CPU: depthanything-base,
    392^2, batch 2, fp32, plain attention and tail."""
    model = create_model("depthanything-base", device="cpu")
    assert model.dtype == torch.float32
    with recording() as rec:
        depth = infer.predict(model, _images(2, 48, 64, seed=1), 392, batch_size=2)
    assert depth.shape == (2, 392, 392) and np.isfinite(depth).all() and (depth >= 0).all()
    assert "kernels/attention" not in rec.counts and "kernels/tail" not in rec.counts


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("mode", ["device", "host", "native"])
def test_cli_writes_depth_maps(tmp_path, mode):
    cv2 = pytest.importorskip("cv2")
    inp = tmp_path / "in"
    inp.mkdir()
    for i, im in enumerate(_images(3, 56, 70, seed=2)):
        cv2.imwrite(str(inp / f"im{i}.png"), im)
    argv = ["--arch_name", "depthanything-small", "--input", str(inp),
            "--output_dir", str(tmp_path / "out"), "--dtype", "float32", "--device", "cpu",
            "--batch_size", "2", "--save_npy",
            "--processing_res", "0" if mode == "native" else "56"]
    if mode == "host":
        argv.append("--host_preprocess")
    written = infer.main(infer.argument_parser().parse_args(argv))
    assert len(written) == 3
    for path in written:
        assert os.path.exists(path)
        stem = os.path.basename(path)[len("depth_"):-len(".jpg")]
        disp = np.load(os.path.join(os.path.dirname(path), f"depth_{stem}.npy"))
        assert disp.shape == ((56, 70) if mode == "native" else (56, 56))
        assert np.isfinite(disp).all() and disp.min() >= 0 and disp.max() <= 1
        assert cv2.imread(path).shape[:2] == (56, 70)


def test_cli_windowed_teacher_at_native_resolution(tmp_path):
    """``--processing_res 0`` with the windowed teacher at full width: a
    non-square 4x5 grid, shorter than the window on both axes."""
    cv2 = pytest.importorskip("cv2")
    inp = tmp_path / "in"
    inp.mkdir()
    cv2.imwrite(str(inp / "im.png"), _images(1, 56, 70, seed=4)[0])
    argv = ["--arch_name", "depthanything-base-window", "--input", str(inp),
            "--output_dir", str(tmp_path / "out"), "--dtype", "float32", "--device", "cpu",
            "--save_npy", "--processing_res", "0"]
    (path,) = infer.main(infer.argument_parser().parse_args(argv))
    disp = np.load(os.path.join(os.path.dirname(path), "depth_im.npy"))
    assert disp.shape == (56, 70) and np.isfinite(disp).all()


@pytest.mark.parametrize("size", [(50, 70), (56, 70), (97, 131)])
def test_host_transforms_match_jax(size):
    """The CLI's host paths: the fixed-resolution chain and the native
    multiple-of-14 sizing, against the JAX package's transforms."""
    pytest.importorskip("cv2")
    from distill_any_depth_tpu.data.transforms import Resize as JaxResize
    from distill_any_depth_tpu.data.transforms import standard_transform as jax_standard
    from distill_any_depth_tpu_torch.data.transforms import Resize, standard_transform

    h, w = size
    im = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
    np.testing.assert_array_equal(standard_transform(98)({"image": im.copy()})["image"],
                                  jax_standard(98)({"image": im.copy()})["image"])
    got = Resize(w, h, ensure_multiple_of=14)({"image": im.copy()})["image"]
    want = JaxResize(w, h, resize_target=False, ensure_multiple_of=14)({"image": im.copy()})
    np.testing.assert_array_equal(got, want["image"])
