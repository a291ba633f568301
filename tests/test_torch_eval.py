"""The port's evaluation (``eval/metrics``, ``eval/evaluate``,
``cli.evaluate``) and its data (``data/registry``, ``NYUDataset(raw_255)``,
``Resize.get_size``, ``read_pfm``, ``colorize_depth_maps``) against the JAX package on the CPU, on
the same seeded inputs and weights (``params_from_jax``).

Tolerances: ``batched_depth_metrics`` 1e-6 relative of float64 arithmetic
and 3e-6 of JAX's (fp32 reductions in another order). ``evaluate_model`` and ``cli.evaluate``: the two forwards
agree to fp32 rounding, which moves the continuous metrics by up to 7.6e-7
relative here (limit 3e-6) and could flip a pixel across a delta threshold
(none did; limit: one pixel in 1000 of a sample's valid pixels). The
datasets and PFM files are equal bit for bit.
"""
import argparse
import dataclasses
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu import configs as jax_configs
from distill_any_depth_tpu.cli import evaluate as jax_evaluate_cli
from distill_any_depth_tpu.data import registry as jax_registry
from distill_any_depth_tpu.data.nyu import NYUDataset as JaxNYUDataset
from distill_any_depth_tpu.data.transforms import Resize as JaxResize
from distill_any_depth_tpu.eval import evaluate as jax_evaluate
from distill_any_depth_tpu.eval import metrics as jax_metrics
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.utils import image_util as jax_image_util
from distill_any_depth_tpu.utils.checkpoint import save_safetensors as jax_save_safetensors
from distill_any_depth_tpu_torch import configs
from distill_any_depth_tpu_torch.cli import evaluate as evaluate_cli
from distill_any_depth_tpu_torch.data import registry
from distill_any_depth_tpu_torch.data.nyu import NYUDataset
from distill_any_depth_tpu_torch.data.transforms import Resize
from distill_any_depth_tpu_torch.eval import evaluate, metrics
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.utils import image_util
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

SIZE = 56
ARCH = "tiny-eval"
CONTINUOUS = ("abs_rel", "abs_diff", "sq_rel", "rmse", "rmse_log")
METRIC_RTOL, DELTA_ATOL = 3e-6, 1e-3


def _tiny(models):
    cfg = models["depthanything-small"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    return dataclasses.replace(cfg, arch_name=ARCH, encoder=enc, features=32,
                               out_channels=(16, 32, 48, 64))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models here on one thread: Tier-1 runs several test files at
    once, and torch's default of a thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The tiny JAX model and params, and the port's model with the same
    weights (its DPT tail through the kernel wrapper's plain version)."""
    jcfg = _tiny(jax_configs.MODELS)
    jmodel = jax_create_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    model = create_model(_tiny(configs.MODELS), device="cpu")
    model.load_state_dict(params_from_jax(params, _tiny(configs.MODELS)), strict=True)
    return jmodel, params, model


def _assert_metrics_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) == set(metrics.METRIC_KEYS)
    for k in CONTINUOUS:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    for k in ("a1", "a2", "a3"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=DELTA_ATOL, err_msg=k)


def _float64_metrics(pred: np.ndarray, gt: np.ndarray) -> dict:
    """The aligned metrics of each valid sample in float64, with the 1e-12
    guards (zero predictions)."""
    out = {k: [] for k in metrics.METRIC_KEYS}
    for p, t in zip(pred.astype(np.float64), gt.astype(np.float64)):
        m = t > 0
        if not m.any():
            continue
        p = p * (t[m].mean() / max(p[m].mean(), 1e-12))
        p, t = p[m], t[m]
        sp = np.maximum(p, 1e-12)
        thresh, d = np.maximum(t / sp, p / t), t - p
        for k, v in (("abs_rel", np.abs(d) / t), ("abs_diff", np.abs(d)), ("sq_rel", d * d / t),
                     ("rmse", d * d), ("rmse_log", (np.log(t) - np.log(sp)) ** 2),
                     ("a1", thresh < 1.25), ("a2", thresh < 1.25**2), ("a3", thresh < 1.25**3)):
            out[k].append(np.sqrt(v.mean()) if k.startswith("rmse") else v.mean())
    return {k: np.array(v) for k, v in out.items()}


def test_batched_depth_metrics_match_jax():
    """Random predictions and depths with zeroed pixels, one sample all
    invalid: the same valid flags; every metric of every valid sample
    within 1e-6 relative of float64 arithmetic (reading 3.1e-7), and within
    3e-6 of JAX's, whose fp32 sums read 1.4e-6 from float64 here (sq_rel;
    the two packages reduce in another order)."""
    rng = np.random.RandomState(0)
    pred = rng.rand(4, 24, 32).astype(np.float32) + 0.05
    gt = rng.rand(4, 24, 32).astype(np.float32) * 10
    gt[gt < 3] = 0.0
    gt[2] = 0.0
    pred[1, :4] = 0.0  # zero predictions hit the 1e-12 guards
    want, want_valid = jax_metrics.batched_depth_metrics(pred, gt)
    got, valid = metrics.batched_depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert valid.tolist() == [True, True, False, True]
    exact = _float64_metrics(pred, gt)
    for k in metrics.METRIC_KEYS:
        assert got[k].dtype == torch.float32 and got[k].shape == (4,)
        np.testing.assert_allclose(got[k].numpy()[valid], exact[k], rtol=1e-6, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=3e-6, atol=0, err_msg=k)
    one = metrics.compute_depth_metrics(pred[0], gt[0])
    assert one == jax_metrics.compute_depth_metrics(pred[0], gt[0])


@pytest.mark.parametrize("gt_hw", [(SIZE, SIZE), (70, 98)], ids=["square", "gt_larger"])
def test_evaluate_model_matches_jax(models, gt_hw):
    """Two batches of 2, the ground truth on the prediction's grid or on a
    larger one (the prediction upsampled, bilinear, align_corners=False)."""
    jmodel, params, model = models
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(2):
        depth = rng.rand(2, *gt_hw).astype(np.float32) * 5
        depth[depth < 1] = 0.0
        batches.append({"image": rng.randn(2, SIZE, SIZE, 3).astype(np.float32), "depth": depth})
    want = jax_evaluate.evaluate_model(jmodel, params, iter(batches))
    got = evaluate.evaluate_model(model, iter(batches))
    _assert_metrics_close(got, want)
    assert all(np.isfinite(v) for v in got.values())
    both = evaluate.compare_models(model, model, lambda: iter(batches))
    assert both["model_a"] == both["model_b"] == got


def test_upsample_matches_interpolate():
    """The evaluation upsample equals ``F.interpolate`` (bilinear,
    align_corners=False) up to its fp32 source coordinates: about in_size *
    2^-24 per weight (ROADMAP.md's resize-coordinate fact), 5.8e-6 for 98
    columns of values in [0, 1); limit 1e-5 absolute."""
    x = torch.rand(2, 28, 98, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(x[:, None], size=(352, 1216), mode="bilinear",
                                           align_corners=False)[:, 0]
    torch.testing.assert_close(evaluate.upsample_to(x, (352, 1216)), want, rtol=0, atol=1e-5)


def _write_rgb(path, h, w, seed=0):
    cv2.imwrite(str(path), np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8))


def _kitti_layout(root, n=2):
    """uint16 / 256 depth at 375x1242 (the KB crop applies), sparse, as the
    JAX package's registry tests write it."""
    (root / "kitti").mkdir(parents=True)
    rng = np.random.RandomState(1)
    lines = []
    for i in range(n):
        _write_rgb(root / f"rgb_{i}.png", 375, 1242, seed=i)
        d = np.zeros((375, 1242), np.uint16)
        yy, xx = rng.randint(0, 375, 2000), rng.randint(0, 1242, 2000)
        d[yy, xx] = rng.randint(256, 20000, 2000)
        cv2.imwrite(str(root / f"depth_{i}.png"), d)
        lines.append(f"rgb_{i}.png depth_{i}.png")
    (root / "kitti" / "eigen_test_files_with_gt.txt").write_text(
        "# synthetic kitti\n" + "\n".join(lines) + "\n")
    return str(root)


def _eth3d_diode_layout(root):
    """An extensionless raw f32 depth (one inf), a ``.pfm`` and a ``.npy``."""
    rng = np.random.RandomState(0)
    d = rng.rand(6, 8).astype("<f4") * 10
    d[0, 0] = np.inf
    (root / "d0.bin").write_bytes(d.tobytes())
    jax_image_util.write_pfm(str(root / "d1.pfm"), rng.rand(6, 8).astype(np.float32) * 5)
    np.save(root / "d2.npy", rng.rand(6, 8).astype(np.float32) * 100)
    for i in range(3):
        _write_rgb(root / f"r{i}.png", 6, 8, seed=i)
    (root / "list.txt").write_text("r0.png d0.bin\nr1.png d1.pfm\nr2.png d2.npy\n")
    (root / "list_diode.txt").write_text("r2.png d2.npy\nr0.png d2.npy\n")
    return str(root)


def _spec(module, name):
    if name == "eth3d":
        return module.DatasetSpec(name="eth3d", disp_name="x", filenames="list.txt",
                                  min_depth=1e-5, max_depth=np.inf, raw_depth_shape=(6, 8))
    return module.DatasetSpec(name="diode", disp_name="x", filenames="list.txt",
                              min_depth=0.6, max_depth=350.0)


@pytest.mark.parametrize("case", ["kitti_native", "kitti_square", "kitti_garg", "eth3d",
                                  "diode"])
def test_file_list_dataset_matches_jax(tmp_path, case):
    """Every sample (image, depth, path) equal bit for bit."""
    if case.startswith("kitti"):
        root = _kitti_layout(tmp_path)
        kw = {"kitti_native": {}, "kitti_square": {"native_resolution": False},
              "kitti_garg": {"valid_mask_crop": "garg"}}[case]
        want = jax_registry.FileListDataset("kitti", root, image_size=SIZE, **kw)
        got = registry.FileListDataset("kitti", root, image_size=SIZE, **kw)
    else:
        root = _eth3d_diode_layout(tmp_path)
        kw = {"filenames": f"{root}/list_diode.txt"} if case == "diode" else {}
        want = jax_registry.FileListDataset(_spec(jax_registry, case), root, image_size=28, **kw)
        got = registry.FileListDataset(_spec(registry, case), root, image_size=28, **kw)
    assert len(got) == len(want) > 1
    for i in range(len(want)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.image.dtype == b.image.dtype and a.depth.dtype == b.depth.dtype
        assert a.rgb_path == b.rgb_path
    if case == "kitti_native":
        assert got[0].image.shape == (SIZE, 196, 3) and got[0].depth.shape == (352, 1216)
    assert sorted(registry.DATASETS) == sorted(jax_registry.DATASETS)
    for name in jax_registry.DATASETS:
        assert dataclasses.asdict(registry.get_spec(name)) == dataclasses.asdict(
            jax_registry.get_spec(name))


@pytest.mark.parametrize("shape", [(6, 8), (5, 7, 3)], ids=["gray", "color"])
def test_pfm_matches_jax(tmp_path, shape):
    """The two writers give the same file; each reader reads the other's."""
    image = np.random.RandomState(3).rand(*shape).astype(np.float32)
    image_util.write_pfm(str(tmp_path / "port.pfm"), image, scale=2.0)
    jax_image_util.write_pfm(str(tmp_path / "jax.pfm"), image, scale=2.0)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
    got, scale = image_util.read_pfm(str(tmp_path / "jax.pfm"))
    want, want_scale = jax_image_util.read_pfm(str(tmp_path / "port.pfm"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, image)
    assert scale == want_scale == 2.0


@pytest.mark.parametrize("cmap", ["Spectral_r", "Spectral", "viridis"])
def test_colorize_matches_jax(cmap):
    """The port's own table for Spectral and Spectral_r (the CLIs' default,
    which must run where matplotlib is absent) and matplotlib for the rest:
    equal bit for bit to the JAX package's colorize, NaN included."""
    depth = np.random.RandomState(5).rand(2, 1, 30, 40).astype(np.float32) * 3 - 1
    depth[0, 0, 0, :4] = [0.0, 1.0, 0.5, np.nan]
    np.testing.assert_array_equal(image_util.colorize_depth_maps(depth, 0, 1, cmap=cmap),
                                  jax_image_util.colorize_depth_maps(depth, 0, 1, cmap=cmap))


def test_resize_get_size_matches_jax():
    """Lower-bound sizes to a multiple of 14, keeping the aspect or not."""
    for keep in (True, False):
        port = Resize(392, 392, ensure_multiple_of=14, keep_aspect_ratio=keep)
        ref = JaxResize(392, 392, resize_target=False, keep_aspect_ratio=keep,
                        ensure_multiple_of=14, resize_method="lower_bound")
        for w, h in ((1216, 352), (640, 480), (8, 6), (6048, 4032), (392, 392), (100, 1000)):
            assert port.get_size(w, h) == ref.get_size(w, h), (keep, w, h)


def _nyu_layout(root, n=4):
    """``nyu2_test.csv`` with 80x64 RGB and uint16 depth PNGs."""
    rng = np.random.RandomState(4)
    rows = []
    for i in range(n):
        _write_rgb(root / f"rgb{i}.png", 64, 80, seed=10 + i)
        d = (rng.rand(64, 80) * 60000).astype(np.uint16)
        d[:5] = 0
        cv2.imwrite(str(root / f"dep{i}.png"), d)
        rows.append(f"rgb{i}.png,dep{i}.png")
    (root / "nyu2_test.csv").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("raw_255", [False, True], ids=["normalized", "raw_255"])
def test_nyu_dataset_matches_jax(tmp_path, monkeypatch, raw_255):
    _nyu_layout(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = JaxNYUDataset("test", dataset_dir=".", image_size=SIZE, raw_255=raw_255)
    got = NYUDataset("test", dataset_dir=".", image_size=SIZE, raw_255=raw_255)
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i].image, want[i].image)
        np.testing.assert_array_equal(got[i].depth, want[i].depth)
    assert (got[0].image.max() > 200) == raw_255


@pytest.mark.parametrize("dataset", ["nyu_csv", "kitti"])
def test_cli_matches_jax(tmp_path, monkeypatch, models, dataset):
    """``cli.evaluate --device cpu`` with a JAX-written checkpoint against
    JAX ``cli.evaluate`` on the same files (NYU CSV, and KITTI at its
    native resolution); the port writes ``report.txt`` and ``report.json``,
    and with ``--original_model_path`` (the same file) reports both models
    alike."""
    jmodel, params, _ = models
    monkeypatch.setitem(jax_configs.MODELS, ARCH, _tiny(jax_configs.MODELS))
    monkeypatch.setitem(configs.MODELS, ARCH, _tiny(configs.MODELS))
    weights = str(tmp_path / "w.safetensors")
    jax_save_safetensors(weights, params, _tiny(jax_configs.MODELS))
    if dataset == "nyu_csv":
        data = tmp_path / "nyu"
        data.mkdir()
        _nyu_layout(data)
        monkeypatch.chdir(data)
    else:
        data = tmp_path / "kitti_root"
        _kitti_layout(data, n=4)
    args = ["--arch_name", ARCH, "--model_path", weights, "--dataset", dataset,
            "--data_dir", str(data), "--image_size", str(SIZE), "--batch_size", "2"]
    want = jax_evaluate_cli.main(jax_evaluate_cli.argument_parser().parse_args(
        [*args, "--output", str(tmp_path / "jax" / "report.txt")]))
    out = tmp_path / "port" / "report.txt"
    got = evaluate_cli.main([*args, "--output", str(out), "--device", "cpu"])
    assert set(got) == set(want) == {"distilled"}
    _assert_metrics_close(got["distilled"], want["distilled"])
    assert "abs_rel" in out.read_text()
    assert json.loads(out.with_suffix(".json").read_text()) == got
    both = evaluate_cli.main(argparse.Namespace(
        **{**vars(evaluate_cli.argument_parser().parse_args(args)), "device": "cpu",
           "output": str(out), "original_model_path": weights}))
    assert both["original"] == both["distilled"] == got["distilled"]
