"""The port's windowed model (``depthanything-base-window``) against the
benchmark's plain reference ``portbench/reference/dinov2_window_dpt``, fp32
on the CPU, on the weights the benchmark draws for it; the live pairs that
``ops/window.window_pairs`` counts; and the windowed path's program spans
and counters (``models/vit.PosConv``, ``models/vit.Attention``).

A tiny preset of the windowed teacher: width 128, 2 blocks, two heads, DPT
features 32 and out channels 16-128; the window (7), the PEG conv, no cls
token, the final-layer taps and the teacher head (no trailing ReLU, the
depth resized to the input) are the preset's. Three grids: 12 x 16 (larger
than the window, so the border windows clamp; the biased route), 5 x 5
(smaller than the window: the whole axis) and 12 x 16 on the banded route
(the token threshold lowered, as ``tests/test_torch_window.py`` does).
Tolerance 1e-5 relative: both sides compute in float32 with the same
arithmetic, so they differ by summation order alone.
"""
import dataclasses

import pytest
import torch

from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.ops.window import local_window_bias, window_pairs
from distill_any_depth_tpu_torch.utils import profiling
from portbench import inputs
from portbench.reference import dinov2_window_dpt as ref

TOL = 1e-5
SEED = 2 ** 31 + 23
WINDOW = MODELS["depthanything-base-window"]
CFG = dataclasses.replace(
    WINDOW, encoder=dataclasses.replace(WINDOW.encoder, embed_dim=128, depth=2, num_heads=2),
    features=32, out_channels=(16, 32, 64, 128))
ENTRY = {"reference": "dinov2_window_dpt", "preset": "depthanything-base-window",
         "embed_dim": 128, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "base_img_size": 224,
         "window_size": 7, "use_pos_conv": True, "use_cls_token": False, "final_taps": True,
         "layerscale_init": 1.0, "features": 32, "out_channels": [16, 32, 64, 128],
         "trailing_head_relu": False, "interp_to_input": True}
GRIDS = {"clamped": (12, 16, False), "whole_axis": (5, 5, False), "banded": (12, 16, True)}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg=CFG):
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict(inputs.make_weights(ENTRY, SEED, "teacher", "cpu"), strict=True)
    return model


def _gap(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _images(gh, gw):
    return torch.randn(2, 3, 14 * gh, 14 * gw, generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_port_matches_the_reference(grid, monkeypatch):
    gh, gw, banded = GRIDS[grid]
    if banded:
        monkeypatch.setattr(fa, "_BANDED_MIN_SEQ", 0)
    model, x = _model(), _images(gh, gw)
    assert fa.banded_eligible(gh * gw, (gw, 7)) == banded
    weights = inputs.make_weights(ENTRY, SEED, "teacher", "cpu")
    with torch.no_grad():
        depth, _ = model(x)
        taps, _ = model.pretrained(x)
        ref_depth, _ = ref.depth_forward(weights, ENTRY, x)
        ref_taps = ref.encoder_forward(weights, ENTRY, x)
    assert depth.shape == ref_depth.shape == (2, 14 * gh, 14 * gw)
    assert _gap(depth, ref_depth) < TOL
    for tap, ref_tap in zip(taps, ref_taps, strict=True):
        assert tap.shape == ref_tap.shape == (2, gh * gw, 128)
        assert _gap(tap, ref_tap) < TOL


@pytest.mark.parametrize("gh, gw", [(12, 16), (5, 5), (74, 74)])
def test_the_reference_mask_is_the_ports_window(gh, gw):
    """The reference builds its mask itself; it is ``ops/window``'s bias."""
    live = ref.window_mask(gh, gw, 7)
    assert torch.equal(live, local_window_bias(gh, gw, 7, 0) == 0)
    assert int(live.sum()) == window_pairs(gh, gw, 7)


@pytest.mark.parametrize("gh, gw, window, n_prefix", [
    (12, 16, 7, 0), (5, 5, 7, 0), (74, 74, 7, 0), (7, 12, 3, 1), (5, 4, 7, 1), (10, 3, 5, 5),
])
def test_window_pairs_counts_the_bias(gh, gw, window, n_prefix):
    bias = local_window_bias(gh, gw, window, n_prefix)
    assert window_pairs(gh, gw, window, n_prefix) == int((bias == 0).sum())


def test_window_spans_and_counters():
    model, x = _model(), _images(12, 16)
    with torch.no_grad(), profiling.recording() as rec:
        model(x)
    names = [s.name for s in rec.spans]
    assert names.count("vit/pos_conv") == 1 and names.count("vit/window_attention") == 2
    # 2 images x 128 channels x 37^2 taps x 12 x 16 pixels, two operations a tap
    # 2 blocks x 2 images x 2 heads x (12 rows x 7) x (16 columns x 7) live pairs
    assert rec.counts == {"vit/pos_conv_flops": 2 * 2 * 128 * 37 * 37 * 12 * 16,
                          "vit/window_pairs": 2 * 2 * 2 * (12 * 7) * (16 * 7)}
    with torch.no_grad(), profiling.recording() as rec:
        model(_images(5, 5))
    assert rec.counts["vit/window_pairs"] == 2 * 2 * 2 * 25 * 25  # every pair of the grid


def test_a_global_model_records_no_window_span():
    base = MODELS["depthanything-base"]
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, embed_dim=64, depth=2, num_heads=1,
                                          out_indices=(0, 1, 1, 1)),
        features=16, out_channels=(8, 16, 32, 64))
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    with torch.no_grad(), profiling.recording() as rec:
        model(_images(4, 5))
    assert not [s for s in rec.spans if s.name.startswith("vit/")]
    assert not [k for k in rec.counts if k.startswith("vit/")]
