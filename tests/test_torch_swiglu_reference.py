"""The port's SwiGLU model (the ``depthanything-giant`` family) against the
benchmark's plain reference ``portbench/reference/dinov2_swiglu_dpt``, fp32
on the CPU, on the weights the benchmark draws for it; and the SwiGLU's
program spans and counter (``models/vit.SwiGLU``).

A tiny preset of the giant model: width 96, 4 blocks, two heads, taps after
every block, DPT features 32 and out channels 24-96; the SwiGLU FFN (hidden
256), LayerScale, the student head and kernel 2's route are the preset's.
Tolerance 1e-5 relative: both sides compute in float32 with the same
arithmetic, so they differ by summation order alone.
"""
import dataclasses

import pytest
import torch

from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.utils import profiling
from portbench import inputs
from portbench.reference import dinov2_swiglu_dpt as ref

TOL = 1e-5
SEED = 2 ** 31 + 19
CFG = dataclasses.replace(
    MODELS["depthanything-giant"],
    encoder=dataclasses.replace(MODELS["depthanything-giant"].encoder, embed_dim=96, depth=4,
                                num_heads=2, out_indices=(0, 1, 2, 3)),
    features=32, out_channels=(24, 48, 96, 96))
ENTRY = {"reference": "dinov2_swiglu_dpt", "preset": "depthanything-giant", "embed_dim": 96,
         "depth": 4, "num_heads": 2, "mlp_ratio": 4.0, "ffn": "swiglu", "base_img_size": 518,
         "out_indices": [0, 1, 2, 3], "interpolate_offset": 0.1, "layerscale_init": 1.0,
         "features": 32, "out_channels": [24, 48, 96, 96], "trailing_head_relu": True,
         "interp_to_input": False}
HIDDEN = 256


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(weights, cfg=CFG):
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict(weights, strict=True)
    return model


def _gap(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _images():
    return torch.randn(2, 3, 56, 70, generator=torch.Generator().manual_seed(7))


def _swap_w12_halves(weights):
    out = dict(weights)
    for name, w in weights.items():
        if ".mlp.w12." in name:
            x1, x2 = w.chunk(2, dim=0)
            out[name] = torch.cat([x2, x1])
    return out


def _port_and_reference(weights):
    model, x = _model(weights), _images()
    drawn = inputs.make_weights(ENTRY, SEED, "teacher", "cpu")
    with torch.no_grad():
        depth, _ = model(x)
        taps, _ = model.pretrained(x)
        ref_depth, _ = ref.depth_forward(drawn, ENTRY, x)
        ref_taps = ref.encoder_forward(drawn, ENTRY, x)
    return depth, taps, ref_depth, ref_taps


def test_hidden_width_is_dinov2s():
    assert ref.hidden_width(ENTRY) == HIDDEN
    assert ref.hidden_width({**ENTRY, "embed_dim": 1536}) == 4096
    with pytest.raises(ValueError, match="swiglu"):
        ref.hidden_width({**ENTRY, "ffn": "mlp"})


def test_port_matches_the_reference():
    depth, taps, ref_depth, ref_taps = _port_and_reference(
        inputs.make_weights(ENTRY, SEED, "teacher", "cpu"))
    assert depth.shape == ref_depth.shape == (2, 56, 70)
    assert _gap(depth, ref_depth) < TOL
    for tap, ref_tap in zip(taps, ref_taps, strict=True):
        assert tap.shape == ref_tap.shape == (2, 20, 96)
        assert _gap(tap, ref_tap) < TOL


def test_swapped_w12_halves_fail_by_orders_of_magnitude():
    """A planted fault: x1 and x2 trade places in every block."""
    depth, taps, ref_depth, ref_taps = _port_and_reference(
        _swap_w12_halves(inputs.make_weights(ENTRY, SEED, "teacher", "cpu")))
    assert _gap(depth, ref_depth) > 100 * TOL
    assert min(_gap(t, r) for t, r in zip(taps, ref_taps)) > 100 * TOL


def test_swiglu_spans_and_counter():
    model, x = _model(inputs.make_weights(ENTRY, SEED, "teacher", "cpu")), _images()
    with torch.no_grad(), profiling.recording() as rec:
        model(x)
    names = [s.name for s in rec.spans]
    assert names.count("vit/swiglu") == names.count("vit/swiglu_gate") == 4
    assert {s.parent for s in rec.spans if s.name == "vit/swiglu_gate"} == {"vit/swiglu"}
    rows = 2 * (4 * 5 + 1)  # images x (patch grid + cls)
    assert rec.counts == {"vit/swiglu_gate_bytes": 4 * rows * 3 * HIDDEN * 4}
    with torch.no_grad():
        model(x)
    assert len(rec.spans) == len(names) and len(rec.counted) == 4


def test_an_mlp_model_records_no_swiglu_span():
    cfg = dataclasses.replace(CFG, encoder=dataclasses.replace(CFG.encoder, ffn="mlp"))
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    with torch.no_grad(), profiling.recording() as rec:
        model(_images())
    assert not [s for s in rec.spans if s.name.startswith("vit/")]
    assert "vit/swiglu_gate_bytes" not in rec.counts
