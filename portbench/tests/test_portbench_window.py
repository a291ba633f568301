"""The ``window-infer-1036`` cell: its files, its reference's place in the
harness, a tiny windowed cell through the ``infer`` driver on the CPU
(sound, with a planted fault, and with the port attending globally), the
cell's readers on a synthetic trace, and the counts of
``portbench/window_flops`` pinned by hand."""
from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch

from portbench import check, faults, flops, harness, spec, tracing, window_flops
from portbench.reference import dinov2_window_dpt
from portbench.tests import tiny

CELL = "window-infer-1036"
TINY_PRESET = "tiny-window"
TINY = {"reference": "dinov2_window_dpt", "preset": TINY_PRESET, "embed_dim": 128, "depth": 2,
        "num_heads": 2, "mlp_ratio": 4.0, "base_img_size": 224, "window_size": 7,
        "use_pos_conv": True, "use_cls_token": False, "final_taps": True,
        "layerscale_init": 1.0, "features": 32, "out_channels": [16, 32, 64, 128],
        "trailing_head_relu": False, "interp_to_input": True}
TINY_RES = 168  # a 12 x 12 grid: larger than the window


@pytest.fixture
def tiny_preset(monkeypatch):
    """A preset of the windowed teacher at ``TINY``'s sizes, under its own name."""
    from distill_any_depth_tpu_torch.configs import MODELS

    window = MODELS["depthanything-base-window"]
    enc = dataclasses.replace(window.encoder, embed_dim=128, depth=2, num_heads=2)
    monkeypatch.setitem(MODELS, TINY_PRESET,
                        dataclasses.replace(window, arch_name=TINY_PRESET, encoder=enc,
                                            features=32, out_channels=(16, 32, 64, 128)))


def test_the_cell_resolves_to_its_files():
    cell = spec.load_cell(CELL)
    m = cell.config["model"]
    assert cell.config["name"] == "dad-base-window" and m["reference"] == "dinov2_window_dpt"
    assert cell.traffic == spec.load_cell("base-infer-1036").traffic
    assert set(cell.limits) == {"depth_gap", "depth_affine_gap"}
    assert {x["name"] for x in cell.end_to_end} == {"infer_img_s", "infer_p95_ms", "setup_s"}
    assert {x["name"] for x in cell.per_layer} == {
        "fwd_enqueue_ms.infer", "k2_roofline.infer", "device_idle.infer", "elementwise_ms.infer",
        "k7_roofline.infer", "peg_roofline.infer", "window_mfu.infer"}


def test_the_preset_is_taken_under_the_window_reference_alone():
    m = spec.load_cell(CELL).config["model"]
    harness.check_preset(m)
    dense = {**m, "reference": "dinov2_dpt", "out_indices": [2, 5, 8, 11],
             "interpolate_offset": 0.1}
    with pytest.raises(ValueError, match="window_size"):
        harness.check_preset(dense)
    with pytest.raises(ValueError, match="use_cls_token"):
        dinov2_window_dpt.param_specs({**m, "use_cls_token": True})
    base = spec.load_cell("base-infer-1036").config["model"]
    with pytest.raises(ValueError, match="use_pos_conv"):
        dinov2_window_dpt.param_specs({**base, "reference": "dinov2_window_dpt",
                                       "window_size": None, "use_pos_conv": False,
                                       "use_cls_token": False, "final_taps": True})


def _judge_tiny_cell(program=None):
    """A run of ``tiny.infer_cell`` with the ``TINY`` model under the cell's
    limits, judged."""
    torch.set_num_threads(4)
    cell = tiny.infer_cell(TINY_RES)
    cell.config["model"] = copy.deepcopy(TINY)
    cell.limits = spec.load_cell(CELL).limits
    _, numbers = harness.run_cell(cell, 2 ** 31 + 29, 0.2, False, "cpu", time.perf_counter(),
                                  program)
    return check.judge(numbers, cell.limits)


def test_a_tiny_window_cell_reads_far_inside_the_limits(tiny_preset):
    correct, checks = _judge_tiny_cell()
    assert correct, checks
    assert all(c["value"] < c["limit"] / 100 for c in checks.values()), checks


@pytest.mark.parametrize("fault", sorted(faults.PREDICT))
def test_a_tiny_window_cell_with_a_fault_is_not_correct(tiny_preset, fault):
    correct, checks = _judge_tiny_cell(harness.Program(predict_wrapper=faults.PREDICT[fault]))
    assert not correct, checks


def test_a_tiny_window_cell_attending_globally_is_not_correct(tiny_preset, monkeypatch):
    from distill_any_depth_tpu_torch.models.vit import DinoViT

    monkeypatch.setattr(DinoViT, "_attention_mask", lambda self, *args: (None, None))
    correct, checks = _judge_tiny_cell()
    assert not correct, checks


NAMES = ["void (anonymous namespace)::masked_attn_wgmma<(anonymous namespace)::WindowMask>",
         "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<1, bf16>",
         "tail_conv_wgmma<128>", "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN",
         "void at::native::vectorized_elementwise_kernel<4, mul>"]


def test_the_kernel_classes_of_the_window_readers():
    assert [tracing.classify(n) for n in NAMES] == [
        "banded attention kernel", "depthwise conv (PEG, ATen)", "tail kernel",
        "gemm (cublas)", "other elementwise"]


def test_every_reader_of_the_cell_reads_a_synthetic_trace():
    cell = spec.load_cell(CELL)
    spans = tracing.Spans(True)
    spans.add("predict.forward", 0, 10)
    trace = tracing.Trace(ops=[(n, 20 + 10 * i, 25 + 10 * i) for i, n in enumerate(NAMES)],
                          start_ns=0, end_ns=100, units=1, spans=spans.items,
                          launch_ns=[5] * len(NAMES))
    ctx = harness.Ctx(cell=cell, setup_s=1.0, window_s=1.0, images=8, units=1,
                      latencies_ms=[1.0, 2.0], ends_s=[0.5, 1.0], spans=spans, trace=trace)
    for m in cell.end_to_end + cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        assert isinstance(value, float) and value > 0, (m["name"], value)
    for name in ("k7_roofline.infer", "peg_roofline.infer"):
        assert spec.metric_reader(name)(harness.Ctx(cell=cell, setup_s=1.0)) is None


def test_the_counts_pinned_by_hand():
    m = spec.load_cell(CELL).config["model"]
    assert window_flops.live_pairs(74, 74, 7) == 5476 * 49
    assert window_flops.live_pairs(5, 5, 7) == 25 * 25
    # kernel 7 at bs8 1036^2: qkv [8, 5476, 2304] read and out [8, 5476, 768]
    # written in bf16, 269.2 MB at 3.35 TB/s; 4 * 64 operations a live pair and head
    ops, nbytes = window_flops.banded_attention(8, 74, 74, 12, 7)
    assert nbytes == 8 * 5476 * (2304 + 768) * 2 and ops == 256 * 8 * 12 * 5476 * 49
    assert flops.bound_s(ops, nbytes) == (pytest.approx(0.0803e-3, rel=1e-3), "bytes")
    # the PEG conv at bs8 1036^2: 92.1 GFLOP, bound by the operations
    ops, nbytes = window_flops.pos_conv(8, 768, 74, 74)
    assert ops == 2 * 8 * 768 * 37 * 37 * 5476
    assert flops.bound_s(ops, nbytes) == (pytest.approx(0.0931e-3, rel=1e-3), "operations")
    # 1.2544 TFLOP an image at 1036^2: the patch embedding 4.95 G, the blocks'
    # GEMMs 930.2 G, QK^T and PV over the live pairs 9.89 G, the PEG 11.51 G,
    # the head 297.8 G; the dense count is 2.34 T
    assert window_flops.model_flops(m, 1036) == pytest.approx(1.25436e12, rel=1e-5)
    assert flops.model_flops(m, 1036) == pytest.approx(2.33895e12, rel=1e-5)
    head = flops.model_flops({**m, "depth": 0}, 1036) - 2.0 * 5476 * 3 * 14 * 14 * 768
    assert head == pytest.approx(297.80e9, rel=1e-4)
