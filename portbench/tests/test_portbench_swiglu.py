"""The ``giant-infer-518`` cell: its files, its reference's place in the
harness, a tiny SwiGLU cell through the ``infer`` driver on the CPU, the
``elementwise_ms.infer`` reader, and the FLOPs of the SwiGLU FFN."""
from __future__ import annotations

import copy
import dataclasses
import math
import time

import pytest
import torch

from portbench import check, faults, flops, harness, spec, tracing
from portbench.reference import dinov2_swiglu_dpt
from portbench.tests import tiny

CELL = "giant-infer-518"
TINY_PRESET = "tiny-swiglu"
TINY = {**tiny.SMALL, "reference": "dinov2_swiglu_dpt", "preset": TINY_PRESET, "embed_dim": 96,
        "depth": 4, "num_heads": 2, "ffn": "swiglu", "out_indices": [0, 1, 2, 3],
        "features": 32, "out_channels": [24, 48, 96, 96]}


@pytest.fixture
def tiny_preset(monkeypatch):
    """A preset of the giant model at ``TINY``'s sizes, under its own name."""
    from distill_any_depth_tpu_torch.configs import MODELS

    giant = MODELS["depthanything-giant"]
    enc = dataclasses.replace(giant.encoder, embed_dim=96, depth=4, num_heads=2,
                              out_indices=(0, 1, 2, 3))
    monkeypatch.setitem(MODELS, TINY_PRESET,
                        dataclasses.replace(giant, arch_name=TINY_PRESET, encoder=enc,
                                            features=32, out_channels=(24, 48, 96, 96)))


def test_the_cell_resolves_to_its_files():
    cell = spec.load_cell(CELL)
    m = cell.config["model"]
    assert cell.config["name"] == "dav2-giant" and m["reference"] == "dinov2_swiglu_dpt"
    assert cell.traffic["processing_res"] == 518 and cell.traffic["batch_size"] == 8
    assert set(cell.limits) == {"depth_gap", "depth_affine_gap"}
    assert {x["name"] for x in cell.end_to_end} == {"infer_img_s", "infer_p95_ms", "setup_s"}
    assert {x["name"] for x in cell.per_layer} == {
        "fwd_enqueue_ms.infer", "k1_roofline.infer", "k2_roofline.infer", "device_idle.infer",
        "mfu.infer", "elementwise_ms.infer"}
    encoder = sum(math.prod(shape) for name, shape, _, _ in dinov2_swiglu_dpt.param_specs(m)
                  if name.startswith("pretrained."))
    assert 1.13e9 < encoder < 1.14e9  # ViT-g/14 with the 518 pos-embed grid


def test_the_giant_is_taken_under_the_swiglu_reference_alone():
    m = spec.load_cell(CELL).config["model"]
    harness.check_preset(m)
    with pytest.raises(ValueError, match="ffn"):
        harness.check_preset({**m, "reference": "dinov2_dpt"})
    base = spec.load_cell("base-infer-1036").config["model"]
    with pytest.raises(ValueError, match="swiglu"):
        dinov2_swiglu_dpt.param_specs({**base, "reference": "dinov2_swiglu_dpt", "ffn": "mlp"})


def _judge_tiny_cell(program=None):
    """A run of ``tiny.infer_cell`` with the ``TINY`` model under the cell's
    limits, judged."""
    torch.set_num_threads(4)
    cell = tiny.infer_cell()
    cell.config["model"] = copy.deepcopy(TINY)
    cell.limits = spec.load_cell(CELL).limits
    _, numbers = harness.run_cell(cell, 2 ** 31 + 23, 0.2, False, "cpu", time.perf_counter(),
                                  program)
    return check.judge(numbers, cell.limits)


def test_a_tiny_swiglu_cell_reads_far_inside_the_limits(tiny_preset):
    correct, checks = _judge_tiny_cell()
    assert correct, checks
    assert all(c["value"] < c["limit"] / 100 for c in checks.values()), checks


@pytest.mark.parametrize("fault", sorted(faults.PREDICT))
def test_a_tiny_swiglu_cell_with_a_fault_is_not_correct(tiny_preset, fault):
    correct, checks = _judge_tiny_cell(harness.Program(predict_wrapper=faults.PREDICT[fault]))
    assert not correct, checks


def test_elementwise_ms_reads_a_synthetic_trace():
    read = spec.metric_reader("elementwise_ms.infer")
    names = ["void at::native::vectorized_elementwise_kernel<4, silu>", "packed_attn_wgmma<bf16>",
             "Memcpy HtoD (Pageable -> Device)", "void at::native::elementwise_kernel<mul>",
             "nvjet_tst_192x192", "Memset (Device)"]
    ops = [(n, 1000 * i, 1000 * i + 100 * (i + 1)) for i, n in enumerate(names)]
    trace = tracing.Trace(ops=ops, start_ns=0, end_ns=10_000, units=2, spans=[])
    cell = spec.load_cell(CELL)
    assert read(harness.Ctx(cell=cell, setup_s=1.0, trace=trace)) == pytest.approx(
        (100 + 400) / 2 / 1e6)
    assert read(harness.Ctx(cell=cell, setup_s=1.0)) is None
    empty = tracing.Trace(ops=ops[1:3], start_ns=0, end_ns=10_000, units=2, spans=[])
    assert read(harness.Ctx(cell=cell, setup_s=1.0, trace=empty)) is None


def _swiglu_by_hand(m: dict, res: int) -> float:
    """FLOPs of every block's SwiGLU GEMMs: w12 (d -> 2h) and w3 (h -> d)."""
    n, d, h = flops.tokens(res), m["embed_dim"], dinov2_swiglu_dpt.hidden_width(m)
    return m["depth"] * (2.0 * n * d * 2 * h + 2.0 * n * h * d)


def _ffn_term(m: dict, res: int) -> float:
    return flops.model_flops(m, res) - flops.model_flops({**m, "mlp_ratio": 0.0}, res)


def test_model_flops_counts_the_giant_swiglu_exactly():
    m = spec.load_cell(CELL).config["model"]
    assert _swiglu_by_hand(m, 518) == _ffn_term(m, 518)
    # model_flops counts 2 d (4 d) a token, equal to 3 d h only where h = 8d/3
    # exactly; another width would be counted wrong
    assert _swiglu_by_hand({**m, "embed_dim": 100}, 518) != _ffn_term({**m, "embed_dim": 100}, 518)
    assert 4.4e12 < flops.model_flops(m, 518) < 4.6e12

