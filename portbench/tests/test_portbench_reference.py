"""The plain reference against the port's CPU path, float32, on the
benchmark's own weights: the depth forward of three presets, and the
distillation step through the harness (losses, first gradient, change)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, harness, inputs
from portbench.reference.dinov2_dpt import depth_forward
from portbench.reference.images import IMAGENET_MEAN, IMAGENET_STD, preprocess
from portbench.tests import tiny

LARGE = {**tiny.SMALL, "preset": "depthanything-large", "embed_dim": 1024, "depth": 24,
         "num_heads": 16, "out_indices": [4, 11, 17, 23], "features": 256,
         "out_channels": [256, 512, 1024, 1024], "trailing_head_relu": False,
         "interp_to_input": True}
BASE = {**tiny.SMALL, "preset": "depthanything-base", "embed_dim": 768, "num_heads": 12,
        "features": 128, "out_channels": [96, 192, 384, 768]}


@pytest.mark.parametrize("m", [tiny.SMALL, BASE, LARGE], ids=lambda m: m["preset"])
def test_forward_matches_the_port(m):
    torch.manual_seed(0)
    model = harness.build_model(m, {"dtype": "float32", "fused_tail": True},
                                torch.device("cpu"), 5, "teacher")
    weights = inputs.make_weights(m, 5, "teacher", "cpu")
    x = torch.randn(2, 3, 56, 70)
    with torch.no_grad():
        d_port, f_port = model(x)
        d_ref, f_ref = depth_forward(weights, m, x)
    assert d_port.shape == d_ref.shape == (2, 56, 70)
    assert float((d_port - d_ref).norm() / d_ref.norm()) < 1e-4
    assert float((f_port - f_ref).norm() / f_ref.norm()) < 1e-4


def test_preprocess_matches_the_port():
    from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device

    img = inputs.synthetic_images(inputs.generator(3, "images", "cpu"), 1, (45, 80), "cpu")
    port = preprocess_on_device(img, 56)
    ref = preprocess(img[0].numpy(), 56, "cpu")
    assert float((port - ref).abs().max()) < 1e-4


def test_memory_batches_are_normalized_and_distinct():
    batches = inputs.memory_batches(9, 2, 3, 28, "cpu")
    x = np.concatenate(batches)
    assert x.shape == (6, 28, 28, 3) and x.dtype == np.float32
    raw = (x * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    assert raw.min() > -0.01 and raw.max() < 255.01
    assert len({row.tobytes() for row in x}) == 6


def test_weights_follow_the_seed():
    a = inputs.make_weights(tiny.SMALL, 2 ** 31 + 3, "student", "cpu")
    b = inputs.make_weights(tiny.SMALL, 2 ** 31 + 3, "student", "cpu")
    c = inputs.make_weights(tiny.SMALL, 2 ** 31 + 4, "student", "cpu")
    name = "pretrained.blocks.0.attn.qkv.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert abs(float(a[name].std()) * 384 ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("source", ["memory", "nyu"])
def test_train_step_matches_the_port(source):
    torch.set_num_threads(4)
    cell = tiny.train_cell(source)
    _, numbers = harness.run_cell(cell, 2 ** 31 + 5, 0.2, False, "cpu", time.perf_counter())
    correct, checks = check.judge(numbers, cell.limits)
    assert correct, checks
    assert numbers["change_median_gap"] < 0.01, numbers
