"""The benchmark's counts of operations and bytes against hand counts."""
from __future__ import annotations

import pytest

from portbench import flops
from portbench.tests.test_portbench_reference import BASE, LARGE


def test_attention_counts():
    # kernel 1, ViT-B 392^2 bs8: 4 D per (query, key) pair and head; qkv in, out out (bf16)
    ops, nbytes = flops.attention(8, 785, 12, backward=False)
    assert ops == 4 * 8 * 12 * 785 * 785 * 64
    assert nbytes == (3 + 1) * 8 * 785 * 768 * 2
    ops, nbytes = flops.attention(16, 785, 12, backward=True)
    assert ops == 10 * 16 * 12 * 785 * 785 * 64
    assert nbytes == (4 + 4) * 16 * 785 * 768 * 2  # qkv, out, dout in; d(qkv) out
    seconds, side = flops.bound_s(ops, nbytes)
    assert side == "operations" and seconds == pytest.approx(ops / 989e12)


def test_tail_and_select_counts():
    ops, nbytes = flops.dpt_tail(8, 392, 128)
    conv1 = 2 * 8 * 224 * 224 * 9 * 128 * 64  # 2x of the 112 grid, C -> C/2
    conv2 = 2 * 8 * 392 * 392 * 9 * 64 * 32
    head = 2 * 8 * 392 * 392 * 32
    assert ops == conv1 + conv2 + head
    weights = (9 * 128 * 64 + 64 + 9 * 64 * 32 + 32 + 32 + 1) * 4
    assert nbytes == 8 * 112 * 112 * 128 * 2 + weights + 8 * 392 * 392 * 2
    assert flops.kth_select(112, 392 * 392) == (0.0, 112 * 392 * 392 * 4 + 112 * 8)
    assert flops.bound_s(*flops.kth_select(112, 392 * 392))[1] == "bytes"


def test_vit_b_392_encoder_flops():
    # 2 * 785 tokens * 12 blocks * 7,077,888 GEMM weights + 12 * 4 * 785^2 * 768 attention
    # + the patch embedding, 2 * 784 * 588 * 768
    enc = 2 * 785 * 12 * 7_077_888 + 12 * 4 * 785 ** 2 * 768 + 2 * 784 * 588 * 768
    total = flops.model_flops(BASE, 392)
    assert enc == pytest.approx(156.78e9, rel=1e-3)
    head = total - enc
    g, f = 28, 128
    oc = BASE["out_channels"]
    hand = (2 * g * g * 768 * sum(oc)  # projects
            + 2 * g * g * 96 * 96 * 16 + 2 * g * g * 192 * 192 * 4  # transposed convs
            + 2 * 14 * 14 * 768 * 768 * 9  # stride-2 conv
            + 2 * 9 * f * (112 ** 2 * 96 + 56 ** 2 * 192 + 28 ** 2 * 384 + 14 ** 2 * 768)
            + sum(2 * s * s * f * f * (9 * 2 * units + 1)
                  for s, units in ((112, 2), (56, 2), (28, 2), (14, 1)))
            + 2 * 224 * 224 * 9 * f * 64 + 2 * 392 * 392 * (9 * 64 * 32 + 32))
    assert head == hand


def test_teacher_flops_scale_with_width():
    assert flops.model_flops(LARGE, 392) > 3 * flops.model_flops(BASE, 392)
    assert flops.tokens(392) == 785 and flops.tokens(1036) == 5477
