"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip without a CUDA device (decided inside each test
through the ``cuda_device`` fixture). On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerances as in
``chip_smoke.py``: fp32 differs by summation order only; bf16 by a few
bf16 roundings placed differently (attention, biased and banded attention
and their backwards: max |err| / (1 + |ref|); tail: max |err| / max
|ref|); the select is exact. The biased and banded backwards (kernels 6
and 8) are held against their plain versions on the same forward output
and log-sum-exp, where the two round at the same places (bf16 differs by
the flips of those roundings), and, through autograd, against autograd of
the plain forward. Kernel 7 equals kernel 5 with the window bias bit for
bit (out and lse), also with every logit below -60, and two calls of each
agree bit for bit. The W8A8 GEMM (kernel 9) equals its plain version bit
for bit: the same true divisions, an exact integer product, the same
roundings in the dequant. A two-view train step launches the kernels
its two student forwards need, and an adapter-only step leaves every frozen
parameter bit-equal. Under tensor parallelism over 2 ranks, kernels 1 and 3
run at a rank's share of the heads (ViT-B's 6 of 12, ViT-L's 8 of 16), and
a row-parallel int8 layer's shards through kernel 9 (each bit-equal to its
plain version) sum to the unsharded layer's product. An exported program
(``utils/export``, both flavours) of a tiny ViT-B, windowed and
``int8_pallas`` model runs kernels 1, 2, 5 and 9 through their ops and
gives the eager depth bit for bit; a remat step launches kernel 1 once more
per student block, with the loss of the step without remat bit for bit.
``predict`` returns its depth bit for bit in page-locked memory, a new
array each call. The PEG conv kernel follows its plain version in fp32 (bf16
within one rounding of the output plus the sums' error; fp32 within the
sums' error) at the windowed teacher's grids, a non-square, a wide and an
odd grid, reads a token-major view, repeats its bits and runs once a
windowed forward; its backward kernels (d(x), d(weight), d(bias)) follow
ATen's backward of the plain version in fp32 (within one rounding of each
in bf16 plus the sums' error), repeat their bits, launch once a backward
and compute only the gradients asked for. A forward under
``torch.inference_mode()`` casts no
parameter to bf16 after its first call, with the ``no_grad`` depth bit for
bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from distill_any_depth_tpu_torch.cli import infer
from distill_any_depth_tpu_torch.configs import LossConfig, OptimizerConfig, model_config
from distill_any_depth_tpu_torch.models import vit
from distill_any_depth_tpu_torch.models.adapters import adapter_parameters, is_adapter_name
from distill_any_depth_tpu_torch.models.dpt import ConvTranspose2d
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops.dpt_tail import fused_dpt_tail, tail_reference
from distill_any_depth_tpu_torch.ops.flash_attention import (
    _banded_forward,
    _bias_forward,
    _forward,
    banded_attention_backward,
    banded_attention_backward_reference,
    bias_attention_backward,
    bias_attention_backward_reference,
    mha_banded_reference,
    mha_bias_reference,
    mha_flash_banded,
    mha_flash_bias,
    mha_flash_packed,
    mha_packed_reference,
    packed_attention_backward,
)
from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device
from distill_any_depth_tpu_torch.ops.window import local_window_bias, segment_bias
from distill_any_depth_tpu_torch.ops.stats import _order_bits, kth_select, kth_select_reference
from distill_any_depth_tpu_torch.ops.quant import shard_product
from distill_any_depth_tpu_torch.ops.quant_matmul import (
    quantize_rows,
    quantize_weight,
    w8a8_matmul,
    w8a8_reference,
)
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step
from distill_any_depth_tpu_torch.utils.profiling import recording

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# N across the tile edges of both kernels' paths: 64-row tiles (fp32 and the
# backward's streamed tiles), 128-row q tiles and 128-key stages (the bf16
# forward), and the ViT-B/L 392^2 token count 785 = 6 * 128 + 17
ATTENTION_NS = [1, 63, 64, 65, 127, 128, 129, 197, 785]


def _launched(rec, *names) -> list:
    """Each kernel's launches that the ``recording()`` block ``rec``
    counted (``kernels/<name>``; 0 for none)."""
    return [rec.counts.get(f"kernels/{name}", 0) for name in names]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 6e-3)])
@pytest.mark.parametrize("n", ATTENTION_NS)
def test_attention_kernel_matches_plain(cuda_device, n, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(2, n, 3 * 128, generator=gen, device=cuda_device).to(dtype)
    with recording() as rec:
        got = mha_flash_packed(qkv, 2)
    assert rec.counts.get("kernels/attention") == 1
    ref = mha_packed_reference(qkv, 2)
    assert got.dtype == dtype and got.shape == (2, n, 128)
    assert ((got.float() - ref.float()).abs() <= tol * (1 + ref.float().abs())).all()


def test_attention_kernel_refuses(cuda_device):
    qkv = torch.randn(1, 8, 3 * 128, device=cuda_device)
    with pytest.raises(TypeError):
        mha_flash_packed(qkv.half(), 2)
    with pytest.raises(ValueError, match="head dim"):
        mha_flash_packed(qkv, 4)
    # a qkv that requires a gradient goes through the kernels' autograd Function
    with recording() as rec:
        mha_flash_packed(qkv.requires_grad_(), 2).sum().backward()
    assert rec.counts.get("kernels/attention_bwd") == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.5e-2)])
@pytest.mark.parametrize("n", ATTENTION_NS)
def test_attention_backward_matches_autograd_of_plain(cuda_device, n, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(2, n, 3 * 128, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(2, n, 128, generator=gen, device=cuda_device).to(dtype)
    x, xr = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    mha_flash_packed(x, 2).backward(g)
    mha_packed_reference(xr, 2).backward(g)
    assert x.grad.dtype == dtype and torch.isfinite(x.grad).all()
    assert ((x.grad.float() - xr.grad.float()).abs()
            <= tol * (1 + xr.grad.float().abs())).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_is_deterministic(cuda_device, dtype):
    """Kernel 3 writes every gradient once, without atomics: two calls on
    the same inputs give d(qkv) equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(2, 785, 3 * 128, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(2, 785, 128, generator=gen, device=cuda_device).to(dtype)
    out, lse = _forward(qkv, 2, with_lse=True)
    first = packed_attention_backward(qkv, out, lse, g, 2)
    assert torch.equal(first, packed_attention_backward(qkv, out, lse, g, 2))


@pytest.mark.parametrize("heads", [6, 8])
@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [(torch.float32, 1e-5, 1e-5),
                                                   (torch.bfloat16, 6e-3, 2.5e-2)])
def test_attention_kernels_at_tensor_parallel_heads(cuda_device, heads, dtype, fwd_tol,
                                                    bwd_tol):
    """Kernels 1 and 3 at a tp=2 rank's heads of ViT-B (6) and ViT-L (8) at
    392^2 (N = 785), against the plain forward and autograd of it."""
    gen = torch.Generator(device=cuda_device).manual_seed(heads)
    c = heads * 64
    qkv = torch.randn(2, 785, 3 * c, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(2, 785, c, generator=gen, device=cuda_device).to(dtype)
    x, xr = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    out, ref = mha_flash_packed(x, heads), mha_packed_reference(xr, heads)
    assert ((out.float() - ref.float()).abs() <= fwd_tol * (1 + ref.float().abs())).all()
    out.backward(g)
    ref.backward(g)
    assert ((x.grad.float() - xr.grad.float()).abs()
            <= bwd_tol * (1 + xr.grad.float().abs())).all()


@pytest.mark.parametrize("m,k,n", [(6280, 4096, 1024), (3140, 3072, 768)])
def test_row_parallel_int8_shards_sum_to_unsharded(cuda_device, m, k, n):
    """A row-parallel W8A8 layer over 2 shards (ViT-L's and ViT-B's fc2 at
    392^2): each shard's kernel-9 product at the global row and column
    scales equals its plain version bit for bit, and the shards' fp32 sum
    is the unsharded product in another summation order."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device=cuda_device) * 0.02
    wq, ws = quantize_weight(w)
    amax = x.float().abs().amax(-1, keepdim=True)
    parts = []
    for half in (slice(0, k // 2), slice(k // 2, k)):
        with recording() as rec:
            got = shard_product(x[:, half], amax, wq[:, half], ws, "int8_pallas")
        assert rec.counts.get("kernels/w8a8") == 1 and got.dtype == torch.float32
        plain = shard_product(x[:, half].cpu(), amax.cpu(), wq[:, half].cpu(), ws.cpu(),
                              "int8_pallas")
        assert torch.equal(got.cpu(), plain)
        parts.append(got)
    want = w8a8_reference(x, wq, ws, None, torch.float32)
    xq, _ = quantize_rows(x)
    assert torch.equal(quantize_rows(x[:, : k // 2], amax)[0], xq[:, : k // 2])
    assert ((parts[0] + parts[1] - want).abs() <= 1e-5 * (1 + want.abs())).all()


@pytest.mark.parametrize("n", [1, 1000, 153664])
def test_select_kernel_matches_plain(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(6, n, generator=gen, device=cuda_device)
    x[0] = torch.round(x[0])  # ties
    x[1, ::2] = -0.0
    x[1, 1::2] = 0.0
    mask = torch.rand(6, n, generator=gen, device=cuda_device) < 0.5
    mask[2] = False
    u = _order_bits(x, mask)
    count = mask.sum(-1)
    k = (count - 1).clamp(min=0) // 2
    k[3], k[4] = 0, n - 1
    with recording() as rec:
        got = kth_select(u, k)
    assert rec.counts.get("kernels/select") == 1
    assert torch.equal(got, kth_select_reference(u, k))


@pytest.mark.parametrize("n", [1000, 153664, 1073296])
def test_select_kernel_overfilled_and_long_rows(cuda_device, n):
    """Rows whose chosen first-digit bin holds more distinct values than a
    block's candidate buffer (uniform in [1, 1.25): one bin), beside ReLU
    zeros and an all-valid normal row, k at the median and at both ends;
    at 1036^2 (n = 1073296) a block keeps a third of its slice in shared
    memory, so the later sweeps also read device memory. Equal to the plain
    version bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(6, n, generator=gen, device=cuda_device)
    x[:3] = 1.0 + 0.25 * torch.rand(3, n, generator=gen, device=cuda_device)
    x[3] = torch.relu(x[3])
    u = _order_bits(x, None)
    k = torch.full((6,), (n - 1) // 2, device=cuda_device)
    k[1], k[2] = 0, n - 1
    got = kth_select(u, k)
    assert torch.equal(got, kth_select_reference(u, k))


def _tail_inputs(c, b, ht, wt, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    cm = c // 2
    w = dict(k1=rnd(3, 3, c, cm, scale=(9 * c) ** -0.5), b1=rnd(cm, scale=0.1),
             k2=rnd(3, 3, cm, 32, scale=(9 * cm) ** -0.5), b2=rnd(32, scale=0.1),
             kd=rnd(32, 1, scale=32 ** -0.5), bd=rnd(1, scale=0.1))
    return rnd(b, ht, wt, c).to(dtype), w


# the bf16 kernel's tiles are 64 output columns by 2 (C = 384's conv1), 4
# (C = 256's conv1) or 8 rows; ht or wt = 1, an (oh, ow) off those multiples, and a head step
# (2 ht - 1) / (oh - 1) above the staged source patch's 4/7 (the gather path).
# The trailing ReLU only at the larger shapes: where it clips most of a small
# output, max |ref| is tiny and any bf16 chain's relative error passes 2e-2.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c,ht,wt,oh,ow,relu", [
    (64, 5, 7, 42, 28, True), (128, 8, 8, 28, 28, False), (256, 3, 4, 17, 30, True),
    (64, 1, 9, 15, 65, False), (128, 9, 1, 63, 14, False), (256, 1, 1, 14, 14, False),
    (64, 33, 32, 129, 70, True), (128, 37, 33, 131, 200, False), (256, 28, 28, 98, 98, True),
    (128, 20, 20, 30, 30, False),
    (384, 8, 8, 28, 28, True), (384, 3, 4, 17, 30, False), (384, 1, 9, 15, 65, False),
    (384, 33, 32, 129, 70, True), (384, 37, 33, 131, 200, False),
])
def test_tail_kernel_matches_plain(cuda_device, c, ht, wt, oh, ow, relu, dtype, tol):
    t, w = _tail_inputs(c, 2, ht, wt, dtype, cuda_device, c + ht)
    with recording() as rec:
        got = fused_dpt_tail(t, (oh, ow), trailing_relu=relu, **w)
    assert rec.counts.get("kernels/tail") == 1
    ref = tail_reference(t, (oh, ow), trailing_relu=relu, **w)
    assert got.dtype == dtype and got.shape == (2, oh, ow)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.parametrize("c", [64, 128, 256, 384])
def test_tail_kernel_is_deterministic(cuda_device, c):
    """Every output of the bf16 kernel is summed in one fixed order: two calls
    on the same inputs, with weights prepared once and packed per call, give
    the same bits."""
    from distill_any_depth_tpu_torch.ops.dpt_tail import prepare_weights

    t, w = _tail_inputs(c, 2, 37, 37, torch.bfloat16, cuda_device, c)
    first = fused_dpt_tail(t, (518, 518), trailing_relu=False, **w)
    prep = prepare_weights(*w.values(), torch.bfloat16)
    assert torch.equal(first, fused_dpt_tail(t, (518, 518), trailing_relu=False, weights=prep,
                                             **w))


def test_tail_kernel_refuses_other_widths(cuda_device):
    """A width the kernel has no instance for raises on the card: no plain
    fallback."""
    t, w = _tail_inputs(512, 1, 8, 8, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="takes C in"):
        fused_dpt_tail(t, (28, 28), trailing_relu=True, **w)


def test_model_runs_kernels_in_grad_mode_or_raises(cuda_device):
    """With grad mode on, a frozen model (a distillation teacher) still runs
    both kernels; with weights that require a gradient, the tail kernel
    (forward-only) raises instead of falling back to the plain chain, and a
    model built with ``fused_tail=False`` (the student) trains through the
    attention kernels, forward and backward."""
    cfg = model_config("depthanything-base")
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                              out_indices=(0, 1, 1, 1))
    cfg = dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128))
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device).requires_grad_(False)
    x = torch.rand(1, 3, 98, 98, device=cuda_device)
    with recording() as rec:
        depth, _ = model(x)
    assert _launched(rec, "attention", "tail") == [2, 1]
    assert depth.shape == (1, 98, 98) and torch.isfinite(depth).all()
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        model(x)
    student = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, fused_tail=False)
    with recording() as rec:
        student(x)[0].mean().backward()
    assert _launched(rec, "attention", "tail", "attention_bwd") == [2, 0, 2]
    assert torch.isfinite(student.pretrained.blocks[0].attn.qkv.weight.grad).all()


def _masked_qkv(b, n, h, dtype, gen):
    """q, k, v [B, N, H, 64] viewed in place in a packed qkv."""
    qkv = torch.randn(b, n, 3 * h * 64, generator=gen, device=gen.device).to(dtype)
    return qkv.view(b, n, 3, h, 64).unbind(2)


def _within(got, ref, tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype and torch.isfinite(got).all()
    assert ((got.float() - ref.float()).abs() <= tol * (1 + ref.float().abs())).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 6e-3)])
@pytest.mark.parametrize("kind,n", [
    ("window", 81), ("window+prefix", 82), ("random", 65), ("segment", 130), ("none", 63),
])
def test_bias_kernel_matches_plain(cuda_device, kind, n, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    q, k, v = _masked_qkv(2, n, 2, dtype, gen)
    bias = {
        "window": lambda: local_window_bias(9, 9, 3, 0, cuda_device, dtype),
        "window+prefix": lambda: local_window_bias(9, 9, 3, 1, cuda_device, torch.float32),
        "random": lambda: torch.randn(n, n, generator=gen, device=cuda_device),
        "segment": lambda: segment_bias(torch.arange(n) // 40).to(cuda_device, dtype),
        "none": lambda: None,
    }[kind]()
    with recording() as rec:
        got = mha_flash_bias(q, k, v, bias)
    assert rec.counts.get("kernels/attention_bias") == 1
    _within(got, mha_bias_reference(q, k, v, bias), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 6e-3)])
@pytest.mark.parametrize("gh,gw,window", [
    (9, 9, 3), (3, 5, 7), (12, 20, 7), (50, 110, 7), (3, 1000, 7), (13, 29, 5),
])
def test_banded_kernel_matches_plain_and_bias_kernel(cuda_device, gh, gw, window, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(gh * gw)
    q, k, v = _masked_qkv(2, gh * gw, 2, dtype, gen)
    with recording() as rec:
        got = mha_flash_banded(q, k, v, (gw, window))
    assert rec.counts.get("kernels/attention_banded") == 1
    _within(got, mha_banded_reference(q, k, v, (gw, window)), tol)
    # kernel 5 with the window bias visits the same live tiles with the same arithmetic
    wb = local_window_bias(gh, gw, window, 0, cuda_device, dtype)
    assert torch.equal(got, mha_flash_bias(q, k, v, wb))


def _negative_qkv(b, n, h, dtype, gen):
    """q, k, v as ``_masked_qkv``, with every logit below -60: q along +u,
    the keys along -u (chip_smoke.py's inputs)."""
    c = h * 64
    qkv = torch.randn(b, n, 3 * c, generator=gen, device=gen.device)
    u = torch.full((64,), 0.125, device=gen.device)
    qkv[:, :, :c] = 0.01 * qkv[:, :, :c] + (80 * u).repeat(h)
    qkv[:, :, c:2 * c] = 0.01 * qkv[:, :, c:2 * c] - (10 * u).repeat(h)
    q, k, v = qkv.view(b, n, 3, h, 64).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
    assert s.max() < -60
    return qkv.to(dtype).view(b, n, 3, h, 64).unbind(2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 6e-3)])
@pytest.mark.parametrize("gh,gw,window", [(13, 29, 5), (37, 37, 7)])
def test_masked_forward_below_minus_60(cuda_device, gh, gw, window, dtype, tol):
    """Kernels 5 (with the window bias) and 7 with every logit below -60:
    the exponentials of scores far below 0, taken against the running max,
    hold against the plain versions, and kernel 7 equals kernel 5 (out and
    lse) bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(gh + gw)
    n = gh * gw
    q, k, v = _negative_qkv(2, n, 2, dtype, gen)
    wb = local_window_bias(gh, gw, window, 0, cuda_device, dtype)
    out5, lse5 = _bias_forward(q, k, v, wb, with_lse=True)[:2]
    ref, ref_lse = mha_bias_reference(q, k, v, wb, with_lse=True)
    _within(out5, ref, tol)
    assert torch.isfinite(lse5).all() and (lse5 < -50).all()
    if dtype == torch.float32:  # bf16 sums rounded exponentials in another order
        assert ((lse5 - ref_lse).abs() <= 1e-5 * (1 + ref_lse.abs())).all()
    out7, lse7 = _banded_forward(q, k, v, (gw, window), with_lse=True)
    _within(out7, mha_banded_reference(q, k, v, (gw, window)), tol)
    assert torch.equal(out7, out5) and torch.equal(lse7, lse5)


# the edge grids of test_banded_kernel_matches_plain_and_bias_kernel
EDGE_GRIDS = [(9, 9, 3), (3, 5, 7), (12, 20, 7), (50, 110, 7), (3, 1000, 7), (13, 29, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,window", EDGE_GRIDS)
def test_banded_forward_equals_bias_forward(cuda_device, gh, gw, window, dtype):
    """Kernel 7 and kernel 5 with the window bias visit the same live tiles
    in the same order with the same arithmetic: out and lse equal bit for
    bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(gh * gw + 2)
    q, k, v = _masked_qkv(2, gh * gw, 2, dtype, gen)
    wb = local_window_bias(gh, gw, window, 0, cuda_device, dtype)
    out5, lse5 = _bias_forward(q, k, v, wb, with_lse=True)[:2]
    out7, lse7 = _banded_forward(q, k, v, (gw, window), with_lse=True)
    assert torch.equal(out7, out5) and torch.equal(lse7, lse5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["bias", "banded"])
def test_masked_forward_is_deterministic(cuda_device, kernel, dtype):
    """Two calls of kernel 5 (window bias, 518^2's 37 x 37 grid) or kernel 7
    (1036^2's 74 x 74) give out and lse equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    g = 37 if kernel == "bias" else 74
    q, k, v = _masked_qkv(2, g * g, 4, dtype, gen)
    if kernel == "bias":
        wb = local_window_bias(g, g, 7, 0, cuda_device, dtype)
        first, second = (_bias_forward(q, k, v, wb, with_lse=True)[:2] for _ in range(2))
    else:
        first, second = (_banded_forward(q, k, v, (g, 7), with_lse=True) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_masked_kernels_refuse(cuda_device):
    q, k, v = _masked_qkv(1, 16, 2, torch.float32, torch.Generator(device=cuda_device))
    with pytest.raises(TypeError):
        mha_flash_bias(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="bias"):
        mha_flash_bias(q, k, v, torch.zeros(15, 15, device=cuda_device))
    with pytest.raises(ValueError, match="band"):
        mha_flash_banded(q, k, v, (5, 3))
    out, lse = _banded_forward(q, k, v, (4, 3), with_lse=True)
    with pytest.raises(ValueError, match="backward"):
        banded_attention_backward(q, k, v, (4, 3), out, lse[:, :, :8], out)


# bf16 kernel against the plain backward on the same out and lse; fp32
# summation order only
GRAD_TOLS = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def _grads_within(got, ref, tol):
    for a, b in zip(got, ref):
        _within(a, b, tol)


@pytest.mark.parametrize("kept", [True, False], ids=["kept", "own"])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLS)
@pytest.mark.parametrize("kind,n", [
    ("window", 81), ("window+prefix", 82), ("random", 65), ("segment", 130), ("none", 63),
])
def test_bias_backward_matches_plain(cuda_device, kind, n, dtype, tol, kept):
    """Kernel 6 against its plain version from kernel 5's out and lse, given
    kernel 5's tile marks and bias terms (``kept``) or writing its own, and
    the autograd path of ``mha_flash_bias`` (kernels 5 + 6) against
    autograd of the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    q, k, v = _masked_qkv(2, n, 2, dtype, gen)
    bias = {
        "window": lambda: local_window_bias(9, 9, 3, 0, cuda_device, dtype),
        "window+prefix": lambda: local_window_bias(9, 9, 3, 1, cuda_device, torch.float32),
        "random": lambda: torch.randn(n, n, generator=gen, device=cuda_device),
        "segment": lambda: segment_bias(torch.arange(n) // 40).to(cuda_device, dtype),
        "none": lambda: None,
    }[kind]()
    g = torch.randn(2, n, 2, 64, generator=gen, device=cuda_device).to(dtype)
    out, lse, live, terms = _bias_forward(q, k, v, bias, with_lse=True)
    if not kept:
        live = terms = None
    with recording() as rec:
        got = bias_attention_backward(q, k, v, bias, out, lse, g, live, terms)
    assert rec.counts.get("kernels/attention_bias_bwd") == 1
    _grads_within(got, bias_attention_backward_reference(q, k, v, bias, out, lse, g), tol)
    # the autograd path: kernel 5 with lse, then kernel 6
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    with recording() as rec:
        mha_flash_bias(*xs, bias).backward(g)
    assert rec.counts.get("kernels/attention_bias_bwd") == 1
    xr = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    mha_bias_reference(*xr, bias).backward(g)
    _grads_within([x.grad for x in xs], [x.grad for x in xr], 2.5e-2 if tol > 1e-3 else tol)


@pytest.mark.parametrize("dtype,tol", GRAD_TOLS)
@pytest.mark.parametrize("gh,gw,window", [
    (9, 9, 3), (3, 5, 7), (12, 20, 7), (50, 110, 7), (3, 1000, 7), (13, 29, 5),
])
def test_banded_backward_matches_plain_and_bias_backward(cuda_device, gh, gw, window, dtype,
                                                         tol):
    """Kernel 8 against its plain version from kernel 7's out and lse, and
    equal to kernel 6 with the window bias (the same live tiles in the same
    order with the same arithmetic)."""
    gen = torch.Generator(device=cuda_device).manual_seed(gh * gw + 1)
    n = gh * gw
    q, k, v = _masked_qkv(2, n, 2, dtype, gen)
    g = torch.randn(2, n, 2, 64, generator=gen, device=cuda_device).to(dtype)
    out, lse = _banded_forward(q, k, v, (gw, window), with_lse=True)
    with recording() as rec:
        got = banded_attention_backward(q, k, v, (gw, window), out, lse, g)
    assert rec.counts.get("kernels/attention_banded_bwd") == 1
    _grads_within(got, banded_attention_backward_reference(q, k, v, (gw, window), out, lse, g),
                  tol)
    wb = local_window_bias(gh, gw, window, 0, cuda_device, dtype)
    out5, lse5, live, terms = _bias_forward(q, k, v, wb, with_lse=True)
    assert torch.equal(out5, out) and torch.equal(lse5, lse)
    for a, b in zip(got, bias_attention_backward(q, k, v, wb, out, lse, g, live, terms)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["bias", "banded"])
def test_masked_backward_is_deterministic(cuda_device, kernel):
    """Kernels 6 and 8 write every gradient once, without atomics: two calls
    on the same inputs give d(qkv) equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    gh = gw = 37
    n = gh * gw
    q, k, v = _masked_qkv(2, n, 4, torch.bfloat16, gen)
    g = torch.randn(2, n, 4, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    if kernel == "bias":
        wb = local_window_bias(gh, gw, 7, 0, cuda_device, torch.bfloat16)
        out, lse, live, terms = _bias_forward(q, k, v, wb, with_lse=True)
        first, second = (bias_attention_backward(q, k, v, wb, out, lse, g, live, terms)
                         for _ in range(2))
    else:
        out, lse = _banded_forward(q, k, v, (gw, 7), with_lse=True)
        first, second = (banded_attention_backward(q, k, v, (gw, 7), out, lse, g)
                         for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("res,kernel", [(126, "bias"), (70, "banded")])
def test_windowed_model_runs_masked_kernels(cuda_device, monkeypatch, res, kernel):
    """A tiny windowed model in bf16 runs one launch of its attention kernel
    per block (the banded one once the grid passes the threshold, lowered
    here) and the tail kernel once, and never the packed attention; as a
    student (plain tail), one backward runs the matching backward kernel
    once per block and gives finite gradients."""
    from distill_any_depth_tpu_torch.ops import flash_attention

    if kernel == "banded":
        monkeypatch.setattr(flash_attention, "_BANDED_MIN_SEQ", 0)
    cfg = model_config("depthanything-base-window")
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2, window_size=3)
    cfg = dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128))
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device)
    x = torch.rand(1, 3, res, res, device=cuda_device)
    names = ("attention", "attention_bias", "attention_banded", "tail", "attention_bwd",
             "attention_bias_bwd", "attention_banded_bwd")
    with torch.no_grad(), recording() as rec:
        depth, _ = model(x)
    ran = _launched(rec, *names)
    assert ran == ([0, 2, 0, 1, 0, 0, 0] if kernel == "bias" else [0, 0, 2, 1, 0, 0, 0])
    assert depth.shape == (1, res, res) and torch.isfinite(depth).all()

    student = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, fused_tail=False)
    with recording() as rec:
        student(x)[0].mean().backward()
    ran = _launched(rec, *names)
    assert ran == ([0, 2, 0, 0, 0, 2, 0] if kernel == "bias" else [0, 0, 2, 0, 0, 0, 2])
    qkv = student.pretrained.blocks[0].attn.qkv.weight.grad
    assert qkv is not None and torch.isfinite(qkv).all() and qkv.abs().max() > 0


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 96, 200), (100, 96, 200), (300, 768, 2304),
                                   (130, 4096, 1024),
                                   # ViT-g's qkv, proj, SwiGLU w12 and w3
                                   (300, 1536, 4608), (300, 1536, 1536), (300, 1536, 8192),
                                   (300, 4096, 1536)])
def test_w8a8_kernel_matches_plain(cuda_device, m, k, n, dtype, with_bias):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=gen, device=cuda_device) * 3).to(dtype)
    x[0, :6] = torch.tensor([127.0, 0.5, -0.5, 2.5, -3.5, 1.5])  # scale 1: exact ties
    if m > 1:
        x[1] = 0  # an all-zero row
    weight = torch.randn(n, k, generator=gen, device=cuda_device) * k ** -0.5
    bias = torch.randn(n, generator=gen, device=cuda_device) if with_bias else None
    with recording() as rec:
        got = w8a8_matmul(x, weight, bias)
    assert rec.counts.get("kernels/w8a8") == 1
    wq, ws = quantize_weight(weight)
    ref = w8a8_reference(x, wq, ws, bias, dtype)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, ref)


# kernel 9 off its tiles: 128 x 256 output tiles, 128-byte K chunks
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [96, 4096])
@pytest.mark.parametrize("n", [200, 264, 520])
@pytest.mark.parametrize("m", [1, 100, 129, 257])
def test_w8a8_kernel_edges_match_plain(cuda_device, m, n, k, dtype, with_bias):
    test_w8a8_kernel_matches_plain(cuda_device, m, k, n, dtype, with_bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_kernel_quantizes_near_ties_exactly(cuda_device, dtype):
    """Rows whose quotients x / s fall on half-integers (exactly, at
    power-of-two scales; fp32 also a few ulps off, at random scales): the
    kernel's quantization, a product checked against the ties, equals the
    plain version's true division bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    m, k, n = 96, 256, 264
    half = torch.randint(-127, 127, (m, k), generator=gen, device=cuda_device) + 0.5
    if dtype == torch.bfloat16:
        scale = 2.0 ** torch.randint(-8, 4, (m, 1), generator=gen, device=cuda_device)
        x = half * scale
    else:
        scale = torch.rand(m, 1, generator=gen, device=cuda_device) * 0.1 + 1e-3
        ulps = torch.randint(-3, 4, (m, k), generator=gen, device=cuda_device)
        x = half * scale * (1 + ulps * 2.0 ** -23)
    x[:, 0] = 127 * scale[:, 0]  # the row's amax: its scale is `scale`
    x = x.to(dtype)
    weight = torch.randn(n, k, generator=gen, device=cuda_device) * k ** -0.5
    got = w8a8_matmul(x, weight)
    wq, ws = quantize_weight(weight)
    assert torch.equal(got, w8a8_reference(x, wq, ws, None, dtype))


def test_w8a8_kernel_refuses(cuda_device):
    x = torch.randn(4, 100, device=cuda_device)
    w = torch.randn(32, 100, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8_matmul(x, w)
    with pytest.raises(TypeError):
        w8a8_matmul(x[:, :96].half(), w[:, :96])
    with pytest.raises(RuntimeError, match="forward-only"):
        w8a8_matmul(x[:, :96], w[:, :96].requires_grad_())


def test_quant_model_runs_w8a8_kernel(cuda_device):
    """A tiny int8_pallas model in bf16 runs kernel 9 four times per block,
    and its depth correlates with the unquantized model's."""
    cfg = model_config("depthanything-base")
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                              out_indices=(0, 0, 1, 1))
    cfg = dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128))
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, quant="int8_pallas")
    plain = create_model(cfg, dtype=torch.bfloat16, device=cuda_device)
    x = torch.rand(2, 3, 98, 98, device=cuda_device)
    with torch.no_grad(), recording() as rec:
        depth, _ = model(x)
        ref, _ = plain(x)
    assert _launched(rec, "w8a8") == [8]
    assert torch.isfinite(depth).all()
    corr = torch.corrcoef(torch.stack([depth.float().flatten(), ref.float().flatten()]))[0, 1]
    assert corr > 0.99


def test_register_swiglu_model_runs_kernels(cuda_device):
    """A tiny ``depthanything-giant-reg`` (registers, SwiGLU, pre-norm taps,
    DPT features 384) in bf16 runs kernel 1 once a block, kernel 2 at C =
    384 once, and, with ``int8_pallas``, kernel 9 at qkv, proj, w12 and w3
    of every block; its int8 depth follows the unquantized depth. Width 192:
    SwiGLU's hidden width is then 512, within kernel 9's K % 16 (at 128 it
    would be 344)."""
    cfg = model_config("depthanything-giant-reg")
    enc = dataclasses.replace(cfg.encoder, embed_dim=192, depth=2, num_heads=3,
                              out_indices=(0, 0, 1, 1))
    cfg = dataclasses.replace(cfg, encoder=enc, out_channels=(32, 64, 96, 128))
    plain = create_model(cfg, dtype=torch.bfloat16, device=cuda_device)
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, seed=None,
                         quant="int8_pallas")
    model.load_state_dict(plain.state_dict())
    x = torch.rand(2, 3, 98, 98, device=cuda_device)
    names = ("attention", "tail", "w8a8")
    with torch.no_grad():
        with recording() as rec:
            ref, feat = plain(x)
        assert _launched(rec, *names) == [2, 1, 0]
        with recording() as rec:
            depth, _ = model(x)
        assert _launched(rec, *names) == [2, 1, 8]
    assert feat.shape == (2, 49, 192) and torch.isfinite(depth).all()
    corr = torch.corrcoef(torch.stack([depth.float().flatten(), ref.float().flatten()]))[0, 1]
    assert corr > 0.99


def _tiny_train_pair(cuda_device, lora_rank=0, use_ssf=False):
    """A tiny bf16 student (plain tail, optionally with LoRA and SSF) and a
    wider teacher, as the Trainer builds them."""
    base = model_config("depthanything-base")

    def cfg(dim, heads, **enc_kw):
        enc = dataclasses.replace(base.encoder, embed_dim=dim, depth=2, num_heads=heads,
                                  out_indices=(0, 0, 1, 1), **enc_kw)
        return dataclasses.replace(base, encoder=enc, features=64,
                                   out_channels=(32, 64, 96, 128))

    student = create_model(cfg(128, 2, lora_rank=lora_rank, use_ssf=use_ssf),
                           dtype=torch.bfloat16, device=cuda_device, fused_tail=False)
    teacher = create_model(dataclasses.replace(cfg(192, 3), trailing_head_relu=False,
                                               interp_to_input=True),
                           dtype=torch.bfloat16, device=cuda_device, seed=1)
    return student, teacher.requires_grad_(False)


def test_two_view_step_launches(cuda_device):
    """A two-view step (image-folder batches) runs the student forward on
    both views: kernel 1 in the teacher's 2 blocks and twice in the
    student's 2, kernel 3 in both student backwards, kernel 2 once (the
    teacher's tail) and kernel 4 twice (the HDN medians); LG is non-zero."""
    student, teacher = _tiny_train_pair(cuda_device)
    state = create_train_state(student, OptimizerConfig(lr=1e-4, warmup_steps=0))
    step = make_train_step(student, [teacher], LossConfig(), views_shared=False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g, l = (torch.randn(2, 3, 98, 98, generator=gen, device=cuda_device) for _ in range(2))
    for _ in range(2):
        with recording() as rec:
            metrics = step(state, 0, g, l)
            torch.cuda.synchronize()
        assert _launched(rec, "attention", "attention_bwd", "tail", "select") == [
            2 + 2 * 2, 2 * 2, 1, 2]
        assert float(metrics["lg"]) > 0 and torch.isfinite(metrics["grad_norm"])


def test_adapter_only_step_keeps_frozen_parameters(cuda_device):
    """Adapter-only steps on the card in bf16: every frozen parameter is
    bit-equal after two steps, every adapter moved, and the reported
    gradient norm (every gradient) exceeds the adapters' own."""
    student, teacher = _tiny_train_pair(cuda_device, lora_rank=4, use_ssf=True)
    state = create_train_state(student, OptimizerConfig(lr=1e-3, warmup_steps=0,
                                                        schedule="none"), adapter_only=True)
    step = make_train_step(student, [teacher], LossConfig(), views_shared=True)
    frozen = {n: p.detach().clone() for n, p in student.named_parameters()
              if not is_adapter_name(n)}
    adapters = [p.detach().clone() for p in adapter_parameters(student)]
    x = torch.rand(2, 3, 98, 98, generator=torch.Generator(device=cuda_device).manual_seed(1),
                   device=cuda_device)
    for _ in range(2):
        metrics = step(state, 0, x, x)
        assert float(metrics["grad_norm"]) > float(state.last_norm)
    for name, p in student.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
    assert all(not torch.equal(p.detach(), a)
               for p, a in zip(adapter_parameters(student), adapters))


def _tiny_model(cuda_device, preset="depthanything-base", **kw):
    base = model_config(preset)
    window = {"window_size": 3} if base.encoder.window_size else {}
    enc = dataclasses.replace(base.encoder, embed_dim=128, depth=2, num_heads=2,
                              out_indices=(0, 0, 1, 1), **window)
    cfg = dataclasses.replace(base, encoder=enc, features=64, out_channels=(32, 64, 96, 128))
    return create_model(cfg, dtype=torch.bfloat16, device=cuda_device, **kw)


@pytest.mark.parametrize("case", ["plain", "window", "int8_pallas"])
def test_exported_program_launches_the_kernels(cuda_device, tmp_path, case):
    """An exported bf16 program, saved and loaded, runs the kernels through
    their ops (each kernel's count ticks once a call; the windowed model's
    PEG conv too) and gives the eager depth bit for bit; the
    weights-as-arguments program likewise."""
    from distill_any_depth_tpu_torch.utils import export

    if case == "window":
        model, size = _tiny_model(cuda_device, "depthanything-base-window"), 126
        attn = "attention_bias"
    else:
        model, size = _tiny_model(cuda_device, quant="int8_pallas" if case == "int8_pallas"
                                  else "none"), 98
        attn = "attention"
    x = torch.rand(2, 3, size, size, device=cuda_device)
    with torch.no_grad():
        want = model(x)[0].float()
    names = (attn, "tail", "w8a8", "peg_conv")
    expect = [2, 1, 8 if case == "int8_pallas" else 0, 1 if case == "window" else 0]
    programs = [export.load_exported(export.export_forward(model, size, 2))]
    blob = export.export_forward_with_params(model, str(tmp_path / "w.safetensors"), size, 2)
    programs.append(export.load_exported_with_params(blob, str(tmp_path / "w.safetensors"),
                                                     cuda_device))
    for run in programs:
        with recording() as rec:
            got = run(x)
            torch.cuda.synchronize()
        assert _launched(rec, *names) == expect
        assert torch.equal(got, want)


def test_remat_step_launches_and_matches(cuda_device):
    """A bf16 step with student remat recomputes the student's 2 blocks
    (kernel 1 twice more, kernel 3 as before); its loss equals the step
    without remat bit for bit and its gradient norm within 1e-5."""
    x = torch.rand(2, 3, 98, 98, generator=torch.Generator(device=cuda_device).manual_seed(2),
                   device=cuda_device)
    seen = []
    for remat in (False, True):
        student, teacher = _tiny_train_pair(cuda_device)
        student.pretrained.remat = remat
        state = create_train_state(student, OptimizerConfig(lr=1e-4, warmup_steps=0))
        step = make_train_step(student, [teacher], LossConfig(), views_shared=True)
        with recording() as rec:
            metrics = step(state, 0, x, x)
            torch.cuda.synchronize()
        seen.append((_launched(rec, "attention", "attention_bwd", "tail", "select"),
                     {k: float(v) for k, v in metrics.items()}))
    (plain_counts, plain), (remat_counts, remat) = seen
    assert plain_counts == [4, 2, 1, 2] and remat_counts == [6, 2, 1, 2]
    assert remat["total"] == plain["total"]
    assert abs(remat["grad_norm"] - plain["grad_norm"]) <= 1e-5 * plain["grad_norm"]


def _frames(n, seed, h=60, w=80):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_predict_reads_back_into_pinned_memory(cuda_device):
    """``predict``'s output lives in page-locked memory and equals the
    model's depth bit for bit; four outputs held across eight more calls (the
    benchmark's sample of calls) keep their values; every byte read back is
    counted as pinned."""
    model, size = _tiny_model(cuda_device), 98
    frames = _frames(4, 0)
    out = infer.predict(model, frames, size, batch_size=4)
    assert torch.from_numpy(out).is_pinned()
    x = torch.cat([preprocess_on_device(torch.from_numpy(f)[None].to(cuda_device), size,
                                        dtype=model.dtype) for f in frames])
    with torch.no_grad():
        want = model(x)[0].float().cpu()
    assert torch.equal(torch.from_numpy(out), want)
    held = [infer.predict(model, _frames(4, 1 + k), size, batch_size=4) for k in range(4)]
    copies = [h.copy() for h in held]
    for k in range(8):
        got = infer.predict(model, _frames(4, 5 + k), size, batch_size=4)
        assert not any(np.shares_memory(got, h) for h in held)
    for h, c in zip(held, copies):
        np.testing.assert_array_equal(h, c)
    with recording() as rec:
        out = infer.predict(model, _frames(5, 13), size, batch_size=4)
    assert rec.counts["predict/readback_bytes"] == out.nbytes
    assert rec.counts["predict/readback_pinned_bytes"] == rec.counts["predict/readback_bytes"]


def _param_casts(model, x) -> int:
    """The fp32 parameter tensors a forward casts to bf16: each parameter
    of each layer call, the pos-embed of a grid other than the base one, and
    the cls and register tokens."""
    calls = []
    hooks = [m.register_forward_hook(lambda mod, *_: calls.append(mod))
             for m in model.modules() if isinstance(m, (vit.Linear, vit.LayerNorm, vit.Conv2d,
                                                        vit.LayerScale, ConvTranspose2d))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    enc = model.pretrained
    own = [enc.pos_embed, enc.cls_token, enc.register_tokens]
    return (sum(len(list(m.parameters(recurse=False))) for m in calls)
            + sum(t is not None for t in own))


def _bf16_copies(forward) -> int:
    """Launches of ATen's fp32 -> bf16 copy kernel in ``forward()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "bfloat16_copy_kernel" in e.key)


def test_inference_mode_forward_casts_no_weights(cuda_device):
    """A ViT-B 392^2 bs8 forward under ``torch.inference_mode()``, after its
    first call, launches none of the fp32 -> bf16 casts of the parameters
    that a ``no_grad`` forward launches (each forward's other casts, the
    input's, are in both), and its depth equals the ``no_grad`` depth bit for
    bit."""
    model = create_model("depthanything-base", dtype=torch.bfloat16, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 3, 392, 392, generator=gen, device=cuda_device)
    casts = _param_casts(model, x)

    def forward(mode):
        with mode():
            return model(x)[0]

    want = forward(torch.no_grad)
    plain = _bf16_copies(lambda: forward(torch.no_grad))
    forward(torch.inference_mode)
    with recording() as rec:
        kept = _bf16_copies(lambda: forward(torch.inference_mode))
    assert casts > 100 and plain - kept == casts, (plain, kept, casts)
    assert rec.counts.get("derived/miss", 0) == 0 and rec.counts["derived/hit"] > 100
    assert torch.equal(forward(torch.inference_mode), want)


# ------------------------------------------------------------------ the PEG conv
# (B, C, H, W): the windowed teacher's 1036^2 and 518^2 grids at bs8, a
# non-square grid, a grid wider than 80 (the direct kernel in bf16) and an odd
# width (one column a copy)
PEG_SHAPES = [(8, 768, 74, 74), (8, 768, 37, 37), (2, 40, 12, 16), (3, 24, 20, 90), (2, 8, 13, 17)]
# |got - ref| against the fp32 plain version on the same inputs, per element:
# bf16, one rounding of the output (2^-8 of its size) plus the fp32 sums'
# error in another order (1e-5 of the terms' size, |conv|(|x|) + |b| + |x|);
# fp32, the sums' error alone. Readings on an H100: 0.0011-0.0021 and
# 3e-7-8e-7 of the terms' size
PEG_SUM_TOL = 1e-5


def _peg_inputs(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(b, c, h, w, generator=gen, device=device).to(dtype)
    weight = (torch.randn(c, 1, 37, 37, generator=gen, device=device) / 37).to(dtype)
    bias = torch.randn(c, generator=gen, device=device).to(dtype)
    return x, weight, bias


def _peg_held(got, x, weight, bias):
    from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv_reference

    f = [t.float() for t in (x, weight, bias)]
    ref = peg_conv_reference(*f)
    terms = (torch.nn.functional.conv2d(f[0].abs(), f[1].abs(), None, padding=18,
                                        groups=x.shape[1])
             + f[2].abs().view(1, -1, 1, 1) + f[0].abs())
    err = (got.float() - ref).abs()
    rounding = 2.0 ** -8 * ref.abs() if got.dtype == torch.bfloat16 else 0.0
    assert got.dtype == x.dtype and got.shape == x.shape and torch.isfinite(got).all()
    assert (err <= rounding + PEG_SUM_TOL * terms).all(), float((err / terms).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PEG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_peg_conv_kernel_matches_plain_in_fp32(cuda_device, shape, dtype):
    """The kernel (one launch, ``kernels/peg_conv`` once; the launch's error
    checked by the wrapper) against the plain version in fp32 with TF32
    off, and against its own second call bit for bit."""
    from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv

    x, weight, bias = _peg_inputs(shape, dtype, cuda_device, seed=sum(shape))
    with recording() as rec:
        got = peg_conv(x, weight, bias)
        torch.cuda.synchronize()
    assert _launched(rec, "peg_conv") == [1]
    _peg_held(got, x, weight, bias)
    assert torch.equal(peg_conv(x, weight, bias), got)


@pytest.mark.parametrize("grid", [74, 37])
def test_peg_conv_kernel_reads_a_token_major_view(cuda_device, grid):
    """``PosConv``'s NCHW view of token-major ``[B, N, C]`` tokens (what a
    contiguous token stream gives) takes the kernel on its NCHW copy: the
    same output bit for bit as the NCHW-contiguous input."""
    from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv

    x, weight, bias = _peg_inputs((8, 768, grid, grid), torch.bfloat16, cuda_device, seed=grid)
    tokens = x.flatten(2).transpose(1, 2).contiguous()
    view = tokens.transpose(1, 2).reshape(x.shape)
    assert not view.is_contiguous()
    assert torch.equal(peg_conv(view, weight, bias), peg_conv(x, weight, bias))


# (B, C, H, W) of the backward: the 1036^2 grid at a small batch and at the
# windowed student's bs16, its 518^2 grid at bs16, a grid of the 48-wide
# products, one wider than 80 (the direct d(weight) in bf16) and an odd width
PEG_BWD_SHAPES = [(2, 64, 74, 74), (16, 768, 74, 74), (16, 768, 37, 37), (2, 40, 12, 16),
                  (3, 24, 20, 90), (2, 8, 13, 17)]


def _peg_grads_held(got, g, x, weight):
    """d(x), d(weight), d(bias) against ATen's backward of the plain version
    on the same inputs in fp32: one rounding of each in bf16 (2^-8 of its
    size) plus ``PEG_SUM_TOL`` of its terms' size (the same backward of the
    inputs' magnitudes)."""
    from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv_backward

    f = [t.float() for t in (g, x, weight)]
    want = peg_conv_backward(*f)
    terms = peg_conv_backward(*[t.abs() for t in f])
    for name, a, b, t in zip(("dx", "dweight", "dbias"), got, want, terms):
        assert a.dtype == x.dtype and a.shape == b.shape and torch.isfinite(a).all(), name
        err = (a.float() - b).abs()
        rounding = 2.0 ** -8 * b.abs() if a.dtype == torch.bfloat16 else 0.0
        assert (err <= rounding + PEG_SUM_TOL * t).all(), (name, float((err / t).max()))


def _peg_cotangent(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PEG_BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_peg_conv_gradients_are_atens(cuda_device, shape, dtype):
    """Through the autograd Function (the forward kernel, then the backward
    kernels): d(x), d(weight), d(bias) follow ATen's backward of the plain
    version in fp32 (``_peg_grads_held``); one ``kernels/peg_conv`` for the
    forward and one ``kernels/peg_conv_bwd`` for the backward; a second
    backward call gives the same bits."""
    from distill_any_depth_tpu_torch.ops.peg_conv import _backward, peg_conv

    x, weight, bias = _peg_inputs(shape, dtype, cuda_device, seed=sum(shape))
    g = _peg_cotangent(shape, dtype, cuda_device, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    with recording() as rec:
        peg_conv(*leaves).backward(g)
        torch.cuda.synchronize()
    assert _launched(rec, "peg_conv", "peg_conv_bwd") == [1, 1]
    got = [t.grad for t in leaves]
    _peg_grads_held(got, g, x, weight)
    again = _backward(g, x, weight, (True, True, True))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_peg_conv_backward_computes_the_gradients_asked_for(cuda_device):
    """Each mask of ``needs_input_grad`` gives the full call's gradients bit
    for bit where asked and None elsewhere, in one launch count; an input
    that alone requires a gradient gets it through autograd; an empty batch
    gives zero d(weight) and d(bias)."""
    from distill_any_depth_tpu_torch.ops.peg_conv import _backward, peg_conv

    x, weight, bias = _peg_inputs((2, 64, 74, 74), torch.bfloat16, cuda_device, seed=3)
    g = _peg_cotangent(x.shape, x.dtype, cuda_device, seed=4)
    full = _backward(g, x, weight, (True, True, True))
    for mask in [(True, False, False), (False, True, False), (False, False, True),
                 (False, True, True)]:
        with recording() as rec:
            got = _backward(g, x, weight, mask)
        assert _launched(rec, "peg_conv_bwd") == [1], mask
        for m, a, b in zip(mask, got, full):
            assert torch.equal(a, b) if m else a is None, mask
    for k in range(3):
        leaves = [t.clone().requires_grad_(j == k) for j, t in enumerate((x, weight, bias))]
        peg_conv(*leaves).backward(g)
        assert [t.grad is None for t in leaves] == [j != k for j in range(3)]
        assert torch.equal(leaves[k].grad, full[k])
    _, dw, db = _backward(g[:0], x[:0], weight, (False, True, True))
    assert not dw.any() and not db.any()


def test_peg_conv_kernel_refuses_other_dtypes(cuda_device):
    from distill_any_depth_tpu_torch.ops.peg_conv import peg_conv

    for dtype in (torch.float16, torch.float64):
        x, weight, bias = _peg_inputs((1, 4, 8, 8), dtype, cuda_device, seed=0)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            peg_conv(x, weight, bias)


@pytest.mark.parametrize("res", [98, 518])
def test_windowed_forward_launches_the_peg_conv_once(cuda_device, res):
    """The windowed teacher (full width, 2 blocks) runs the PEG conv kernel
    once a forward, at the 7x7 and the 37x37 grid, and its PosConv output
    follows the plain version within the kernel's tolerance."""
    cfg = model_config("depthanything-base-window")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, depth=2))
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, seed=0)
    x = torch.rand(2, 3, res, res, device=cuda_device)
    with torch.no_grad(), recording() as rec:
        depth, _ = model(x)
        torch.cuda.synchronize()
    assert _launched(rec, "peg_conv") == [1]
    assert depth.shape == (2, res, res) and torch.isfinite(depth).all()
    pos = model.pretrained.pos_conv
    g = res // 14
    tokens = torch.randn(2, g * g, 768, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        got = pos(tokens, g, g)
    conv = pos.proj[0]
    xin = tokens.transpose(1, 2).reshape(2, 768, g, g)
    _peg_held(got.transpose(1, 2).reshape(xin.shape), xin, conv.weight.to(torch.bfloat16),
              conv.bias.to(torch.bfloat16))
