"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip without a CUDA device (decided inside each test
through the ``cuda_device`` fixture). On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerances as in
``chip_smoke.py``: fp32 differs by summation order only; bf16 by a few
bf16 roundings placed differently (attention and its backward: max |err| /
(1 + |ref|); tail: max |err| / max |ref|); the select is exact.
"""
import dataclasses

import pytest
import torch

from distill_any_depth_tpu_torch.configs import model_config
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops.dpt_tail import fused_dpt_tail, tail_reference
from distill_any_depth_tpu_torch.ops.flash_attention import (
    mha_flash_packed,
    mha_packed_reference,
    packed_attention_backward,
)
from distill_any_depth_tpu_torch.ops.stats import _order_bits, kth_select, kth_select_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 6e-3)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 197])
def test_attention_kernel_matches_plain(cuda_device, n, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(2, n, 3 * 128, generator=gen, device=cuda_device).to(dtype)
    before = mha_flash_packed.launches
    got = mha_flash_packed(qkv, 2)
    assert mha_flash_packed.launches == before + 1
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
    before = packed_attention_backward.launches
    mha_flash_packed(qkv.requires_grad_(), 2).sum().backward()
    assert packed_attention_backward.launches == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.5e-2)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 197])
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
    before = kth_select.launches
    got = kth_select(u, k)
    assert kth_select.launches == before + 1
    assert torch.equal(got, kth_select_reference(u, k))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c,ht,wt,oh,ow,relu", [
    (64, 5, 7, 42, 28, True), (128, 8, 8, 28, 28, False), (256, 3, 4, 17, 30, True),
])
def test_tail_kernel_matches_plain(cuda_device, c, ht, wt, oh, ow, relu, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(c)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=cuda_device) * scale

    cm = c // 2
    w = dict(k1=rnd(3, 3, c, cm, scale=(9 * c) ** -0.5), b1=rnd(cm, scale=0.1),
             k2=rnd(3, 3, cm, 32, scale=(9 * cm) ** -0.5), b2=rnd(32, scale=0.1),
             kd=rnd(32, 1, scale=32 ** -0.5), bd=rnd(1, scale=0.1))
    t = rnd(2, ht, wt, c).to(dtype)
    got = fused_dpt_tail(t, (oh, ow), trailing_relu=relu, **w)
    ref = tail_reference(t, (oh, ow), trailing_relu=relu, **w)
    assert got.dtype == dtype and got.shape == (2, oh, ow)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


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
    attn, tail = mha_flash_packed.launches, fused_dpt_tail.launches
    depth, _ = model(x)
    assert (mha_flash_packed.launches - attn, fused_dpt_tail.launches - tail) == (2, 1)
    assert depth.shape == (1, 98, 98) and torch.isfinite(depth).all()
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        model(x)
    student = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, fused_tail=False)
    attn, tail, bwd = (mha_flash_packed.launches, fused_dpt_tail.launches,
                       packed_attention_backward.launches)
    student(x)[0].mean().backward()
    assert (mha_flash_packed.launches - attn, fused_dpt_tail.launches - tail,
            packed_attention_backward.launches - bwd) == (2, 0, 2)
    assert torch.isfinite(student.pretrained.blocks[0].attn.qkv.weight.grad).all()
