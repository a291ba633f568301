"""The SwiGLU gate (``ops/swiglu``): ``silu(x1) * x2`` on w12's packed
output.

On the CPU (tier-1) the wrapper is the plain ``F.silu(x1) * x2``, bit for
bit, forward and gradient; ``models/vit.SwiGLU`` runs it and counts no
kernel launch there; its shape checks raise; ``torch.export`` keeps it as
one ``dad::swiglu_gate`` node.

On a card (marked ``cuda``, skipped without one; ``python -m pytest
--noconftest tests/test_torch_swiglu_gate.py -m cuda``) the kernels are held
against the plain expression computed in fp32 from the same inputs: bf16
within one bf16 ulp of it (the kernel rounds once, from fp32), fp32 within
the error of ``__expf`` (a few parts in 1e7 at the inputs' size, times the
products that follow); shapes: ViT-g's 518^2 bs8 ``[10960, 8192]``, a tp=2
rank's ``[10960, 4096]``, a single row with h = 12 (the scalar loop in bf16,
the vector loop in fp32), an odd h, and an x12 that is not 16-byte aligned.
Every launch, forward or backward, counts ``kernels/gate`` once: a ViT-g
forward 40 times, once a block; other dtypes raise.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.configs import model_config
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.models.vit import SwiGLU
from distill_any_depth_tpu_torch.ops.swiglu import (
    swiglu_gate,
    swiglu_gate_backward,
    swiglu_gate_reference,
)
from distill_any_depth_tpu_torch.utils.profiling import recording


def _plain(x12):
    x1, x2 = x12.chunk(2, dim=-1)
    return F.silu(x1) * x2


def _x12(shape, dtype, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (2 * torch.randn(shape, generator=gen, device=device)).to(dtype)


# ------------------------------------------------------------------ CPU (tier-1)
CPU_SHAPES = [(3, 5, 24), (1, 24), (7, 26), (2, 3, 4, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_cpu_gate_is_the_plain_expression_bit_for_bit(shape, dtype):
    x = _x12(shape, dtype, seed=sum(shape))
    g = _x12((*shape[:-1], shape[-1] // 2), dtype, seed=1)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    out, ref = swiglu_gate(a), _plain(b)
    assert out.shape == (*shape[:-1], shape[-1] // 2) and out.dtype == dtype
    assert torch.equal(out, ref)
    assert torch.equal(swiglu_gate_reference(x), ref.detach())
    out.backward(g)
    ref.backward(g)
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("shape", [(4, 7), (2, 3, 1), ()])
def test_gate_refuses_an_odd_last_dimension(shape):
    with pytest.raises(ValueError, match=r"\[\.\.\., 2h\]"):
        swiglu_gate(torch.zeros(shape))


def test_gate_refuses_other_devices():
    with pytest.raises(ValueError, match="device meta"):
        swiglu_gate(torch.zeros(2, 8, device="meta"))


def test_backward_kernel_entry_checks_its_operands():
    x12 = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="shape"):
        swiglu_gate_backward(torch.zeros(3, 8), x12)
    with pytest.raises(ValueError, match="dtype"):
        swiglu_gate_backward(torch.zeros(3, 4, dtype=torch.bfloat16), x12)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swiglu_gate_backward(torch.zeros(3, 4), x12)


@pytest.mark.parametrize("dim", [48, 96])
def test_swiglu_module_runs_the_gate_and_counts_no_launch_on_the_cpu(dim):
    torch.manual_seed(dim)
    mod = SwiGLU(dim, 4.0)
    x = torch.randn(2, 9, dim)
    with torch.no_grad(), recording() as rec:
        got = mod(x)
        x1, x2 = mod.w12(x).chunk(2, dim=-1)
        want = mod.w3(F.silu(x1) * x2)
    assert torch.equal(got, want)
    hidden = mod.w3.in_features
    assert rec.counts == {"vit/swiglu_gate_bytes": 2 * 9 * 3 * hidden * 4}


def test_export_keeps_the_gate_as_one_op():
    torch.manual_seed(0)
    mod = SwiGLU(48, 4.0).eval()
    x = torch.randn(2, 5, 48)
    with torch.no_grad():  # as utils/export traces
        program = torch.export.export(mod, (x,))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("dad.swiglu_gate.default") == 1
    assert not [op for op in ops if "silu" in op]
    with torch.no_grad():
        assert torch.equal(program.module()(x), mod(x))


# ------------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (x12 shape, how it is laid out): ViT-g 518^2 bs8, a tp=2 rank's w12 output,
# a single row with h = 12, an odd h, and an x12 one element off 16 bytes
CARD_CASES = [((10960, 8192), "dense"), ((10960, 4096), "dense"), ((1, 24), "dense"),
              ((37, 26), "dense"), ((129, 64), "offset")]
FP32_RTOL, FP32_ATOL = 4e-6, 1e-6  # __expf, then the products


def _card_x12(shape, dtype, seed, layout):
    x = _x12((shape[0] * shape[1] + 1,), dtype, seed, "cuda")
    x = x[1:] if layout == "offset" else x[:-1]
    return x.view(shape)


def _bf16_ulp(ref):
    """One bf16 ulp at each fp32 value (its exponent's 2^-7)."""
    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126))) - 7)


def _held(got, ref, dtype, atol=FP32_ATOL):
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        err = (got.float() - ref).abs()
        assert (err <= _bf16_ulp(ref)).all(), float((err / _bf16_ulp(ref)).max())
    else:
        torch.testing.assert_close(got, ref, rtol=FP32_RTOL, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout", CARD_CASES)
def test_gate_kernel_matches_plain_in_fp32(cuda_device, shape, layout, dtype):
    x12 = _card_x12(shape, dtype, seed=shape[1], layout=layout)
    assert (x12.data_ptr() % 16 != 0) == (layout == "offset")
    with recording() as rec:
        got = swiglu_gate(x12)
    assert rec.counts["kernels/gate"] == 1
    _held(got, swiglu_gate_reference(x12.float()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout", CARD_CASES)
def test_gate_backward_matches_autograd_of_plain(cuda_device, shape, layout, dtype):
    """d(x12) against autograd of the plain expression on the fp32 inputs.
    fp32: near x1 = -1.28, where silu' is 0, 1 + x1 (1 - s) cancels, so the
    absolute error is that of its terms, times |g x2| (up to about 30)."""
    x12 = _card_x12(shape, dtype, seed=shape[1] + 1, layout=layout).requires_grad_()
    g = _x12((shape[0], shape[1] // 2), dtype, seed=shape[0], device="cuda")
    with recording() as rec:
        swiglu_gate(x12).backward(g)
    assert rec.counts["kernels/gate"] == 2  # the forward's and the backward's
    ref_in = x12.detach().float().requires_grad_()
    swiglu_gate_reference(ref_in).backward(g.float())
    _held(x12.grad, ref_in.grad, dtype, atol=3e-5)


@pytest.mark.cuda
def test_gate_kernel_refuses_other_dtypes(cuda_device):
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            swiglu_gate(torch.zeros(4, 16, dtype=dtype, device=cuda_device))


@pytest.mark.cuda
def test_vitg_forward_launches_the_gate_once_a_block(cuda_device):
    """The ViT-g preset (40 blocks) at 98^2 bs1: one gate launch a block,
    counted by ``kernels/gate``."""
    cfg = model_config("depthanything-giant")
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda_device, seed=None)
    x = torch.rand(1, 3, 98, 98, device=cuda_device)
    with torch.no_grad(), recording() as rec:
        depth, _ = model(x)
    torch.cuda.synchronize()
    blocks = cfg.encoder.depth
    assert blocks == 40
    assert rec.counts["kernels/gate"] == blocks
    assert rec.counts["vit/swiglu_gate_bytes"] == blocks * 3 * (7 * 7 + 1) * 4096 * 2
    assert depth.shape == (1, 98, 98)


@pytest.mark.cuda
def test_tiny_swiglu_model_on_the_card_follows_the_cpu(cuda_device):
    """A tiny ``depthanything-giant`` in fp32 on the card (the gate kernel in
    every block) against the same weights on the CPU (the plain gate)."""
    cfg = model_config("depthanything-giant")
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=2, num_heads=2,
                              out_indices=(0, 0, 1, 1))  # kernel 1 takes head dim 64
    cfg = dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128))
    cpu = create_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    card = create_model(cfg, dtype=torch.float32, device=cuda_device, seed=None)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 56, 70)
    with torch.no_grad(), recording() as rec:
        want, _ = cpu(x)
        got, _ = card(x.to(cuda_device))
    assert rec.counts["kernels/gate"] == 2
    assert float((got.cpu() - want).norm() / want.norm()) < 1e-4
