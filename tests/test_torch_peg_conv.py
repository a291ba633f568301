"""The PEG conv (``ops/peg_conv``): ``conv37(x) + bias + x``, CPVT's
position encoding in ``models/vit.PosConv``.

On the CPU (tier-1) the wrapper is the plain ``F.conv2d(x, w, b, padding=18,
groups=C) + x``: ``PosConv`` gives the expression it ran before the kernel
(``proj(x) + x``) bit for bit, forward and gradients, at the windowed
teacher's 37x37 (518^2) and 74x74 (1036^2) grids and a non-square one, at C
= 768 and an odd C, in bf16 and fp32; the plain backward (ATen's
convolution backward plus the identity's gradient) is autograd's of the
plain expression bit for bit; the algebra the backward kernels rest on
holds in fp32 (d(x) is the forward on the cotangent with the kernel flipped
and no bias; d(weight) is the sum along the diagonals of products over the
rows of planes stacked with 18 zero rows between images, chunk by chunk,
and d(bias) the sum of the cotangent); the shape checks raise;
``torch.export`` keeps the op as one ``dad::peg_conv`` node; and every
``__global__`` function of ``csrc/peg_conv.cu`` falls in
``portbench.tracing``'s class "depthwise conv (PEG, ATen)", whose device
time ``peg_roofline.infer`` and ``peg_roofline.train`` read.

On a card (marked ``cuda``): ``tests/test_torch_cuda.py``.
"""
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from distill_any_depth_tpu_torch.models.vit import PosConv
from distill_any_depth_tpu_torch.ops.peg_conv import (
    PAD,
    TAPS,
    peg_conv,
    peg_conv_backward,
    peg_conv_reference,
)
from distill_any_depth_tpu_torch.utils.profiling import recording
from portbench.tracing import classify

CSRC = Path(__file__).resolve().parents[1] / "distill_any_depth_tpu_torch" / "csrc"
GRIDS = [(37, 37), (74, 74), (12, 16)]
DTYPES = [torch.bfloat16, torch.float32]


def _module(c: int, dtype: torch.dtype, seed: int) -> PosConv:
    torch.manual_seed(seed)
    mod = PosConv(c)
    with torch.no_grad():  # the fan-in init is tiny against a 37 x 37 kernel's sum
        mod.proj[0].weight.normal_(0.0, 1.0 / TAPS)
        mod.proj[0].bias.normal_()
    return mod.to(dtype)


def _tokens(b, gh, gw, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, gh * gw, c, generator=gen).to(dtype)


def _before(mod: PosConv, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """``PosConv.forward`` before the kernel: the module's conv plus x."""
    b, _, c = tokens.shape
    x = tokens.transpose(1, 2).reshape(b, c, gh, gw).contiguous()
    return (mod.proj(x) + x).flatten(2).transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [768, 40])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cpu_pos_conv_is_the_expression_before_the_kernel_bit_for_bit(grid, c, dtype):
    gh, gw = grid
    mod = _module(c, dtype, seed=gh + c)
    tokens = _tokens(1, gh, gw, c, dtype, seed=gw)
    with torch.no_grad(), recording() as rec:
        got = mod(tokens, gh, gw)
    want = _before(mod, tokens, gh, gw).detach()
    assert got.shape == (1, gh * gw, c) and got.dtype == dtype
    assert torch.equal(got, want)
    x = tokens.transpose(1, 2).reshape(1, c, gh, gw)
    w, b = mod.proj[0].weight, mod.proj[0].bias
    assert torch.equal(peg_conv(x, w, b), F.conv2d(x, w, b, padding=PAD, groups=c) + x)
    # the plain version launches nothing; the span's counter stays
    assert rec.counts == {"vit/pos_conv_flops": 2 * c * TAPS * TAPS * gh * gw}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cpu_pos_conv_gradients_are_the_plain_expressions(grid, dtype):
    """d(tokens), d(weight), d(bias) through ``PosConv`` equal those of the
    expression before the kernel, bit for bit."""
    gh, gw = grid
    c = 40
    mods = [_module(c, dtype, seed=7) for _ in range(2)]
    tokens = _tokens(2, gh, gw, c, dtype, seed=gh)
    g = _tokens(2, gh, gw, c, dtype, seed=gw + 1)
    t_new, t_old = tokens.clone().requires_grad_(), tokens.clone().requires_grad_()
    mods[0](t_new, gh, gw).backward(g)
    _before(mods[1], t_old, gh, gw).backward(g)
    assert torch.equal(t_new.grad, t_old.grad)
    for new, old in zip(mods[0].parameters(), mods[1].parameters()):
        assert torch.equal(new.grad, old.grad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_kernel_backward_is_autograd_of_the_plain_version(grid, dtype):
    """``peg_conv_backward``, the autograd Function's backward on the card,
    against autograd of ``conv(x) + bias + x``, bit for bit, with each
    gradient left out where its input needs none."""
    gh, gw = grid
    c = 40
    mod = _module(c, dtype, seed=3)
    x = _tokens(2, gh, gw, c, dtype, seed=5).transpose(1, 2).reshape(2, c, gh, gw).contiguous()
    g = _tokens(2, gh, gw, c, dtype, seed=6).transpose(1, 2).reshape(2, c, gh, gw).contiguous()
    w, b = mod.proj[0].weight.detach(), mod.proj[0].bias.detach()
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    peg_conv_reference(xa, wa, ba).backward(g)
    dx, dw, db = peg_conv_backward(g, x, w)
    assert torch.equal(dx, xa.grad) and torch.equal(dw, wa.grad) and torch.equal(db, ba.grad)
    dx, dw, db = peg_conv_backward(g, x, w, (False, True, False))
    assert dx is None and db is None and torch.equal(dw, wa.grad)


def _fp32_inputs(grid, dtype, c=8, b=3, seed=0):
    """x, the cotangent and the weight, drawn in ``dtype`` and computed in
    fp32 from those values."""
    gh, gw = grid
    mod = _module(c, dtype, seed=seed)
    x = _tokens(b, gh, gw, c, dtype, seed=seed + 1).transpose(1, 2).reshape(b, c, gh, gw)
    g = _tokens(b, gh, gw, c, dtype, seed=seed + 2).transpose(1, 2).reshape(b, c, gh, gw)
    return x.float(), g.float(), mod.proj[0].weight.detach().float()


# |got - want| against fp32 sums in another order, of the terms' size
SUM_TOL = 1e-5


def _within_sums(got, want, terms):
    assert got.shape == want.shape
    assert ((got - want).abs() <= SUM_TOL * terms).all(), float(((got - want).abs() / terms).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_dx_is_the_forward_on_the_cotangent_with_the_kernel_flipped(grid, dtype):
    """d(x) of ``conv(x) + bias + x`` (ATen's convolution backward plus the
    cotangent) is ``conv(g, flip(w)) + 0 + g``: what the backward kernel
    launches the forward's kernels for."""
    x, g, w = _fp32_inputs(grid, dtype)
    want = peg_conv_backward(g, x, w, (True, False, False))[0]
    got = peg_conv_reference(g, w.flip(-2, -1), torch.zeros(w.shape[0]))
    terms = peg_conv_reference(g.abs(), w.abs().flip(-2, -1), torch.zeros(w.shape[0]))
    _within_sums(got, want, terms)


def _stacked(t: torch.Tensor) -> torch.Tensor:
    """``t [n, C, H, W]`` as the kernel's planes ``[C, 18 + n (H + 18), W]``:
    18 zero rows above and after each image."""
    n, c, _, w = t.shape
    gap = t.new_zeros(c, PAD, w)
    return torch.cat([gap] + [part for k in range(n) for part in (t[k], gap)], dim=1)


def _dw_the_kernels_way(x: torch.Tensor, g: torch.Tensor, nb: int):
    """d(weight) and d(bias) as the kernel computes them, in fp32: for each
    chunk of ``nb`` images and kernel row i, ``P_i[x', x] = sum over the
    stacked rows p of X[p + i - 18, x'] G[p, x]``, the sum of P_i along
    its diagonal j - 18 for tap (i, j), and the chunks added in order."""
    b, c, h, w = x.shape
    dw, db = x.new_zeros(c, TAPS, TAPS), x.new_zeros(c)
    for b0 in range(0, b, nb):
        xs, gs = _stacked(x[b0:b0 + nb]), _stacked(g[b0:b0 + nb])
        rows = xs.shape[1] - 2 * PAD  # g's rows 18 .. from the first image to the last gap
        part = x.new_zeros(c, TAPS, TAPS)
        for i in range(TAPS):
            p = torch.einsum("cpm,cpn->cmn", xs[:, i:i + rows], gs[:, PAD:PAD + rows])
            for j in range(TAPS):
                part[:, i, j] = torch.diagonal(p, offset=PAD - j, dim1=1, dim2=2).sum(-1)
        dw += part
        db += gs.sum((1, 2))
    return dw.unsqueeze(1), db


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_dw_by_diagonal_sums_of_row_products_is_atens(grid, nb):
    """d(weight) by the kernel's algebra (the planes stacked with 18 zero
    rows between images, products over their rows shifted by the kernel
    row, sums along the diagonals, chunks of ``nb`` images) and d(bias) as
    the chunks' sums of the cotangent equal ATen's convolution backward
    within fp32 summation order."""
    x, g, w = _fp32_inputs(grid, torch.bfloat16, c=4, b=3, seed=nb)
    _, want_dw, want_db = peg_conv_backward(g, x, w, (False, True, True))
    dw, db = _dw_the_kernels_way(x, g, nb)
    _, terms_dw, terms_db = peg_conv_backward(g.abs(), x.abs(), w, (False, True, True))
    _within_sums(dw, want_dw, terms_dw)
    _within_sums(db, want_db, terms_db)


def test_peg_conv_refuses_other_shapes_and_devices():
    x = torch.zeros(1, 4, 6, 6)
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        peg_conv(x[0], torch.zeros(4, 1, TAPS, TAPS), torch.zeros(4))
    with pytest.raises(ValueError, match="weight must be"):
        peg_conv(x, torch.zeros(4, 1, 3, 3), torch.zeros(4))
    with pytest.raises(ValueError, match="weight must be"):
        peg_conv(x, torch.zeros(4, 1, TAPS, TAPS), torch.zeros(5))
    meta = torch.zeros(1, 4, 6, 6, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        peg_conv(meta, torch.zeros(4, 1, TAPS, TAPS, device="meta"),
                 torch.zeros(4, device="meta"))


def test_export_keeps_the_peg_conv_as_one_op():
    mod = _module(24, torch.float32, seed=1).eval()
    tokens = _tokens(2, 6, 9, 24, torch.float32, seed=2)
    with torch.no_grad():  # as utils/export traces
        program = torch.export.export(mod, (tokens, 6, 9))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("dad.peg_conv.default") == 1
    assert not [op for op in ops if "convolution" in op or "conv2d" in op]
    with torch.no_grad():
        assert torch.equal(program.module()(tokens, 6, 9), mod(tokens, 6, 9))


def _global_functions(source: str) -> list[str]:
    """The names of the ``__global__`` functions a CUDA source defines."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       source)
    assert names, "no __global__ function found"
    return names


@pytest.mark.parametrize("suffix", ["", "<80, 3>(__nv_bfloat16 const*, int)", "<float>"])
def test_every_kernel_name_falls_in_the_peg_class_of_the_trace(suffix):
    """The trace's class "depthwise conv (PEG, ATen)" (``portbench.tracing``)
    holds each kernel the forward and the backward launch, as the profiler
    names it (the demangled name, in its anonymous namespace, with its
    template arguments): ``peg_roofline.infer`` and ``peg_roofline.train``
    read that class's device time. Five: the forward's two, d(weight)'s two
    and their reduction."""
    names = _global_functions((CSRC / "peg_conv.cu").read_text())
    assert len(names) == 5
    for name in names:
        assert classify(f"void (anonymous namespace)::{name}{suffix}") == \
            "depthwise conv (PEG, ATen)", name
