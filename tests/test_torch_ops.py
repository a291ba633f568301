"""The port's kernel modules on the CPU against the JAX package.

On the CPU, ``mha_flash_packed`` and ``fused_dpt_tail`` take their plain
versions; these are held against the JAX Pallas kernels run in interpret
mode and against the JAX plain references, in fp32, on the same numpy
inputs. Tolerances (stated per test) cover fp32 summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distill_any_depth_tpu.ops import resize as jresize
from distill_any_depth_tpu.ops.attention import mha_reference
from distill_any_depth_tpu.ops.dpt_tail import fused_dpt_tail as jax_fused_dpt_tail_v1
from distill_any_depth_tpu.ops.dpt_tail import fused_dpt_tail_v2
from distill_any_depth_tpu.ops.dpt_tail import tail_reference as jax_tail_reference
from distill_any_depth_tpu.ops.flash_attention import mha_flash_packed as jax_mha_flash_packed
from distill_any_depth_tpu_torch.ops import resize
from distill_any_depth_tpu_torch.ops.attention import multi_head_attention_packed
from distill_any_depth_tpu_torch.ops.derived import Derived
from distill_any_depth_tpu_torch.ops.dpt_tail import (
    fused_dpt_tail,
    pack_conv_weight,
    prepare_weights,
    tail_reference,
)
from distill_any_depth_tpu_torch.ops.flash_attention import (
    mha_flash_packed,
    mha_packed_reference,
)
from distill_any_depth_tpu_torch.utils.profiling import recording

ATTN_TOL = 2e-6  # fp32, |err| <= ATTN_TOL * (1 + |ref|)
# fp32, |err| <= TAIL_TOL * (1 + |ref|): two 3x3 convs summed in another
# order (K up to 9*256) and fp32 resize coordinates (see the resize tests)
TAIL_TOL = 1e-5


def _jax_unpacked_reference(qkv: np.ndarray, h: int) -> np.ndarray:
    b, n, c3 = qkv.shape
    q5 = jnp.asarray(qkv).reshape(b, n, 3, h, c3 // 3 // h)
    return np.asarray(mha_reference(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2])).reshape(b, n, -1)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= tol * (1 + np.abs(ref))), np.abs(got - ref).max()


@pytest.mark.parametrize("n", [64, 197])
def test_attention_matches_jax(n):
    h = 2
    qkv = np.random.RandomState(n).randn(2, n, 3 * h * 64).astype(np.float32)
    got = mha_flash_packed(torch.from_numpy(qkv), h).numpy()
    _close(got, np.asarray(jax_mha_flash_packed(jnp.asarray(qkv), h, interpret=True)), ATTN_TOL)
    _close(got, _jax_unpacked_reference(qkv, h), ATTN_TOL)
    np.testing.assert_array_equal(
        multi_head_attention_packed(torch.from_numpy(qkv), h).numpy(), got)


def test_attention_strongly_negative_logits():
    """Every real logit below -60: the plain version stays exact. Held
    against ``mha_reference`` only; the JAX packed kernel's closed-form pad
    correction is the one at fault in this regime."""
    h, n = 2, 197
    rng = np.random.RandomState(7)
    qkv = 0.01 * rng.randn(1, n, 3 * h * 64).astype(np.float32)
    u = np.full(64, 0.125, np.float32)  # unit norm
    qkv[:, :, : h * 64] += np.tile(80 * u, h)
    qkv[:, :, h * 64 : 2 * h * 64] -= np.tile(10 * u, h)
    qkv[:, :, 2 * h * 64 :] = rng.randn(1, n, h * 64)
    s = qkv[0, :, :64] @ qkv[0, :, h * 64 : h * 64 + 64].T * 0.125
    assert s.max() < -60
    got = mha_flash_packed(torch.from_numpy(qkv), h).numpy()
    assert np.isfinite(got).all()
    # logits near -100 carry ~100 * 2**-24 * a few of fp32 rounding, and the
    # two packages scale at different points ((q*scale).k against
    # (q.k)*scale): each probability moves by ~1e-5 relative
    _close(got, _jax_unpacked_reference(qkv, h), 5e-5)


def test_attention_rounds_probabilities_to_input_dtype():
    """bf16 input: exp(s - m) is rounded to bf16 before PV and the sum is
    taken over the rounded values, as in the TPU kernel."""
    h, n = 1, 33
    qkv = torch.from_numpy(np.random.RandomState(3).randn(1, n, 3 * 64).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    got = mha_packed_reference(qkv, h)
    assert got.dtype == torch.bfloat16
    q, k, v = (x.float() for x in qkv[0].view(n, 3, 64).unbind(1))
    s = q @ k.T * 0.125
    e = torch.exp(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    want = ((e @ v) / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)


def _tail_params(rng, ci, cm):
    return dict(
        k1=rng.randn(3, 3, ci, cm) * 0.05, b1=rng.randn(cm) * 0.1,
        k2=rng.randn(3, 3, cm, 32) * 0.05, b2=rng.randn(32) * 0.1,
        kd=rng.randn(32, 1) * 0.2, bd=rng.randn(1) * 0.1,
    )


@pytest.mark.parametrize(
    "ht,wt,ci,cm,oh,ow,trailing",
    [
        (8, 8, 128, 64, 28, 28, True),
        (16, 12, 128, 64, 56, 42, False),  # non-square, teacher-style tail
        (14, 14, 256, 128, 98, 98, True),  # ViT-L channel widths
        (7, 3, 64, 32, 29, 66, False),  # ragged, non-square, off the patch grid
    ],
)
def test_tail_matches_jax(ht, wt, ci, cm, oh, ow, trailing):
    rng = np.random.RandomState(0)
    p = {k: v.astype(np.float32) for k, v in _tail_params(rng, ci, cm).items()}
    t = (rng.randn(2, ht, wt, ci) * 0.5).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_kernel = fused_dpt_tail_v2(jnp.asarray(t), (oh, ow), trailing_relu=trailing,
                                    interpret=True, **jp)
    want_plain = jax_tail_reference(jnp.asarray(t), (oh, ow), trailing_relu=trailing,
                                    dtype=jnp.float32, **jp)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tail_reference(torch.from_numpy(t), (oh, ow), trailing_relu=trailing, **tp)
    assert got.shape == (2, oh, ow)
    _close(got.numpy(), want_kernel, TAIL_TOL)
    _close(got.numpy(), want_plain, TAIL_TOL)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    with recording() as rec:
        np.testing.assert_array_equal(
            fused_dpt_tail(torch.from_numpy(t), (oh, ow), trailing_relu=trailing, **tp).numpy(),
            got.numpy())
    assert "kernels/tail" not in rec.counts


def test_v1_tail_served_by_kernel_2_entry():
    """TPU kernel 10, the v1 tail ``fused_dpt_tail`` (superseded by v2, the
    same function and contract), has no kernel of its own in the port: the
    port's ``fused_dpt_tail`` serves it (kernel 2 on the card, the plain
    version on the CPU). Held against the JAX v1 kernel in interpret mode
    at the first shape of ``tests/test_dpt_tail.py``, fp32."""
    ht, wt, ci, cm, oh, ow, trailing = 8, 8, 128, 64, 28, 28, True
    rng = np.random.RandomState(1)
    p = {k: v.astype(np.float32) for k, v in _tail_params(rng, ci, cm).items()}
    t = (rng.randn(2, ht, wt, ci) * 0.5).astype(np.float32)
    want = jax_fused_dpt_tail_v1(jnp.asarray(t), (oh, ow), trailing_relu=trailing,
                                 interpret=True, **{k: jnp.asarray(v) for k, v in p.items()})
    got = fused_dpt_tail(torch.from_numpy(t), (oh, ow), trailing_relu=trailing,
                         **{k: torch.from_numpy(v) for k, v in p.items()})
    assert got.shape == (2, oh, ow)
    _close(got.numpy(), want, TAIL_TOL)


def test_cpu_wrappers_count_no_launch():
    qkv = torch.randn(1, 10, 3 * 64)
    with recording() as rec:
        mha_flash_packed(qkv, 1)
    assert "kernels/attention" not in rec.counts


def unpack_conv_weight(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """The inverse of ``pack_conv_weight``: the HWIO ``[3, 3, cin, C_out]``
    weight."""
    cout = packed.shape[0]
    w = packed.reshape(cout, -1, 9, 64).permute(2, 1, 3, 0).reshape(9, -1, cout)
    return w[:, :cin].reshape(3, 3, cin, cout)


@pytest.mark.parametrize("c", [64, 128, 256])
def test_conv_weight_packing_unpacks_to_hwio(c):
    """The bf16 kernel's packed weights ([C_out, chunks x 9 taps x 64]) of
    conv1 (C -> C/2) and conv2 (C/2 -> 32) hold every HWIO weight, rounded to
    bf16, at (n, (cc * 9 + tap) * 64 + ci), with zeros for the channels a
    64-wide chunk pads, and unpack to the HWIO weights exactly."""
    rng = np.random.RandomState(c)
    for cin, cout in ((c, c // 2), (c // 2, 32)):
        k = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32))
        packed = pack_conv_weight(k)
        chunks = -(-cin // 64)
        assert packed.dtype == torch.bfloat16 and packed.shape == (cout, chunks * 9 * 64)
        assert packed.is_contiguous()
        kb = k.to(torch.bfloat16)
        assert torch.equal(unpack_conv_weight(packed, cin), kb)
        blocks = packed.reshape(cout, chunks, 9, 64)
        for tap in (0, 4, 8):
            dy, dx = divmod(tap, 3)
            for cc in range(chunks):
                width = min(64, cin - 64 * cc)
                assert torch.equal(blocks[:, cc, tap, :width],
                                   kb[dy, dx, 64 * cc:64 * cc + width].t())
                assert not blocks[:, cc, tap, width:].any()


def test_weight_cache_repacks_only_after_an_inplace_change():
    """A ``Derived`` of ``prepare_weights`` (the DPT head keeps one) packs
    the weights once and hands back the same tensors until a weight changes
    in place, then packs the new values."""
    rng = np.random.RandomState(0)
    ws = [torch.from_numpy(a.astype(np.float32)) for a in _tail_params(rng, 128, 64).values()]
    cache = Derived()

    def get(dtype):
        return cache.get(ws, lambda: prepare_weights(*ws, dtype), dtype)

    first = get(torch.bfloat16)
    assert get(torch.bfloat16) is first
    assert torch.equal(unpack_conv_weight(first.w1, 128), ws[0].to(torch.bfloat16))
    with torch.no_grad():
        ws[0].mul_(2.0)
    second = get(torch.bfloat16)
    assert second is not first
    assert torch.equal(unpack_conv_weight(second.w1, 128), ws[0].to(torch.bfloat16))
    assert get(torch.bfloat16) is second
    # another compute dtype is another packing: the fp32 kernel's plain matrices
    plain = get(torch.float32)
    assert plain.w1.dtype == torch.float32 and torch.equal(plain.w1, ws[0].reshape(-1, 64))


@pytest.mark.parametrize("in_size,out_size", [(8, 16), (112, 224), (224, 392), (5, 9)])
def test_bilinear_align_corners_matches_matrix(in_size, out_size):
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2, in_size, 3).astype(np.float32))
    got = F.interpolate(x, size=(out_size, 3), mode="bilinear", align_corners=True)
    m = resize.resize_matrix(in_size, out_size, "bilinear", True)
    np.testing.assert_array_equal(m, jresize.resize_matrix(in_size, out_size, "bilinear", True))
    # torch computes the source coordinate in fp32 (the matrix in fp64): the
    # interpolation weight moves by up to ~in_size * 2**-24
    np.testing.assert_allclose(got.numpy(), np.einsum("Oi,bcix->bcOx", m, x.numpy()),
                               rtol=0, atol=in_size * 2.0**-20)


@pytest.mark.parametrize("g", [7, 16, 28, 37, 50])
def test_bicubic_scale_factor_matches_matrix(g):
    """The pos-embed resampling: bicubic with the +0.1 scale factor."""
    base = 37
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, base, 4).astype(np.float32))
    scale = (g + 0.1) / base
    got = F.interpolate(x, scale_factor=(scale, 1.0), mode="bicubic", align_corners=False)
    assert got.shape[2] == g
    m = resize.resize_matrix(base, g, "bicubic", False, scale)
    # fp32 source coordinates in torch against fp64 in the matrix
    np.testing.assert_array_equal(m, jresize.resize_matrix(base, g, "bicubic", False, scale))
    np.testing.assert_allclose(got.numpy(), np.einsum("Oi,bcix->bcOx", m, x.numpy()),
                               rtol=0, atol=1e-5)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from distill_any_depth_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_loaded", {})
    target = _build._target("dpt_tail")
    assert target.parent == tmp_path and target.name.startswith("libdpt_tail_")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("dpt_tail")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not any(tmp_path.iterdir())


def test_kernel_bounds_cover_every_tpu_kernel():
    """``cli/kernel_bounds`` (the bounds of PERF.md's kernel table) gives every
    one of the ten kernels, and row 12 (the PEG conv, no TPU kernel), a
    positive bound, masked attention below dense."""
    from distill_any_depth_tpu_torch.cli import kernel_bounds

    table = kernel_bounds.bounds()
    assert {name.split()[0] for name in table} == {str(i) for i in range(1, 11)} | {"12"}
    assert all(row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")
               for row in table.values())
    for name, row in table.items():
        if "dense_gop" in row:
            assert row["gop"] <= row["dense_gop"], name


def test_kernel_bounds_peg_rows_are_the_benchmarks_counts():
    """Row 12's forward at the windowed teacher's bs8 and its backward at the
    student's bs16 count what ``portbench/window_flops`` and
    ``window_train_flops`` count: the step's forward, d(x) and d(weight) are
    the forward row at bs16 plus the backward row, and the backward is bound
    by operations (0.3726 ms at 1036^2)."""
    from distill_any_depth_tpu_torch.cli import kernel_bounds
    from portbench import window_flops, window_train_flops

    table = kernel_bounds.bounds()
    fwd = table["12 PEG conv fwd, window 1036^2 bs8"]
    ops, nbytes = window_flops.pos_conv(8, 768, 74, 74)
    assert (fwd["gop"], fwd["mb"]) == pytest.approx((ops / 1e9, nbytes / 1e6))
    for g in (74, 37):
        bwd = table[f"12 PEG conv bwd, d(x) + d(weight), window student {14 * g}^2 bs16"]
        step_ops, step_bytes = window_train_flops.pos_conv_step(16, 768, g, g)
        ops, nbytes = window_flops.pos_conv(16, 768, g, g)
        assert (bwd["gop"], bwd["mb"]) == pytest.approx(((step_ops - ops) / 1e9,
                                                         (step_bytes - nbytes) / 1e6))
        assert bwd["bound_by"] == "operations"
    assert round(table["12 PEG conv bwd, d(x) + d(weight), window student 1036^2 bs16"]
                 ["bound_ms"], 4) == 0.3726


@pytest.mark.parametrize("shape,m", [("ViT-L 518^2 bs8", 10960), ("ViT-L 392^2 bs8", 6280),
                                     ("ViT-B 392^2 bs8", 6280)])
def test_kernel_bounds_w8a8_shapes(shape, m):
    """Kernel 9's bound at each of the four encoder GEMMs of the three shapes
    the paths run; at ViT-L 518^2 qkv it is the 34.8 us of the kernel's
    header (69.0 GOP at 1979 TOP/s int8, above its 92 MB at 3.35 TB/s)."""
    from distill_any_depth_tpu_torch.cli import kernel_bounds

    table = kernel_bounds.bounds()
    dim = 768 if "ViT-B" in shape else 1024
    for gemm, (k, n) in {"qkv": (dim, 3 * dim), "proj": (dim, dim), "fc1": (dim, 4 * dim),
                         "fc2": (4 * dim, dim)}.items():
        row = table[f"9 W8A8 GEMM, {shape} {gemm}"]
        assert row["gop"] == pytest.approx(2 * m * k * n / 1e9)
        assert row["mb"] == pytest.approx((m * k * 2 + k * n + n * 8 + m * n * 2) / 1e6)
    if shape == "ViT-L 518^2 bs8":
        qkv = table["9 W8A8 GEMM, ViT-L 518^2 bs8 qkv"]
        assert qkv["bound_by"] == "operations"
        assert round(qkv["bound_ms"] * 1e3, 1) == 34.8
