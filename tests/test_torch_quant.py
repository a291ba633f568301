"""The port's int8 W8A8 path (``ops/quant``, ``ops/quant_matmul``, the
``quant`` models and ``cli/pseudo_label``) against the JAX package, on the
CPU.

The JAX W8A8 kernel runs in interpret mode, as ``tests/test_quant.py`` runs
it. On the CPU, ``w8a8_matmul`` is its plain version (``w8a8_reference``).
The quantization and the GEMMs are held to equality: the same true
divisions, round-half-even, exact integer products and the dequant in the
same order. The models are held to stated tolerances (see the tests).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.ops.preprocess import preprocess_on_device as jax_preprocess
from distill_any_depth_tpu.ops.quant import QuantDense
from distill_any_depth_tpu.ops.quant import int8_matmul as jax_int8_matmul
from distill_any_depth_tpu.ops.quant import quantize_cols as jax_quantize_cols
from distill_any_depth_tpu.ops.quant import quantize_rows as jax_quantize_rows
from distill_any_depth_tpu.ops.quant_matmul import w8a8_matmul as jax_w8a8_matmul
from distill_any_depth_tpu_torch.cli import pseudo_label
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.models.vit import QuantLinear
from distill_any_depth_tpu_torch.ops.quant import int8_matmul, quantize_cols
from distill_any_depth_tpu_torch.ops.quant_matmul import (
    int_product_exact,
    quantize_rows,
    quantize_weight,
    w8a8_matmul,
    w8a8_reference,
)
from distill_any_depth_tpu_torch.utils.convert import params_from_jax
from distill_any_depth_tpu_torch.utils.profiling import recording

BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits: one ulp is at most 2^-7 relative


def _rows() -> np.ndarray:
    """Rows over five decades of scale, an all-zero row, and rows whose
    amax is 127 (scale exactly 1) holding the ties +-0.5, 1.5, 2.5, -3.5."""
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 96) * rng.uniform(1e-3, 1e2, size=(64, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :6] = [127.0, 0.5, -0.5, 2.5, -3.5, 1.5]
    x[2] = -x[1]
    return x


def test_quantize_rows_equals_jax():
    x = _rows()
    xq, s = quantize_rows(torch.from_numpy(x))
    jq, js = jax_quantize_rows(jnp.asarray(x))
    assert xq.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (64, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # true divisions: a product with 1/127 would differ in the last bit
    want = np.maximum(np.abs(x).max(axis=1), np.float32(1e-8)) / np.float32(127.0)
    np.testing.assert_array_equal(s.numpy()[:, 0], want)
    assert xq[1, :6].tolist() == [127, 0, 0, 2, -4, 2]  # ties round to even
    assert xq[2, :6].tolist() == [-127, 0, 0, -2, 4, -2]
    assert not xq[0].any() and s[0, 0] == np.float32(1e-8) / np.float32(127)
    # bf16 input is quantized from its fp32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jax_quantize_rows(jnp.asarray(x, jnp.bfloat16))
    for a, b in zip(quantize_rows(xb), jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantize_cols_equals_jax():
    """Per output channel, with an outlier column that must not poison the
    others (``tests/test_quant.py``)."""
    w = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    w[:, 3] *= 100.0
    w[:, 7] = np.clip(w[:, 7], -1, 1)
    w[:3, 7] = [127.0, 2.5, -3.5]  # scale exactly 1: ties round to even
    wq, s = quantize_cols(torch.from_numpy(w))
    jq, js = jax_quantize_cols(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert wq[:3, 7].tolist() == [127, 2, -4]
    recon = wq.numpy().astype(np.float32) * s.numpy()[None, :]
    assert (np.abs(recon - w).max(axis=0) / np.abs(w).max(axis=0) < 0.01).all()
    # the Linear's [out, in] weight quantizes to the transpose
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq.numpy(), wq.numpy().T)
    np.testing.assert_array_equal(ts.numpy(), s.numpy())


def test_int_product_is_exact():
    """The plain version's fp64 product of int8 values equals the int64
    product, at the largest partial sums the models reach (K = 4096, every
    product +-127^2)."""
    rng = np.random.RandomState(2)
    xq = torch.from_numpy(rng.choice([-127, 127], size=(8, 4096)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, size=(16, 4096)).astype(np.int8))
    wq[0] = xq[0]  # a dot product of 4096 * 127^2
    got = int_product_exact(xq, wq)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), (xq.long() @ wq.long().t()).numpy())
    assert got[0, 0] == 4096 * 127 ** 2


def _gemm_inputs(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(100, 96).astype(np.float32)  # M and N not multiples of any tile
    w = (rng.randn(96, 200) * 0.05).astype(np.float32)  # JAX layout [in, out]
    b = rng.randn(200).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("lead", [(100,), (2, 50)], ids=["2d", "batched"])
def test_gemms_equal_jax_fp32(with_bias, lead):
    """fp32, at non-multiple shapes (M=100, K=96, N=200) and with a leading
    batch dimension: the port's ``int8_matmul`` and ``w8a8_matmul`` (the
    plain version on the CPU) equal JAX ``int8_matmul`` bit for bit (in
    fp32 the two routes are the same arithmetic). Against JAX
    ``w8a8_matmul`` in interpret mode the bits differ, by XLA's CPU
    compiler, not by the kernel: it turns the kernel's ``amax / 127.0`` into
    a product with 1/127 (reproduced exactly in numpy; 4 of the 100 row
    scales move by one ulp) and fuses the last product and the bias add
    into one FMA. Reading: at most 4.8e-7 (one ulp), held at 1e-6."""
    x, w, b = _gemm_inputs()
    x = x.reshape(*lead, 96)
    bias_j = jnp.asarray(b) if with_bias else None
    bias_t = torch.from_numpy(b) if with_bias else None
    weight = torch.from_numpy(w.T.copy())  # the port's [out, in]
    want_xla = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), bias_j,
                                          out_dtype=jnp.float32))
    want_pallas = np.asarray(jax_w8a8_matmul(jnp.asarray(x), jnp.asarray(w), bias_j,
                                             out_dtype=jnp.float32, interpret=True))
    tx = torch.from_numpy(x)
    got_xla = int8_matmul(tx, weight, bias_t, torch.float32)
    with recording() as rec:
        got_pallas = w8a8_matmul(tx, weight, bias_t, torch.float32)
    assert "kernels/w8a8" not in rec.counts  # a CPU tensor runs the plain version
    assert got_xla.shape == got_pallas.shape == (*lead, 200)
    np.testing.assert_array_equal(got_xla.numpy(), want_xla)
    np.testing.assert_array_equal(got_pallas.numpy(), want_xla)
    assert np.abs(got_pallas.numpy() - want_pallas).max() <= 1e-6
    wq, ws = quantize_weight(weight)
    np.testing.assert_array_equal(
        w8a8_reference(tx.reshape(-1, 96), wq, ws, bias_t, torch.float32).numpy(),
        got_pallas.reshape(-1, 200).numpy())


def test_gemms_bf16_match_jax():
    """bf16 ``[2, 50, 96]`` input, no bias, bf16 output. Both port routes
    equal JAX ``int8_matmul`` bit for bit (without a bias the routes
    coincide). Against JAX ``w8a8_matmul`` in interpret mode, whose row
    scales XLA's CPU compiler computes as a product with 1/127 (see
    ``test_gemms_equal_jax_fp32``), a moved scale flips some roundings:
    0.47% of the outputs differ, by at most 3.9e-3 (one bf16 ulp of a
    value in [0.5, 1)). Held at one bf16 ulp of unit scale, 2^-7 (1 +
    |ref|), inside ``tests/test_quant.py``'s 0.01."""
    x, w, _ = _gemm_inputs(4)
    xb = x.reshape(2, 50, 96)
    want_xla = np.asarray(jax_int8_matmul(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(w), None),
                          np.float32)
    want_pallas = np.asarray(jax_w8a8_matmul(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(w), None,
                                             interpret=True), np.float32)
    tx = torch.from_numpy(xb).to(torch.bfloat16)
    weight = torch.from_numpy(w.T.copy())
    for got in (int8_matmul(tx, weight), w8a8_matmul(tx, weight)):
        assert got.dtype == torch.bfloat16 and got.shape == (2, 50, 200)
        g = got.float().numpy()
        np.testing.assert_array_equal(g, want_xla)
        assert np.all(np.abs(g - want_pallas) <= BF16_ULP * (1 + np.abs(want_pallas)))


def test_bias_placement_differs_between_routes():
    """The ``int8`` route adds the bias after the cast, in the output dtype;
    kernel 9's plain version before it, in fp32 (as the JAX package)."""
    x, w, b = _gemm_inputs(5)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    weight, bias = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    wq, ws = quantize_weight(weight)
    xq, xs = quantize_rows(tx)
    y = int_product_exact(xq, wq).float() * xs * ws
    np.testing.assert_array_equal(int8_matmul(tx, weight, bias).float().numpy(),
                                  (y.bfloat16() + bias.bfloat16()).float().numpy())
    np.testing.assert_array_equal(w8a8_matmul(tx, weight, bias).float().numpy(),
                                  (y + bias).bfloat16().float().numpy())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_quant_linear_matches_quant_dense(impl):
    """``QuantLinear`` loads ``QuantDense``'s (= ``nn.Dense``'s) params,
    transposed to ``[out, in]``, with ``strict=True`` and computes the same
    output."""
    x = np.random.RandomState(6).randn(3, 7, 96).astype(np.float32)
    qd = QuantDense(200, dtype=jnp.float32, impl=impl)
    params = jax.tree_util.tree_map(np.asarray,
                                    qd.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(qd.apply({"params": params}, jnp.asarray(x)))
    ql = QuantLinear(96, 200, mode={"xla": "int8", "pallas": "int8_pallas"}[impl])
    ql.load_state_dict({"weight": torch.from_numpy(params["kernel"].T.copy()),
                        "bias": torch.from_numpy(params["bias"].copy())}, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(ql(torch.from_numpy(x)).numpy(), want)


def test_quant_linear_is_inference_only():
    ql = QuantLinear(32, 16, mode="int8_pallas")
    x = torch.randn(4, 32)
    with pytest.raises(RuntimeError, match="inference-only"):
        ql(x)
    with torch.no_grad():
        ql(x)
    ql.requires_grad_(False)
    assert ql(x).shape == (4, 16)
    with pytest.raises(ValueError, match="mode"):
        QuantLinear(32, 16, mode="int4")


def test_quant_linear_requantizes_after_in_place_update():
    """The cached int8 weight follows the weight's version counter."""
    torch.manual_seed(0)
    ql = QuantLinear(32, 16).requires_grad_(False)
    x = torch.randn(4, 32)
    first = ql(x)
    wq, ws = ql.quantized_weight()
    assert ql.quantized_weight()[0] is wq  # cached while the weight is unchanged
    with torch.no_grad():
        ql.weight.mul_(-2.0)
    wq2, ws2 = ql.quantized_weight()
    np.testing.assert_array_equal(wq2.numpy(), -wq.numpy())
    np.testing.assert_array_equal(ws2.numpy(), 2 * ws.numpy())
    fresh = QuantLinear(32, 16).requires_grad_(False)
    fresh.load_state_dict(ql.state_dict())
    np.testing.assert_array_equal(ql(x).numpy(), fresh(x).numpy())
    assert not torch.equal(ql(x), first)


def _tiny(models, teacher: bool):
    cfg = models["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=4, num_heads=2,
                              out_indices=(0, 1, 2, 3))
    head = dict(trailing_head_relu=False, interp_to_input=True) if teacher else {}
    return dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(32, 64, 96, 128),
                               **head)


def _pair(quant: str, teacher: bool = False):
    jcfg, tcfg = _tiny(JAX_MODELS, teacher), _tiny(MODELS, teacher)
    plain = jax_create_model(jcfg, attn_impl="reference")
    params = jax.jit(plain.init)(jax.random.PRNGKey(0), jnp.zeros((1, 98, 98, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jmodel = jax_create_model(jcfg, attn_impl="reference", quant=quant)
    tmodel = create_model(tcfg, device="cpu", quant=quant)
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return plain, jmodel, params, tmodel


# fp32 model level, |err| <= MODEL_TOL * (1 + |ref|). Readings on these tiny
# models: depth 1.4e-6 and features 7.5e-7 (both quant modes), pseudo-label
# depth 2.0e-6 (none and int8_pallas): the unquantized models' summation-order
# differences. An activation an ulp apart between the frameworks can also flip
# a round-half-even tie of its int8 value, which moves that GEMM output by one
# scale step (about 4e-5 at these widths) and shows none here; the limit
# leaves room for a couple of such flips.
MODEL_TOL = 1e-4


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_quant_model_matches_jax(quant):
    """The tiny DepthModel with int8 GEMMs against JAX ``create_model(quant)``
    on the same params, and the int8 model against the unquantized one
    within the JAX package's bounds (``tests/test_quant.py``: corr > 0.99,
    feature error < 5%)."""
    plain, jmodel, params, tmodel = _pair(quant)
    x = np.random.RandomState(1).rand(2, 98, 126, 3).astype(np.float32)
    jdepth, jfeat = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad(), recording() as rec:
        depth, feat = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert "kernels/w8a8" not in rec.counts
    for got, want in ((depth, jdepth), (feat, jfeat)):
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= MODEL_TOL * (1 + np.abs(want))), \
            np.abs(got - want).max()
    d0, f0 = (np.asarray(a) for a in jax.jit(plain.apply)({"params": params}, jnp.asarray(x)))
    assert np.abs(feat.numpy() - f0).mean() / np.abs(f0).mean() < 0.05
    assert np.corrcoef(depth.numpy().ravel(), d0.ravel())[0, 1] > 0.99


def _images(n, size, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("quant", ["none", "int8_pallas"])
def test_label_batches_matches_jax_forward(quant):
    """``label_batches`` (batches of 2, the last one padded with a zero
    image) against the JAX pseudo-label forward (device preprocessing, the
    model, fp32 depth) of the 3 images at once, with the teacher head's
    flags, fp32; tolerance ``MODEL_TOL``."""
    _, jmodel, params, tmodel = _pair(quant, teacher=True)
    ims = _images(3, 98)
    got = pseudo_label.label_batches(tmodel, ims, 98, batch_size=2)
    x = jax_preprocess(jnp.asarray(ims), 98, dtype=jnp.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x)[0], np.float32)
    assert got.shape == (3, 98, 98) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL * (1 + np.abs(want).max()))
    # the padding leaves the real images alone (each row is quantized on its
    # own; the CPU's fp32 kernels block a batch of 1 and of 2 differently)
    alone = pseudo_label.label_batches(tmodel, ims[2:], 98, 1)
    np.testing.assert_allclose(alone, got[2:], rtol=0, atol=MODEL_TOL * (1 + np.abs(want).max()))


def test_pseudo_label_cli_writes_depth_maps(tmp_path):
    """``main`` over 3 PNGs in batches of 2 at the 196 bucket (56 snaps up to
    it): one float32 depth map and one uint16 PNG per image, none for the
    zero image that pads the last batch."""
    cv2 = pytest.importorskip("cv2")
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.RandomState(7)
    for i in range(3):
        cv2.imwrite(str(inp / f"im{i}.png"), rng.randint(0, 256, (60, 80, 3), dtype=np.uint8))
    (inp / "notes.txt").write_text("not an image")
    out = tmp_path / "out"
    written = pseudo_label.main([
        "--arch_name", "depthanything-small", "--input", str(inp), "--output_dir", str(out),
        "--processing_res", "56", "--batch_size", "2", "--dtype", "float32",
        "--quant", "int8_pallas", "--save_png16", "--device", "cpu",
    ])
    assert [os.path.basename(p) for p in written] == [f"im{i}_depth.npy" for i in range(3)]
    assert sorted(os.listdir(out)) == sorted(
        [f"im{i}_depth.npy" for i in range(3)] + [f"im{i}_depth.png" for i in range(3)])
    for i, path in enumerate(written):
        d = np.load(path)
        assert d.shape == (196, 196) and d.dtype == np.float32 and np.isfinite(d).all()
        png = cv2.imread(str(out / f"im{i}_depth.png"), cv2.IMREAD_UNCHANGED)
        assert png.dtype == np.uint16 and png.shape == (196, 196)
