"""d(qkv) of the port's packed attention against the JAX package, fp32, CPU.

On the CPU, ``mha_flash_packed`` is the plain version and autograd through
it is the plain version of the backward kernel. It is held against
``jax.grad`` of the JAX ``mha_flash_packed`` (its Pallas forward and
backward kernels in interpret mode) on the same inputs and output
cotangent, and, where every real logit is below -60, against ``jax.grad``
of ``ops/attention.mha_reference``: there the JAX kernel's closed-form pad
correction is the reference's known fault (ROADMAP.md section 3).

Tolerances, as |err| <= tol * (1 + |ref|), about 3x the readings: 2e-6 in
general (readings 6.6e-7 at N = 197, 5.1e-7 at N = 785; fp32 summation order
only); 1.5e-4 below -60 (readings 4.6e-5 at N = 65, 2.7e-5 at N = 197). There
dK is a sum over queries of large, nearly cancelling terms, and both fp32
computations sit that far from a float64 one (the port 3.9e-5, the JAX
reference 1.0e-5, at N = 65).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.ops.attention import mha_reference
from distill_any_depth_tpu.ops.flash_attention import mha_flash_packed as jax_mha_flash_packed
from distill_any_depth_tpu_torch.ops.flash_attention import mha_flash_packed

TOL, NEGATIVE_TOL = 2e-6, 1.5e-4
HEADS = 2


def _inputs(n: int, negative: bool = False, seed: int = 0):
    rng = np.random.RandomState(seed + n)
    c = HEADS * 64
    qkv = rng.randn(2, n, 3 * c).astype(np.float32)
    if negative:
        # every real logit below -60: q along +u, keys along -u
        u = np.full(64, 0.125, np.float32)
        qkv[:, :, :c] = 0.01 * qkv[:, :, :c] + np.tile(80 * u, HEADS)
        qkv[:, :, c:2 * c] = 0.01 * qkv[:, :, c:2 * c] - np.tile(10 * u, HEADS)
    g = rng.randn(2, n, c).astype(np.float32)
    return qkv, g


def _port_grad(qkv: np.ndarray, g: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(qkv).requires_grad_()
    mha_flash_packed(x, HEADS).backward(torch.from_numpy(g))
    return x.grad.numpy()


def _close(got, ref, tol=TOL):
    err = np.abs(got.astype(np.float64) - ref)
    assert np.all(err <= tol * (1 + np.abs(ref))), (err / (1 + np.abs(ref))).max()


@pytest.mark.parametrize("n", [197, 785])
def test_dqkv_matches_jax_kernel(n):
    qkv, g = _inputs(n)
    want = jax.grad(lambda x: jnp.sum(jax_mha_flash_packed(x, HEADS, interpret=True)
                                      * jnp.asarray(g)))(jnp.asarray(qkv))
    _close(_port_grad(qkv, g), np.asarray(want, np.float64))


@pytest.mark.parametrize("n", [65, 197])
def test_dqkv_strongly_negative_logits_match_jax_reference(n):
    qkv, g = _inputs(n, negative=True)
    c = HEADS * 64
    q, k, _ = (qkv[0, :, i * c:i * c + 64] for i in range(3))
    assert (q @ k.T * 0.125).max() < -60

    def f(x):
        x5 = x.reshape(2, n, 3, HEADS, 64)
        out = mha_reference(x5[:, :, 0], x5[:, :, 1], x5[:, :, 2]).reshape(2, n, c)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(qkv)), np.float64)
    got = _port_grad(qkv, g)
    assert np.isfinite(got).all()
    _close(got, want, NEGATIVE_TOL)
