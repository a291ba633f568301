"""The port's order statistics against the JAX package, in fp32 on the CPU.

On the CPU the select (``kth_select``) takes its plain version: a stable
sort of the order bits, the value at k, the first index of that value. It
is held bit for bit against the JAX Pallas kernel ``_kth_valid_index_fused``
run in interpret mode, at rows of 33,000 columns (above the JAX package's
32768-column cutover to the kernel). The medians and quantiles, and their
gradients (a one-element scatter per row), are held exactly against the JAX
functions on the same numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.ops import stats as jstats
from distill_any_depth_tpu_torch.ops import stats
from distill_any_depth_tpu_torch.utils.profiling import recording

N_LONG = 33_000


def _case(name: str):
    """x, mask and k of 3 rows of N_LONG columns."""
    rng = np.random.RandomState(CASES.index(name))
    x = rng.randn(3, N_LONG).astype(np.float32)
    mask = rng.rand(3, N_LONG) < 0.6
    if name == "ties":
        x = np.round(x * 2) / 2  # a few distinct values, each repeated thousands of times
    elif name == "signed_zeros":
        x[:, ::3] = -0.0
        x[:, 1::3] = 0.0  # -0 sorts before +0 in order bits
    elif name == "all_masked":
        mask[1] = False
        mask[2] = True
    count = mask.sum(-1)
    k = (np.maximum(count - 1, 0) // 2).astype(np.int32)
    if name == "k_at_ends":
        k = np.array([0, count[1] - 1, N_LONG - 1], np.int32)  # the last is a masked entry
    return x, mask, k


CASES = ["random", "ties", "signed_zeros", "all_masked", "k_at_ends"]


@pytest.mark.parametrize("name", CASES)
def test_select_plain_matches_pallas_kernel(name):
    x, mask, k = _case(name)
    u_jax = jstats._order_bits(jnp.asarray(x), jnp.asarray(mask))
    u = stats._order_bits(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(u.numpy().view(np.uint32), np.asarray(u_jax))
    want = np.asarray(jstats._kth_valid_index_fused(u_jax, jnp.asarray(k)))
    with recording() as rec:
        got = stats.kth_select(u, torch.from_numpy(k))
    assert "kernels/select" not in rec.counts  # the CPU takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)


def _stats_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 3, 501) * 10).astype(np.float32)
    x[0, 0, :50] = 1.5  # ties
    x[1, 1, :30] = -0.0
    x[1, 1, 30:60] = 0.0
    x[3] = np.round(x[3])
    m = rng.rand(4, 3, 501) > 0.3
    m[2, 2] = False  # empty row
    w = rng.randn(4, 3).astype(np.float32)  # cotangent of the per-row statistic
    return x, m, w


def _value_and_grad_jax(fn, x, m, w):
    def f(xx):
        return jnp.sum(fn(xx, jnp.asarray(m)) * jnp.asarray(w))

    return (np.asarray(fn(jnp.asarray(x), jnp.asarray(m))),
            np.asarray(jax.grad(f)(jnp.asarray(x))))


def _value_and_grad_torch(fn, x, m, w):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt, torch.from_numpy(m))
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


STATS = {
    "masked_median": (jstats.masked_median, stats.masked_median),
    "median_all": (lambda x, m: jstats.median_all(x), lambda x, m: stats.median_all(x)),
    "masked_mean": (jstats.masked_mean, stats.masked_mean),
    **{f"masked_quantile_{q}": (lambda x, m, q=q: jstats.masked_quantile(x, m, q),
                                lambda x, m, q=q: stats.masked_quantile(x, m, q))
       for q in (0.0, 0.25, 0.5, 0.9, 1.0)},
}


@pytest.mark.parametrize("name", sorted(STATS))
def test_statistic_and_gradient_match_jax(name):
    jfn, tfn = STATS[name]
    x, m, w = _stats_inputs()
    jv, jg = _value_and_grad_jax(jfn, x, m, w)
    tv, tg = _value_and_grad_torch(tfn, x, m, w)
    if name == "masked_mean":  # a sum: summation order differs
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        np.testing.assert_allclose(tg, jg, rtol=1e-6)
        return
    np.testing.assert_array_equal(tv, jv)  # NaN == NaN for the empty row's quantile
    np.testing.assert_array_equal(tg, jg)
    if "quantile" not in name:
        # the gradient of a selected element lands on exactly one entry per row
        assert ((tg != 0).sum(-1) <= 1).all()


def test_median_of_long_rows_matches_jax_kernel_path():
    """At 33,000 columns the JAX median goes through its Pallas kernel (in
    interpret mode here); the port's through its plain select."""
    x, mask, _ = _case("ties")
    want = np.asarray(jstats.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    got = stats.masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
