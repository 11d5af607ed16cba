"""The Pallas weight kernel (Triton route, interpret mode on the CPU) and its
XLA reference, each against a float64 oracle."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp
from abcsmc_tpu.ops.weights import _log_kernel_mixture_density_xla, _prep_scaled


def _f64_logsumexp(a, b, log_w):
    """logsumexp_j(log_w[j] - 0.5 * ||a_i - b_j||^2), literally, in f64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    lg = np.asarray(log_w, np.float64)[None, :] - 0.5 * d
    mx = lg.max(1, keepdims=True)
    with np.errstate(divide="ignore"):
        return mx[:, 0] + np.log(np.exp(lg - mx).sum(1))


def _smc_state(n, m, p, seed):
    rng = np.random.default_rng(seed)
    params = rng.uniform(0, 1, (n, p))
    prev = rng.uniform(0.2, 0.8, (m, p))
    w = rng.dirichlet(np.ones(m))
    dv = rng.uniform(0.01, 0.1, p)
    return params, prev, w, dv


@pytest.mark.parametrize("p", [1, 3, 6, 19, 25])
def test_kernel_matches_f64_oracle(p):
    """Every parameter width the feature padding handles (P + 2 <= 16 and
    above), with ragged query and center counts that fill no tile."""
    n, m = 257, 301
    params, prev, w, dv = _smc_state(n, m, p, seed=p)
    a, b, log_norm = _prep_scaled(
        jnp.asarray(params, jnp.float32), jnp.asarray(prev, jnp.float32),
        jnp.asarray(dv, jnp.float32),
    )
    got = np.asarray(mixture_logsumexp(
        a, b, jnp.log(jnp.asarray(w, jnp.float32)), interpret=True,
    ))
    np.testing.assert_allclose(
        got, _f64_logsumexp(a, b, np.log(w)), rtol=0, atol=2e-5
    )
    # the same density through the XLA reference path
    expect = _f64_logsumexp(a, b, np.log(w)) + float(log_norm)
    xla = np.asarray(_log_kernel_mixture_density_xla(
        jnp.asarray(params), jnp.asarray(prev), jnp.log(jnp.asarray(w)),
        jnp.asarray(dv), block=128,
    ))
    np.testing.assert_allclose(xla, expect, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n,m", [(1, 1), (63, 65), (64, 64), (130, 7)])
def test_kernel_ragged_tiles(n, m):
    """Row and center counts on, below and above the 64-wide tiles: padded
    rows are trimmed and padded centers contribute nothing."""
    rng = np.random.default_rng(n * 1000 + m)
    a = rng.normal(size=(n, 6)).astype(np.float32)
    b = rng.normal(size=(m, 6)).astype(np.float32)
    lw = np.log(rng.dirichlet(np.ones(m))).astype(np.float32)
    got = np.asarray(mixture_logsumexp(a, b, lw, interpret=True))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, _f64_logsumexp(a, b, lw), atol=2e-5)


@pytest.mark.parametrize("zero", ["neg_inf", "tiny"])
def test_kernel_zero_and_tiny_weights(zero):
    """Exactly-zero mixture weights (log w = -inf) and 1e-30 weights drop
    out cleanly: the result equals the density over the other centers."""
    rng = np.random.default_rng(2)
    n, m, p = 64, 40, 3
    a = rng.normal(size=(n, p)).astype(np.float32)
    b = rng.normal(size=(m, p)).astype(np.float32)
    lw = np.full(m, np.log(1.0 / 20), np.float32)
    lw[20:] = -np.inf if zero == "neg_inf" else np.log(1e-30)
    got = np.asarray(mixture_logsumexp(a, b, jnp.asarray(lw), interpret=True))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _f64_logsumexp(a, b, lw), atol=2e-5)
    if zero == "neg_inf":
        alone = np.asarray(mixture_logsumexp(
            a, b[:20], jnp.asarray(lw[:20]), interpret=True
        ))
        np.testing.assert_allclose(got, alone, atol=1e-6)


def test_kernel_underflow_tail_query():
    """A query ~1e4 kernel sds from every center: every exp underflows
    against a fixed offset, so only the online row max returns the right
    finite value."""
    b = np.zeros((16, 2), np.float32)
    lw = np.full((16,), np.log(1.0 / 16), np.float32)
    a = np.concatenate([
        np.zeros((3, 2), np.float32),
        np.full((1, 2), 1e4, np.float32),     # the far-tail query
    ])
    out = np.asarray(mixture_logsumexp(a, b, lw, interpret=True))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[3], -0.5 * 2 * 1e8 + math.log(1.0 / 16),
                               rtol=1e-6)
    np.testing.assert_allclose(out[:3], 0.0, atol=1e-6)
