"""Importance-weight kernel: the blocked matmul formulation must match a literal
numpy transcription of the reference's O(N*M*P) loop (src/AbcUtil.cpp:547-586)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abcsmc_tpu.models.parameters import ContinuousUniformPrior, GaussianPrior, ParameterSet
from abcsmc_tpu.ops import weights as W


def reference_weights(params, prev_params, prev_weights, prev_dv, priors):
    """Literal numpy transcription of weight_predictive_prior
    (src/AbcUtil.cpp:547-586), including the dv==0 escape hatch and the final
    L2 normalization."""
    n, p = params.shape
    out = np.zeros(n)
    for i in range(n):
        numerator = 1.0
        for j in range(p):
            numerator *= priors[j](params[i, j])
        denominator = 0.0
        for m in range(prev_params.shape[0]):
            running = prev_weights[m]
            for j in range(p):
                delta = params[i, j] - prev_params[m, j]
                old_dv = prev_dv[j]
                if old_dv != 0 or delta != 0:
                    sd = np.sqrt(old_dv)
                    running *= (
                        np.exp(-(delta**2) / (2 * old_dv)) / (sd * np.sqrt(2 * np.pi))
                        if old_dv > 0 else 0.0
                    )
            denominator += running
        out[i] = numerator / denominator
    return out / np.linalg.norm(out)


@pytest.mark.parametrize("block", [7, 64])
def test_weights_match_reference_loop(block):
    rng = np.random.default_rng(42)
    n, m, p = 37, 23, 3
    prev_params = rng.uniform(0.2, 0.8, size=(m, p)) * 10
    params = prev_params[rng.integers(0, m, n)] + rng.normal(0, 0.3, (n, p))
    params = np.clip(params, 0.01, 9.99)
    prev_w = rng.uniform(0.5, 1.5, m)
    prev_w /= prev_w.sum()
    prev_dv = np.array([0.5, 1.2, 0.08])

    ps = ParameterSet([
        ContinuousUniformPrior("a", 0.0, 10.0),
        ContinuousUniformPrior("b", 0.0, 10.0),
        GaussianPrior("c", 5.0, 3.0),
    ])
    priors = [
        lambda x: (0.0 <= x <= 10.0) * 0.1,
        lambda x: (0.0 <= x <= 10.0) * 0.1,
        lambda x: np.exp(-((x - 5.0) ** 2) / (2 * 9.0)) / (3.0 * np.sqrt(2 * np.pi)),
    ]

    expect = reference_weights(params, prev_params, prev_w, prev_dv, priors)
    got = np.asarray(
        W.weight_predictive_prior(
            jnp.asarray(params), jnp.asarray(prev_params), jnp.asarray(prev_w),
            jnp.asarray(prev_dv), ps.prior_log_pdf, block=block,
        )
    )
    np.testing.assert_allclose(got, expect, rtol=1e-8)
    assert np.linalg.norm(got) == pytest.approx(1.0)  # L2-normalized quirk


def test_weights_converged_parameter_escape_hatch():
    """A parameter with dv == 0 (fully converged, all values equal) must not
    zero/inf-out the weights (src/AbcUtil.cpp:570-576)."""
    rng = np.random.default_rng(0)
    m, n = 11, 13
    prev_params = np.column_stack([
        np.full(m, 3.0),                      # converged column
        rng.uniform(1, 9, m),
    ])
    params = np.column_stack([
        np.full(n, 3.0),
        rng.uniform(1, 9, n),
    ])
    prev_w = np.full(m, 1.0 / m)
    prev_dv = np.array([0.0, 2.0])

    ps = ParameterSet([
        ContinuousUniformPrior("a", 0.0, 10.0),
        ContinuousUniformPrior("b", 0.0, 10.0),
    ])
    priors = [lambda x: 0.1, lambda x: 0.1]
    expect = reference_weights(params, prev_params, prev_w, prev_dv, priors)
    got = np.asarray(
        W.weight_predictive_prior(
            jnp.asarray(params), jnp.asarray(prev_params), jnp.asarray(prev_w),
            jnp.asarray(prev_dv), ps.prior_log_pdf,
        )
    )
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, expect, rtol=1e-8)


def test_uniform_weights_gen0():
    w = np.asarray(W.uniform_weights(8))
    np.testing.assert_allclose(w, 1.0 / 8)


def test_log_kernel_mixture_blocked_invariance():
    rng = np.random.default_rng(7)
    n, m, p = 50, 33, 4
    a = jnp.asarray(rng.normal(size=(n, p)))
    b = jnp.asarray(rng.normal(size=(m, p)))
    lw = jnp.asarray(np.log(np.full(m, 1.0 / m)))
    dv = jnp.asarray(rng.uniform(0.5, 2.0, p))
    full = np.asarray(W.log_kernel_mixture_density(a, b, lw, dv, block=64))
    small = np.asarray(W.log_kernel_mixture_density(a, b, lw, dv, block=5))
    np.testing.assert_allclose(full, small, rtol=1e-10)
