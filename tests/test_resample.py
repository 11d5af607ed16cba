"""Resampling + MVN setup semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abcsmc_tpu.models.parameters import ContinuousUniformPrior, ParameterSet
from abcsmc_tpu.ops import resample, ranking, stats


def test_categorical_matches_weights():
    w = jnp.array([0.1, 0.2, 0.3, 0.4])
    idx = np.asarray(
        resample.categorical_indices(jax.random.PRNGKey(0), w, 40000)
    )
    freq = np.bincount(idx, minlength=4) / 40000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.01)


def test_categorical_accepts_unnormalized():
    w = jnp.array([1.0, 3.0])
    idx = np.asarray(
        resample.categorical_indices(jax.random.PRNGKey(1), w, 20000)
    )
    assert np.mean(idx == 1) == pytest.approx(0.75, abs=0.02)


def test_setup_mvn_doubles_diagonal_only():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 3)) @ np.array(
        [[1.0, 0.3, 0.0], [0.0, 1.0, 0.2], [0.0, 0.0, 1.0]]
    )
    L = np.asarray(resample.setup_mvn_sampler(jnp.asarray(x)))
    sigma_hat = L @ L.T
    cov = np.cov(x.T, ddof=1)
    expected = cov + np.diag(np.diag(cov))
    # f64 on the CPU mesh (x64); the looser bound covers a float32 run
    rtol = 1e-8 if jax.config.jax_enable_x64 else 5e-5
    np.testing.assert_allclose(sigma_hat, expected, rtol=rtol, atol=1e-6)


def test_sample_predictive_priors_shapes_and_support():
    ps = ParameterSet([
        ContinuousUniformPrior("a", 0.0, 1.0),
        ContinuousUniformPrior("b", 0.0, 1.0),
    ])
    prev = jnp.asarray(np.random.default_rng(0).uniform(0.3, 0.7, (20, 2)))
    w = jnp.full((20,), 0.05)
    dv = jnp.array([0.01, 0.01])
    out = np.asarray(
        resample.sample_predictive_priors(
            jax.random.PRNGKey(0), 100, w, prev, ps, dv
        )
    )
    assert out.shape == (100, 2)
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_ranking_simple_orders_by_distance():
    mets = jnp.array([[1.0, 1.0], [5.0, 5.0], [2.0, 2.0], [10.0, -3.0]])
    obs = jnp.array([1.0, 1.0])
    order, dists = ranking.ranking_simple(mets, obs)
    assert list(np.asarray(order))[0] == 0
    assert float(dists[0]) < float(dists[2]) < float(dists[1])


def test_ranking_pls_recovers_closest_particle():
    rng = np.random.default_rng(0)
    n, p = 300, 2
    theta = rng.uniform(-3, 3, size=(n, p))
    # metrics: linear images of theta + redundant correlated copies + noise
    A = rng.normal(size=(p, 6))
    mets = theta @ A + 0.05 * rng.normal(size=(n, 6))
    theta_true = np.array([0.5, -1.0])
    obs = theta_true @ A
    order, dists = ranking.ranking_pls(
        jnp.asarray(mets), jnp.asarray(theta), jnp.asarray(obs), 0.5
    )
    best = np.asarray(order)[:30]
    # the top-ranked particles should be near theta_true in parameter space
    sel = theta[best]
    err = np.linalg.norm(sel - theta_true, axis=1).mean()
    base = np.linalg.norm(theta - theta_true, axis=1).mean()
    assert err < base * 0.35


def test_top_k_matches_argsort():
    d = jnp.asarray(np.random.default_rng(3).normal(size=100))
    full = np.asarray(stats.ordered(d))[:10]
    topk = np.asarray(ranking.top_k_from_distances(d, 10))
    np.testing.assert_array_equal(np.sort(full), np.sort(topk))


def test_box_cox_ranking_option():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    n = 200
    theta = rng.uniform(0.5, 2.0, size=(n, 2))
    # heavily skewed metrics: exp of linear images
    mets = np.exp(theta @ rng.normal(size=(2, 4)))
    obs = np.exp(np.array([1.0, -1.0]) @ rng.normal(size=(2, 4)))
    o1, _ = ranking.ranking_pls(
        jnp.asarray(mets), jnp.asarray(theta), jnp.asarray(obs), 0.5,
        box_cox=True,
    )
    assert len(np.unique(np.asarray(o1))) == n  # a valid permutation

    xt, ot = ranking.apply_box_cox(jnp.asarray(mets), jnp.asarray(obs))
    from abcsmc_tpu.ops import stats as S
    # transform reduces skewness substantially
    for j in range(4):
        before = abs(float(S.skewness(jnp.asarray(mets[:, j]))))
        after = abs(float(S.skewness(xt[:, j])))
        assert after <= before + 1e-6


def test_ranking_pls_vdv_method():
    rng = np.random.default_rng(0)
    n, p = 200, 2
    theta = rng.uniform(-3, 3, size=(n, p))
    A = rng.normal(size=(p, 6))
    mets = theta @ A + 0.05 * rng.normal(size=(n, 6))
    obs = np.array([0.5, -1.0]) @ A
    o_tol, d_tol = ranking.ranking_pls(
        jnp.asarray(mets), jnp.asarray(theta), jnp.asarray(obs), 0.5,
        optimal_method="tolerance",
    )
    o_vdv, d_vdv = ranking.ranking_pls(
        jnp.asarray(mets), jnp.asarray(theta), jnp.asarray(obs), 0.5,
        optimal_method="vdv",
    )
    # both methods produce valid full orderings concentrated near the truth
    for order in (o_tol, o_vdv):
        idx = np.asarray(order)
        assert len(np.unique(idx)) == n
        sel = theta[idx[:30]]
        assert np.linalg.norm(sel - np.array([0.5, -1.0]), axis=1).mean() < 1.2


def test_systematic_indices_count_invariant():
    """Systematic resampling: every survivor's count is floor(N*w) or
    ceil(N*w) - the defining low-variance property (Kitagawa 1996)."""
    rng = np.random.default_rng(3)
    k = 40
    w = rng.uniform(0.1, 2.0, k)
    n = 1000
    idx = np.asarray(resample.systematic_indices(
        jax.random.PRNGKey(5), jnp.asarray(w), n
    ))
    counts = np.bincount(idx, minlength=k)
    expected = n * w / w.sum()
    assert np.all(counts >= np.floor(expected))
    assert np.all(counts <= np.ceil(expected))
    # and it still hits every stratum exactly once
    assert counts.sum() == n


def test_systematic_vs_multinomial_same_marginals():
    rng = np.random.default_rng(4)
    w = jnp.asarray(rng.uniform(0.5, 1.5, 20))
    n = 100_000
    sys_idx = np.asarray(resample.systematic_indices(jax.random.PRNGKey(1), w, n))
    mult_idx = np.asarray(resample.categorical_indices(jax.random.PRNGKey(2), w, n))
    p_sys = np.bincount(sys_idx, minlength=20) / n
    p_mult = np.bincount(mult_idx, minlength=20) / n
    p_true = np.asarray(w) / np.asarray(w).sum()
    np.testing.assert_allclose(p_sys, p_true, atol=2e-4)   # near-deterministic
    np.testing.assert_allclose(p_mult, p_true, atol=5e-3)  # MC noise


def test_resample_method_config_validation():
    import pytest as _pytest

    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.errors import ConfigError

    base = {
        "smc_iterations": 2, "num_samples": 10, "predictive_prior_size": 4,
        "parameters": [{"name": "a", "dist_type": "UNIFORM",
                        "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.0}],
    }
    assert parse_config(base).resample_method == "multinomial"
    assert parse_config({**base, "resample_method": "systematic"}
                        ).resample_method == "systematic"
    with _pytest.raises(ConfigError):
        parse_config({**base, "resample_method": "bogus"})


def test_systematic_offset_survives_large_indices_f32():
    """Regression: (i + u) computed directly in f32 quantizes the stratum
    offset away above ~2^22 and drops it entirely by 2^23; the split-index
    formulation must preserve it at any scale."""
    from abcsmc_tpu.ops.resample import _stratum_points

    scale = jnp.float32(1e-7)
    i = jnp.asarray([9_000_000], dtype=jnp.int32)
    p0 = float(_stratum_points(i, jnp.float32(0.0), scale, jnp.float32)[0])
    p1 = float(_stratum_points(i, jnp.float32(0.37), scale, jnp.float32)[0])
    # naive f32: the f32 spacing at 9e6 is 1.0, so (9e6 + 0.37) rounds back
    # to 9e6 exactly - the offset vanishes
    assert np.float32(9_000_000.0) + np.float32(0.37) == np.float32(9_000_000.0)
    assert p1 > p0
    # the final add rounds to the f32 ulp of the total point value (~6e-8
    # here), so the offset lands within one ulp of its exact displacement -
    # vs the naive formulation where it is exactly zero
    ulp = float(np.spacing(np.float32(p0)))
    assert abs((p1 - p0) - 0.37e-7) <= ulp


def test_systematic_count_invariant_at_5m_f32():
    """The floor/ceil count guarantee must hold for f32 weights at a
    population size past the naive-f32 breakdown point (2^22)."""
    k = 16
    w = jnp.asarray(np.linspace(0.5, 2.0, k), jnp.float32)
    n = 5_000_000
    idx = np.asarray(resample.systematic_indices(jax.random.PRNGKey(3), w, n))
    counts = np.bincount(idx, minlength=k)
    expected = n * np.asarray(w, np.float64) / float(np.asarray(w).sum())
    # f32 cdf/pts rounding can shift a stratum boundary by ~1 count at this
    # scale; the invariant must hold to +-2 (the naive version is off by
    # hundreds and systematically aligned)
    assert np.all(counts >= np.floor(expected) - 2)
    assert np.all(counts <= np.ceil(expected) + 2)


def test_noise_inverse_cdf_never_escapes_support():
    """Regression: float overshoot of the inverse-CDF back-transform must not
    emit values outside prior support (mu at the bound, tiny sigma - the
    late-generation regime)."""
    from abcsmc_tpu.models.parameters import (
        ContinuousUniformPrior as CU,
        DiscreteUniformPrior as DU,
        ParameterSet as PS,
    )

    ps = PS([DU("d", 1, 49), CU("c", 0.0, 1.0)])   # odd int max: round(49.5)=50
    n = 200_000
    mu = jnp.tile(jnp.array([[49.0, 1.0]]), (n, 1))  # hugging upper bounds
    dv = jnp.array([1e-8, 1e-10])
    out = np.asarray(ps.noise_independent(jax.random.PRNGKey(9), mu, dv))
    assert out[:, 0].max() <= 49 and out[:, 0].min() >= 1
    assert out[:, 1].max() <= 1.0 and out[:, 1].min() >= 0.0
