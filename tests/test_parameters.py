"""Distribution / sampling semantics tests, including the ParRNG odometer
replacement (ParRNG.h:17-36 semantics as exercised by tests/ParRNG.test.cpp)."""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abcsmc_tpu.config import parse_config
from abcsmc_tpu.errors import ConfigError
from abcsmc_tpu.models.parameters import (
    ContinuousUniformPrior,
    DiscreteUniformPrior,
    GaussianPrior,
    ParameterSet,
    PseudoParameter,
    PosteriorParameter,
)


def test_prior_moments():
    cu = ContinuousUniformPrior("u", 2.0, 6.0)
    assert cu.get_mean() == 4.0
    assert cu.get_sd() == pytest.approx(4.0 / np.sqrt(12.0))
    du = DiscreteUniformPrior("d", 1, 7)
    assert du.get_mean() == 4.0
    # parity quirk: continuous sd formula (Priors.h:63-69)
    assert du.get_sd() == pytest.approx(6.0 / np.sqrt(12.0))
    g = GaussianPrior("g", -1.0, 2.5)
    assert (g.get_mean(), g.get_sd()) == (-1.0, 2.5)


def test_sampling_statistics():
    key = jax.random.PRNGKey(0)
    n = 20000
    cu = ContinuousUniformPrior("u", 2.0, 6.0)
    s = cu.sample(key, n)
    assert float(s.min()) >= 2.0 and float(s.max()) <= 6.0
    assert float(s.mean()) == pytest.approx(4.0, abs=0.05)

    du = DiscreteUniformPrior("d", 1, 6)
    sd = du.sample(key, n)
    vals = np.unique(np.asarray(sd))
    assert set(vals) == {1, 2, 3, 4, 5, 6}

    g = GaussianPrior("g", 3.0, 0.5)
    sg = g.sample(key, n)
    assert float(sg.mean()) == pytest.approx(3.0, abs=0.02)
    assert float(sg.std()) == pytest.approx(0.5, abs=0.02)


def test_pdfs():
    cu = ContinuousUniformPrior("u", 0.0, 4.0)
    assert float(cu.pdf(jnp.array(2.0))) == pytest.approx(0.25)
    assert float(cu.pdf(jnp.array(5.0))) == 0.0
    du = DiscreteUniformPrior("d", 1, 4)
    assert float(du.pdf(jnp.array(2.0))) == pytest.approx(0.25)
    assert float(du.pdf(jnp.array(2.5))) == 0.0  # non-integral -> invalid
    assert float(du.pdf(jnp.array(9.0))) == 0.0
    g = GaussianPrior("g", 0.0, 1.0)
    assert float(g.pdf(jnp.array(0.0))) == pytest.approx(1.0 / np.sqrt(2 * np.pi))


def test_odometer_semantics():
    """Mixed prior + pseudo + pseudo + posterior, mirroring tests/ParRNG.test.cpp:
    the first pseudo parameter is the fastest digit, the posterior only advances
    when every pseudo grid rolls over."""
    ps = ParameterSet([
        GaussianPrior("g", 0.0, 1.0),
        PseudoParameter("p1", [10.0, 20.0]),        # size 2 (fast digit)
        PseudoParameter("p2", [1.0, 2.0, 3.0]),     # size 3
        PosteriorParameter("post", 4),               # size 4 (slow digit)
    ])
    pseudo_vals, post_ranks = ps.indexed_grid_values(24)
    # p1 cycles 10,20,10,20,...
    np.testing.assert_array_equal(pseudo_vals[:4, 0], [10.0, 20.0, 10.0, 20.0])
    # p2 advances when p1 rolls over: 1,1,2,2,3,3,1,1,...
    np.testing.assert_array_equal(
        pseudo_vals[:8, 1], [1, 1, 2, 2, 3, 3, 1, 1]
    )
    # posterior advances every 6 samples
    np.testing.assert_array_equal(post_ranks[:13],
                                  [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2])


def test_sample_priors_posterior_lookup():
    ps = ParameterSet([
        PseudoParameter("p1", [10.0, 20.0]),
        PosteriorParameter("post", 3),
    ])
    posterior_matrix = np.array([[100.0], [200.0], [300.0]])
    samples, ranks = ps.sample_priors(
        jax.random.PRNGKey(0), 6, posterior_matrix
    )
    np.testing.assert_array_equal(
        np.asarray(samples[:, 0]), [10, 20, 10, 20, 10, 20]
    )
    np.testing.assert_array_equal(
        np.asarray(samples[:, 1]), [100, 100, 200, 200, 300, 300]
    )
    np.testing.assert_array_equal(np.asarray(ranks), [0, 0, 1, 1, 2, 2])


def test_recast_int_columns():
    ps = ParameterSet([
        DiscreteUniformPrior("d", 1, 10),
        ContinuousUniformPrior("c", 0.0, 1.0),
    ])
    theta = jnp.array([[2.6, 0.33], [7.4, 0.77]])
    out = np.asarray(ps.recast(theta))
    np.testing.assert_allclose(out, [[3.0, 0.33], [7.0, 0.77]])


def test_prior_log_pdf_product():
    ps = ParameterSet([
        ContinuousUniformPrior("c", 0.0, 2.0),
        GaussianPrior("g", 0.0, 1.0),
    ])
    theta = jnp.array([[1.0, 0.0], [3.0, 0.0]])
    lp = np.asarray(ps.prior_log_pdf(theta))
    assert lp[0] == pytest.approx(np.log(0.5 * 1.0 / np.sqrt(2 * np.pi)))
    assert lp[1] == -np.inf  # out of uniform support


def test_indexed_pars_reject_likelihood():
    ps = ParameterSet([PseudoParameter("p", [1.0, 2.0])])
    with pytest.raises(ConfigError):
        ps.prior_log_pdf(jnp.ones((3, 1)))


def test_noise_independent_truncation_and_recast():
    ps = ParameterSet([
        DiscreteUniformPrior("d", 1, 6),
        ContinuousUniformPrior("c", 0.0, 1.0),
    ])
    n = 512
    mu = jnp.tile(jnp.array([[3.0, 0.5]]), (n, 1))
    dv = jnp.array([4.0, 0.09])
    out = np.asarray(ps.noise_independent(jax.random.PRNGKey(1), mu, dv))
    # all draws valid: integral in [1,6]; float in [0,1]
    assert np.all(out[:, 0] == np.round(out[:, 0]))
    assert out[:, 0].min() >= 1 and out[:, 0].max() <= 6
    assert out[:, 1].min() >= 0.0 and out[:, 1].max() <= 1.0
    # actually noisy
    assert len(np.unique(out[:, 0])) > 1
    assert np.std(out[:, 1]) > 0.05


def test_noise_fallback_to_prior_mean():
    # an (artificially) impossible acceptance: uniform [0, 1] but mean pushed far
    # away with tiny variance - fallback must be the prior mean (Priors.h:25-29).
    # The fallback quirk belongs to the rejection method; the inverse-CDF
    # method samples the exact conditional instead (stays inside support).
    ps = ParameterSet([ContinuousUniformPrior("c", 0.0, 1.0)])
    mu = jnp.full((8, 1), 100.0)
    dv = jnp.array([1e-12])
    out = np.asarray(
        ps.noise_independent(jax.random.PRNGKey(2), mu, dv, 50,
                             method="rejection")
    )
    np.testing.assert_allclose(out, 0.5)
    out_icdf = np.asarray(
        ps.noise_independent(jax.random.PRNGKey(2), mu, dv, 50)
    )
    assert np.all((out_icdf >= 0.0) & (out_icdf <= 1.0))


def test_noise_inverse_cdf_matches_rejection_distribution():
    """The one-pass inverse-CDF perturbation and the reference-style rejection
    loop sample the same truncated distribution (both for continuous and
    rounded-integer acceptance regions)."""
    ps = ParameterSet([
        DiscreteUniformPrior("d", 1, 6),
        ContinuousUniformPrior("c", 0.0, 1.0),
    ])
    n = 200_000
    mu = jnp.tile(jnp.array([[5.5, 0.9]]), (n, 1))  # near the upper bounds
    dv = jnp.array([4.0, 0.04])
    icdf = np.asarray(ps.noise_independent(jax.random.PRNGKey(7), mu, dv))
    rej = np.asarray(
        ps.noise_independent(jax.random.PRNGKey(8), mu, dv,
                             method="rejection")
    )
    # integer column: compare the full pmf on 1..6
    for v in range(1, 7):
        p1 = np.mean(icdf[:, 0] == v)
        p2 = np.mean(rej[:, 0] == v)
        assert abs(p1 - p2) < 0.01, (v, p1, p2)
    # continuous column: moments + tail mass
    assert abs(icdf[:, 1].mean() - rej[:, 1].mean()) < 0.005
    assert abs(icdf[:, 1].std() - rej[:, 1].std()) < 0.005
    q = np.quantile(icdf[:, 1], [0.05, 0.5, 0.95])
    q2 = np.quantile(rej[:, 1], [0.05, 0.5, 0.95])
    np.testing.assert_allclose(q, q2, atol=0.01)


def test_noise_multivariate_valid_rows():
    ps = ParameterSet([
        ContinuousUniformPrior("a", 0.0, 10.0),
        ContinuousUniformPrior("b", 0.0, 10.0),
    ])
    n = 256
    mu = jnp.tile(jnp.array([[5.0, 5.0]]), (n, 1))
    L = jnp.linalg.cholesky(jnp.array([[1.0, 0.5], [0.5, 1.0]]))
    out = np.asarray(ps.noise_multivariate(jax.random.PRNGKey(3), mu, L))
    assert out.min() >= 0.0 and out.max() <= 10.0
    # correlation roughly preserved
    c = np.corrcoef(out.T)[0, 1]
    assert 0.2 < c < 0.8


def test_parameter_set_from_reference_config():
    cfg = parse_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures",
        "reference_quickstart.json",
    ))
    ps = ParameterSet.from_specs(cfg.parameters)
    assert ps.npar == 2
    samples, _ = ps.sample_priors(jax.random.PRNGKey(0), 100)
    s = np.asarray(samples)
    assert s.shape == (100, 2)
    assert s.min() >= 1 and s.max() <= 1000
    assert np.all(s == np.round(s))  # both INT uniforms


def test_noise_inverse_cdf_infinite_support_and_dv0():
    """Gaussian priors have infinite noise_support - the inverse-CDF path must
    stay finite there - and dv == 0 columns pass mu through unchanged."""
    ps = ParameterSet([
        GaussianPrior("g", 0.0, 2.0),
        ContinuousUniformPrior("c", 0.0, 1.0),
    ])
    mu = jnp.tile(jnp.array([[1.0, 0.5]]), (50_000, 1))
    out = np.asarray(
        ps.noise_independent(jax.random.PRNGKey(0), mu,
                             jnp.array([0.25, 0.04]))
    )
    assert np.all(np.isfinite(out))
    assert abs(out[:, 0].mean() - 1.0) < 0.02      # untruncated normal
    assert abs(out[:, 0].std() - 0.5) < 0.02
    out0 = np.asarray(
        ps.noise_independent(jax.random.PRNGKey(1), mu,
                             jnp.array([0.0, 0.04]))
    )
    assert np.all(out0[:, 0] == 1.0)               # dv=0 -> zero noise
