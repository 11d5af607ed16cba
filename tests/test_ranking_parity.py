"""Whole-pipeline ranking parity: our PLS ranking vs an independent numpy
transcription of particle_ranking_PLS (src/AbcUtil.cpp:423-458) built on the
textbook NIPALS oracle. Same inputs -> same survivor sets."""

import jax.numpy as jnp
import numpy as np

from abcsmc_tpu.ops import pls as pls_mod
from abcsmc_tpu.ops import ranking

from test_pls import nipals_pls  # tests/ is on sys.path under pytest


def numpy_particle_ranking_pls(metric_vals, param_vals, obs, training_frac):
    """Literal transcription of the reference ranking using numpy + NIPALS."""
    X = np.asarray(metric_vals, np.float64)
    Y = np.asarray(param_vals, np.float64)
    met_means = X.mean(0)
    met_sd = X.std(0, ddof=1)
    z_met = (X - met_means) / met_sd
    z_par = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    obs_z = (np.asarray(obs) - met_means) / met_sd

    n_train = int(round(len(X) * training_frac))
    ncomp = min(n_train - 1, X.shape[1])
    model = nipals_pls(z_met[:n_train], z_par[:n_train], ncomp)
    R, Q = model["R"], model["Q"]

    # NEW_DATA CV: SSE per component count on the held-out rows
    tv = z_met[n_train:] @ R
    em = np.zeros((ncomp, Y.shape[1]))
    pred = np.zeros_like(z_par[n_train:])
    for a in range(ncomp):
        pred = pred + np.outer(tv[:, a], Q[:, a])
        em[a] = ((z_par[n_train:] - pred) ** 2).sum(0)
    # same tolerance rule as ops.pls.optimal_num_components
    best = []
    for j in range(em.shape[1]):
        ok = em[:, j] <= 1.1 * em[:, j].min()
        best.append(int(np.argmax(ok)) + 1)
    used = max(best)

    scores = z_met @ R[:, :used]
    obs_scores = obs_z @ R[:, :used]
    dists = np.linalg.norm(scores - obs_scores, axis=1)
    return np.argsort(dists, kind="stable"), dists


def test_full_ranking_matches_numpy_reference():
    rng = np.random.default_rng(17)
    n, p, m = 240, 3, 7
    theta = rng.uniform(-2, 2, size=(n, p))
    mix = rng.normal(size=(p, m))
    mets = theta @ mix + 0.1 * rng.normal(size=(n, m))
    obs = np.array([0.5, -1.0, 1.5]) @ mix

    ref_order, ref_d = numpy_particle_ranking_pls(mets, theta, obs, 0.5)
    our_order, our_d = ranking.ranking_pls(
        jnp.asarray(mets), jnp.asarray(theta), jnp.asarray(obs), 0.5
    )
    our_order = np.asarray(our_order)
    our_d = np.asarray(our_d)

    # distances agree (score signs may flip; distances are invariant)
    np.testing.assert_allclose(our_d, ref_d, rtol=1e-6, atol=1e-8)
    # survivor sets agree at every meaningful cut
    for k in (10, 24, 60, 120):
        assert set(our_order[:k]) == set(ref_order[:k]), k
