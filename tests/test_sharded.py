"""Multi-chip sharded generation step on a virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abcsmc_tpu.config import FilterType, NoiseType, parse_config
from abcsmc_tpu.models.parameters import ParameterSet
from abcsmc_tpu.models.simulators import make_dice_simulator
from abcsmc_tpu.models.transforms import ParameterTransform
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh


def make_gen(n_devices=None, **kw):
    cfg = parse_config({
        "smc_iterations": 3,
        "num_samples": 64,
        "predictive_prior_fraction": 0.25,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    })
    devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    mesh = particle_mesh(devices)
    return ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_dice_simulator(max_dice=50),
        np.array([44.0, 2.39925]),
        mesh=mesh,
        **kw,
    )


def run_generations(gen, n=64, keep=16, gens=3, seed=0):
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    params, seeds = gen.init_population(k0, n)
    state = None
    res = None
    for t in range(gens):
        key, kt = jax.random.split(key)
        res = gen.step(kt, params, seeds, keep, n, state)
        state = (res.survivor_params, res.weights, res.doubled_variance)
        params, seeds = res.next_params, res.next_seeds
    return res


def test_sharded_generation_8_devices():
    assert len(jax.devices()) == 8
    gen = make_gen()
    res = run_generations(gen)
    assert res.metrics.shape == (64, 2)
    assert res.survivor_params.shape == (16, 2)
    assert np.all(np.isfinite(np.asarray(res.weights)))
    assert np.linalg.norm(np.asarray(res.weights)) == pytest.approx(1.0, abs=1e-4)
    nxt = np.asarray(res.next_params)
    assert nxt.shape == (64, 2)
    assert nxt.min() >= 1 and nxt.max() <= 50
    assert np.all(nxt == np.round(nxt))  # INT recast survives sharding


def test_sharded_matches_single_device():
    """The same keys on a 1-device and an 8-device mesh must produce identical
    survivors and weights (the program is deterministic given the key; only the
    gen-0 draws differ by shard layout, so compare from a fixed population)."""
    gen8 = make_gen()
    gen1 = make_gen(n_devices=1)

    key = jax.random.PRNGKey(42)
    rng = np.random.default_rng(0)
    params = jnp.asarray(
        rng.integers(1, 51, size=(64, 2)).astype(np.float32)
    )
    seeds = jnp.asarray(rng.integers(0, 2**31, size=64, dtype=np.int64)
                        .astype(np.uint32))

    r8 = gen8.step(key, params, seeds, 16, 64, None)
    r1 = gen1.step(key, params, seeds, 16, 64, None)

    # identical simulated metrics (per-particle key depends only on the seed)
    np.testing.assert_allclose(
        np.asarray(r8.metrics), np.asarray(r1.metrics), rtol=1e-5
    )
    # identical survivor sets + distances
    np.testing.assert_allclose(
        np.sort(np.asarray(r8.survivor_idx)),
        np.sort(np.asarray(r1.survivor_idx)),
    )
    np.testing.assert_allclose(
        np.asarray(r8.doubled_variance), np.asarray(r1.doubled_variance),
        rtol=1e-4,
    )


def test_sharded_simple_filter_and_mvn():
    gen = make_gen(filter_type=FilterType.SIMPLE,
                   noise_type=NoiseType.MULTIVARIATE)
    res = run_generations(gen, gens=2)
    assert int(res.ncomp_used) == 0
    nxt = np.asarray(res.next_params)
    assert nxt.min() >= 1 and nxt.max() <= 50


def test_sharded_convergence_dice():
    """3 sharded generations should tighten the population around the analytic
    dice inverse (n~9.4, m~8.4) relative to the U(1,50) prior."""
    gen = make_gen()
    res = run_generations(gen, n=512, keep=64, gens=3, seed=9)
    surv = np.asarray(res.survivor_params)
    assert abs(surv[:, 0].mean() - 9.4) < 6
    assert abs(surv[:, 1].mean() - 8.4) < 6


def test_constant_metric_column_device_matches_host():
    """A constant (zero-variance) metric column must not swamp the ranking in
    the sharded path (regression: sd floor of 1e-30 made every distance ~1e30
    and survivor selection arbitrary)."""
    from abcsmc_tpu.ops import ranking
    from abcsmc_tpu.models.simulators import DeviceSimulator

    rng = np.random.default_rng(3)
    n, keep = 64, 16

    def fn(params, key):
        # metric 0 informative, metric 1 constant
        return jnp.stack([params[0] * 2.0 + params[1], jnp.asarray(7.0,
                          params.dtype)])

    sim = DeviceSimulator(fn, nmet=2)
    gen = make_gen(filter_type=FilterType.SIMPLE)
    gen.simulator = sim
    gen.obs = np.array([44.0, 0.0])  # observed differs from the constant

    params = jnp.asarray(rng.integers(1, 51, (n, 2)).astype(np.float64))
    seeds = jnp.asarray(rng.integers(0, 2**31, n, dtype=np.int64)
                        .astype(np.uint32))
    res = gen.step(jax.random.PRNGKey(0), params, seeds, keep, n, None)
    d = np.asarray(res.distances)
    assert np.all(np.isfinite(d)) and d.max() < 1e6

    # host ranking on the same metrics selects equivalent survivors (the
    # constant column induces distance ties, so compare selected *distances*
    # rather than exact index sets)
    mets = np.asarray(res.metrics)
    order, host_d = ranking.ranking_simple(
        jnp.asarray(mets), jnp.asarray(gen.obs)
    )
    host_sel = np.sort(np.asarray(host_d)[np.asarray(order)[:keep]])
    dev_sel = np.sort(d[np.asarray(res.survivor_idx)])
    np.testing.assert_allclose(dev_sel, host_sel, rtol=1e-5)


def test_sharded_vdv_component_selection():
    """Distributed van der Voet selection inside the fused step."""
    gen = make_gen(pls_optimal_method="vdv", vdv_permutations=99)
    res = run_generations(gen, gens=2)
    assert 1 <= int(res.ncomp_used) <= 2
    assert np.all(np.isfinite(np.asarray(res.weights)))
    surv = np.asarray(res.survivor_params)
    assert np.all(np.isfinite(surv))


def test_padding_mask_matches_single_device():
    """A non-divisible population on the 8-device mesh (tail pad-and-mask)
    must produce the same survivors/weights as the same data on a 1-device
    mesh with no padding: masked rows are provably excluded from moments,
    PLS Grams, PRESS, and the top-K."""
    n, keep = 60, 13           # 60 % 8 != 0, 13 % 8 != 0
    rng = np.random.default_rng(3)
    params = jnp.asarray(rng.integers(1, 51, size=(n, 2)), jnp.float64)
    mets = jnp.asarray(rng.normal(size=(n, 2)) + np.asarray(params), jnp.float64)
    state = (
        jnp.asarray(rng.uniform(5, 45, size=(7, 2))),
        jnp.asarray(rng.uniform(0.5, 1.5, size=(7,))),
        jnp.asarray([4.0, 4.0]),
    )
    key = jax.random.PRNGKey(5)

    g8 = make_gen(dtype=jnp.float64)
    g1 = make_gen(n_devices=1, dtype=jnp.float64)
    r8 = g8.step_precomputed(key, params, mets, keep, 0, state)
    r1 = g1.step_precomputed(key, params, mets, keep, 0, state)

    np.testing.assert_array_equal(
        np.asarray(r8.survivor_idx), np.asarray(r1.survivor_idx)
    )
    np.testing.assert_allclose(
        np.asarray(r8.weights), np.asarray(r1.weights), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(r8.doubled_variance), np.asarray(r1.doubled_variance),
        rtol=1e-9,
    )
    assert int(r8.ncomp_used) == int(r1.ncomp_used)
    # distances buffer is padded to 64; the 4 padding rows rank +inf
    d8 = np.asarray(r8.distances)
    assert d8.shape == (64,)
    assert np.all(np.isinf(d8[60:]))
    assert np.all(np.isfinite(d8[:60]))


def test_step_without_proposal():
    """n_next=0 (the final generation) skips the resample+perturb entirely and
    returns empty next buffers; all survivor outputs are unchanged."""
    gen = make_gen()
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    params, seeds = gen.init_population(k0, 64)
    key, kt = jax.random.split(key)
    r_with = gen.step(kt, params, seeds, 16, 64, None)
    r_without = gen.step(kt, params, seeds, 16, 0, None)
    assert r_without.next_params.shape == (0, 2)
    assert r_without.next_seeds.shape == (0,)
    np.testing.assert_array_equal(
        np.asarray(r_with.survivor_idx), np.asarray(r_without.survivor_idx)
    )
    np.testing.assert_allclose(
        np.asarray(r_with.weights), np.asarray(r_without.weights)
    )


def test_device_step_matches_host_implementation():
    """Cross-implementation oracle: the fused sharded step (psum'd moments,
    Gram-PRESS, distributed top-K, sharded weight kernel) must agree with the
    independently-written host path (ops.ranking row-based z-scoring/CV +
    ops.weights streaming kernel) on identical inputs. This certifies
    correctness against a second implementation, not just stability."""
    from abcsmc_tpu.ops import ranking, stats, weights

    n, keep, npar, nmet = 96, 24, 2, 2
    rng = np.random.default_rng(11)
    params = jnp.asarray(rng.integers(1, 51, (n, npar)), jnp.float64)
    mets = jnp.asarray(
        np.asarray(params) @ rng.normal(size=(npar, nmet))
        + 0.4 * rng.normal(size=(n, nmet))
    )
    obs = np.array([44.0, 2.39925])
    prev_par = jnp.asarray(rng.uniform(5, 45, (keep, npar)))
    prev_w = jnp.asarray(rng.uniform(0.5, 1.5, (keep,)))
    prev_w = prev_w / jnp.linalg.norm(prev_w)
    prev_dv = jnp.asarray([4.0, 4.0])

    # host implementation (row-based)
    order, dists = ranking.ranking_pls(
        mets, params, jnp.asarray(obs), 0.5, optimal_method="tolerance"
    )
    host_surv = np.asarray(order)[:keep]
    host_pars = params[host_surv]
    host_w = np.asarray(weights.weight_predictive_prior(
        host_pars, prev_par, prev_w, prev_dv,
        make_gen().par_set.prior_log_pdf,
    ))
    host_dv = np.asarray(stats.doubled_variance(host_pars))

    # device implementation (sharded, Gram-based)
    gen = make_gen(pls_optimal_method="tolerance", dtype=jnp.float64)
    res = gen.step_precomputed(
        jax.random.PRNGKey(0), params, mets, keep, 0,
        (prev_par, prev_w, prev_dv),
    )

    np.testing.assert_array_equal(
        np.sort(np.asarray(res.survivor_idx)), np.sort(host_surv)
    )
    np.testing.assert_allclose(np.asarray(res.distances)[:n][host_surv],
                               np.asarray(dists)[host_surv], rtol=1e-8)
    # weights are per-survivor; align by survivor index
    dev_order = np.argsort(np.asarray(res.survivor_idx))
    host_order = np.argsort(host_surv)
    np.testing.assert_allclose(
        np.asarray(res.weights)[dev_order], host_w[host_order], rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(res.doubled_variance), host_dv, rtol=1e-9
    )


def test_device_matches_host_wide_metrics_dengue_shape():
    """Same cross-implementation oracle at the dengue-surrogate shape
    (6 parameters x 13 metrics): exercises the Gram-PRESS prefix math and
    component selection at A = 13 (the 2x2 dice tests cap A at 2)."""
    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.ops import ranking, stats, weights

    npar, nmet, n, keep = 6, 13, 240, 40
    cfg = parse_config({
        "smc_iterations": 2, "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": 0.4}
            for j in range(nmet)
        ],
    })
    par_set = ParameterSet.from_specs(cfg.parameters)
    rng = np.random.default_rng(7)
    params = jnp.asarray(rng.uniform(0, 1, (n, npar)))
    mix = rng.normal(size=(npar, nmet))
    mets = jnp.asarray(np.asarray(params) @ mix
                       + 0.3 * rng.normal(size=(n, nmet)))
    obs = np.full(nmet, 0.4)
    prev_par = jnp.asarray(rng.uniform(0.2, 0.8, (keep, npar)))
    prev_w = jnp.asarray(rng.uniform(0.5, 1.5, (keep,)))
    prev_w = prev_w / jnp.linalg.norm(prev_w)
    prev_dv = jnp.asarray(np.full(npar, 0.05))

    order, dists = ranking.ranking_pls(
        mets, params, jnp.asarray(obs), 0.5, optimal_method="tolerance"
    )
    host_surv = np.asarray(order)[:keep]
    host_w = np.asarray(weights.weight_predictive_prior(
        params[host_surv], prev_par, prev_w, prev_dv, par_set.prior_log_pdf,
    ))
    host_dv = np.asarray(stats.doubled_variance(params[host_surv]))

    gen = ShardedGeneration(
        par_set, ParameterTransform(cfg.parameters),
        make_linear_gaussian_simulator(npar, nmet), obs,
        mesh=particle_mesh(), pls_optimal_method="tolerance",
        dtype=jnp.float64,
    )
    res = gen.step_precomputed(
        jax.random.PRNGKey(0), params, mets, keep, 0,
        (prev_par, prev_w, prev_dv),
    )
    assert int(res.ncomp_used) >= 3   # wide shape genuinely uses many comps
    np.testing.assert_array_equal(
        np.sort(np.asarray(res.survivor_idx)), np.sort(host_surv)
    )
    dev_order = np.argsort(np.asarray(res.survivor_idx))
    host_order = np.argsort(host_surv)
    np.testing.assert_allclose(
        np.asarray(res.weights)[dev_order], host_w[host_order], rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(res.doubled_variance), host_dv, rtol=1e-9
    )

    # vdv at the same shape: both paths deterministic, sane component counts
    gen_vdv = ShardedGeneration(
        par_set, ParameterTransform(cfg.parameters),
        make_linear_gaussian_simulator(npar, nmet), obs,
        mesh=particle_mesh(), pls_optimal_method="vdv",
        vdv_permutations=99, dtype=jnp.float64,
    )
    res_v = gen_vdv.step_precomputed(
        jax.random.PRNGKey(0), params, mets, keep, 0,
        (prev_par, prev_w, prev_dv),
    )
    assert 1 <= int(res_v.ncomp_used) <= min(13, n // 2 - 1)
    assert np.all(np.isfinite(np.asarray(res_v.weights)))


def _linear_gaussian_problem(n, npar=6, nmet=13, seed=7):
    """Structured (params -> metrics) data where PLS genuinely needs > 1
    component, plus the matching ParameterSet/config pieces."""
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator

    cfg = parse_config({
        "smc_iterations": 2, "num_samples": n,
        "predictive_prior_size": max(n // 8, 4),
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": 0.4}
            for j in range(nmet)
        ],
    })
    rng = np.random.default_rng(seed)
    params = jnp.asarray(rng.uniform(0, 1, (n, npar)))
    mix = rng.normal(size=(npar, nmet))
    mets = jnp.asarray(
        np.asarray(params) @ mix + 0.3 * rng.normal(size=(n, nmet))
    )
    obs = np.full(nmet, 0.4)
    sim = make_linear_gaussian_simulator(npar, nmet)
    return cfg, params, mets, obs, sim


def test_sharded_vdv_cap_regime_not_degenerate():
    """Round-2 regression: with the row cap BINDING
    and the whole cap window inside the training block - exactly the
    single-chip 1M bench shape, scaled down (1 device, n=1024,
    training_fraction 0.5 -> n_train=512, cap 64 < 512) - the old head-of-
    shard subsample contained zero held-out rows, every p-value was 1, and
    selection silently collapsed to 1 component. The held-out-tail window
    must keep the test powered: ncomp > 1 on data that genuinely needs
    more components."""
    n = 1024
    cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
    par_set = ParameterSet.from_specs(cfg.parameters)

    def ncomp_for(vdv_max_rows):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()[:1]),
            pls_optimal_method="vdv", vdv_permutations=99,
            vdv_max_rows=vdv_max_rows, dtype=jnp.float64,
        )
        res = gen.step_precomputed(
            jax.random.PRNGKey(0), params, mets, 64, 0, None
        )
        return int(res.ncomp_used)

    capped = ncomp_for(64)       # cap 64 << n_train 512: binding
    uncapped = ncomp_for(1 << 20)
    assert uncapped > 1          # the data really needs > 1 component
    assert capped > 1            # ... and the cap must not erase that


def test_sharded_vdv_exactness_oracle():
    """The distributed vdv selection is (a) mesh-layout
    invariant - 8-device == 1-device on identical inputs - and (b) when the
    cap is not binding, EXACTLY the host rule optimal_num_components_vdv
    (ops/pls.py): the rademacher signs are a pure function of (key,
    permutation, global row index), so the statistic is a property of the
    data, not the mesh (the reference's selection at src/AbcUtil.cpp:446-449
    is likewise layout-free)."""
    from abcsmc_tpu.ops import ranking

    n = 240
    cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
    par_set = ParameterSet.from_specs(cfg.parameters)
    key = jax.random.PRNGKey(0)   # ranking's host vdv path uses PRNGKey(0)

    ncomps = {}
    for label, devs in (("8dev", None), ("1dev", 1)):
        devices = jax.devices()[:devs] if devs else jax.devices()
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(devices),
            pls_optimal_method="vdv", vdv_permutations=199,
            dtype=jnp.float64,   # cap (131072) not binding at n=240
        )
        res = gen.step_precomputed(key, params, mets, 30, 0, None)
        ncomps[label] = int(res.ncomp_used)

    # (a) layout invariance
    assert ncomps["8dev"] == ncomps["1dev"]

    # (b) host-rule agreement (same key, same global row indices)
    _, _, host_ncomp = ranking.pls_scores_for_ranking(
        mets, params, jnp.asarray(obs), 0.5, optimal_method="vdv"
    )
    assert ncomps["8dev"] == host_ncomp


def test_sharded_vdv_f32_matches_f64():
    """Cancellation guard for the moment-expansion permutation test: the vdv
    statistic is computed from psum'd moments (S = U0 - 2*T1 + S2), which is
    algebraically equal to the direct held-out residual sums but subtracts
    near-equal quantities. Selection must be precision-robust: f32 must pick
    the same component count as f64 on identical data, in both the capped
    (held-out-tail window) and uncapped regimes.

    Measured at the production window scale (1M rows, n_train 500k, the full
    131072-row capped window, f32-accumulated matmuls as on a GPU): the
    moment-expansion statistic lands within 5.2e-7 relative of the f64
    direct per-row reference - 17x CLOSER than the f32 direct per-row chain
    it replaced (8.9e-6; its per-element product rounding exceeds the
    blocked-dot accumulation error) - with zero permutation p-value changes
    and identical selection. The small shape here is a regression canary,
    not the scale bound."""
    n = 1024
    cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
    par_set = ParameterSet.from_specs(cfg.parameters)

    def ncomp_for(dtype, cap):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()),
            pls_optimal_method="vdv", vdv_permutations=199,
            vdv_max_rows=cap, dtype=dtype,
        )
        res = gen.step_precomputed(
            jax.random.PRNGKey(0),
            params.astype(dtype), mets.astype(dtype), 64, 0, None,
        )
        return int(res.ncomp_used)

    for cap in (64, 1 << 20):
        assert ncomp_for(jnp.float32, cap) == ncomp_for(jnp.float64, cap)


def test_chunked_row_passes_match_resident_path():
    """Big-N mode: with ``row_block`` forced, every O(N)-row pass (moments,
    PLS Grams, vdv window, distances) streams through scan blocks with
    O(block) temporaries instead of materializing [ln, M] z-scores and
    [ln, A] scores. The algebra is identical, so survivors, distances,
    selection, weights and the proposed next generation must match the
    resident path - including when the block does not divide the shard
    slice (the shifted last block overlaps; overlap rows must not be
    double-counted). Exercised for both PLS/vdv and SIMPLE filters."""
    from abcsmc_tpu.config import FilterType

    # n=1000: ln = 125 on 8 devices, block 32 -> overlapping last block;
    # n=900: pads to 904 (ln = 113) -> overlap AND masked padding rows
    for n, ft in (
        (1000, FilterType.PLS),
        (1000, FilterType.SIMPLE),
        (900, FilterType.PLS),
    ):
        cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
        par_set = ParameterSet.from_specs(cfg.parameters)
        key = jax.random.PRNGKey(3)
        rng = np.random.default_rng(1)
        prev = (
            jnp.asarray(rng.uniform(0.2, 0.8, (40, 6))),
            jnp.full((40,), 1.0 / 40),
            jnp.full((6,), 0.01),
        )
        res = {}
        for rb in (0, 32):
            gen = ShardedGeneration(
                par_set, ParameterTransform(cfg.parameters), sim, obs,
                mesh=particle_mesh(jax.devices()),
                pls_optimal_method="vdv", vdv_permutations=99,
                dtype=jnp.float64, row_block=rb, filter_type=ft,
            )
            res[rb] = gen.step_precomputed(key, params, mets, 64, 128, prev)
        a, b = res[0], res[32]
        assert int(a.ncomp_used) == int(b.ncomp_used)
        np.testing.assert_array_equal(
            np.asarray(a.survivor_idx), np.asarray(b.survivor_idx)
        )
        np.testing.assert_allclose(
            np.asarray(a.distances), np.asarray(b.distances),
            rtol=1e-12, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(a.weights), np.asarray(b.weights), rtol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(a.next_params), np.asarray(b.next_params), rtol=1e-9
        )


def test_run_scan_chunked_matches_resident():
    """The chunked row passes are inner lax.scans; run_scan nests them
    inside its outer generation scan. The nested program must compile and
    reproduce the resident run_scan exactly."""
    g_res = make_gen(dtype=jnp.float64)
    g_chk = make_gen(dtype=jnp.float64)
    g_chk.row_block = 16
    n, keep, gens = 64, 16, 4
    key = jax.random.PRNGKey(11)
    r1, h1 = g_res.run_scan(key, n, keep, gens)
    r2, h2 = g_chk.run_scan(key, n, keep, gens)
    np.testing.assert_array_equal(
        np.asarray(r1.survivor_idx), np.asarray(r2.survivor_idx)
    )
    np.testing.assert_allclose(
        np.asarray(r1.weights), np.asarray(r2.weights), rtol=1e-10
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(h1), jax.tree_util.tree_leaves(h2)
    ):
        assert a.shape == b.shape


@pytest.mark.parametrize("offset", [0.0, 2.0])
def test_chunked_box_cox_matches_resident(offset):
    """Box-Cox composes with the chunked row passes: blocked column-min +
    lambda-grid moment passes, then the chosen transform applied per block
    on the fly (vdv window and distances included). Must reproduce the
    resident box-cox path exactly - same lambda selection, survivors,
    distances, weights - including a padded, non-dividing-block shape.

    offset=0: strictly positive metrics (column shift is exactly 0).
    offset=2: nonpositive metric columns, exercising the blocked
    column-min pass and the shift/clamp logic (shift > 0 branch)."""
    n = 900   # pads to 904 on 8 devices (ln = 113); block 32 overlaps
    cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
    # strictly positive, skewed metrics so the transform has work to do
    mets = jnp.exp(mets * 0.5) - offset
    obs = np.exp(obs * 0.5) - offset
    par_set = ParameterSet.from_specs(cfg.parameters)
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(1)
    prev = (
        jnp.asarray(rng.uniform(0.2, 0.8, (40, 6))),
        jnp.full((40,), 1.0 / 40),
        jnp.full((6,), 0.01),
    )
    res = {}
    for rb in (0, 32):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()),
            pls_optimal_method="vdv", vdv_permutations=99,
            dtype=jnp.float64, row_block=rb, box_cox=True,
        )
        res[rb] = gen.step_precomputed(key, params, mets, 64, 128, prev)
    a, b = res[0], res[32]
    assert int(a.ncomp_used) == int(b.ncomp_used)
    np.testing.assert_array_equal(
        np.asarray(a.survivor_idx), np.asarray(b.survivor_idx)
    )
    np.testing.assert_allclose(
        np.asarray(a.distances), np.asarray(b.distances),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(a.weights), np.asarray(b.weights), rtol=1e-10
    )


def test_run_scan_matches_sequential_run():
    """run_scan (all generations inside ONE jitted lax.scan program) must
    reproduce the sequential step-by-step run() exactly - same key chain,
    same math, no per-generation dispatch."""
    gen = make_gen(dtype=jnp.float64)
    n, keep, gens = 64, 16, 4
    key = jax.random.PRNGKey(11)

    res_seq, hist_seq = gen.run(key, [n] * gens, [keep] * gens)
    res_scan, hist_scan = gen.run_scan(key, n, keep, gens)

    np.testing.assert_array_equal(
        np.asarray(res_seq.survivor_idx), np.asarray(res_scan.survivor_idx)
    )
    np.testing.assert_allclose(
        np.asarray(res_seq.weights), np.asarray(res_scan.weights),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res_seq.doubled_variance),
        np.asarray(res_scan.doubled_variance), rtol=1e-12,
    )
    # history: per-generation survivor tuples line up with the sequential
    # states (run()'s history stores (survivor_params, weights, dv))
    (s_idx, s_par, s_met, s_w, s_dv, s_ncomp) = hist_scan
    assert s_idx.shape == (gens, keep)
    assert s_par.shape == (gens, keep, 2)
    assert s_met.shape == (gens, keep, 2)
    for t in range(gens):
        np.testing.assert_allclose(
            np.asarray(hist_seq[t][0]), np.asarray(s_par[t]), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(hist_seq[t][1]), np.asarray(s_w[t]), rtol=1e-12
        )
    # single- and two-generation edges compile and agree with themselves
    r1, h1 = gen.run_scan(key, n, keep, 1)
    assert h1[0].shape == (1, keep)
    r2, h2 = gen.run_scan(key, n, keep, 2)
    assert h2[0].shape == (2, keep)


def test_sharded_box_cox_matches_host():
    """The fused device Box-Cox stage (global-min shift
    via pmin, per-column lambda by |skewness| over the fixed grid via
    two-pass central-moment psums) must agree with the host rule
    (ranking.apply_box_cox) on identical, genuinely-skewed data - and must
    actually change the ranking relative to box_cox off."""
    from abcsmc_tpu.ops import ranking

    n, keep = 240, 30
    cfg, params, _, obs_lin, sim = _linear_gaussian_problem(n, nmet=5)
    rng = np.random.default_rng(13)
    # strongly right-skewed metrics: exp of a params-driven signal
    lin = np.asarray(params) @ rng.normal(size=(6, 5)) * 0.8
    mets = jnp.asarray(np.exp(lin + 0.3 * rng.normal(size=(n, 5))))
    obs = np.exp(np.full(5, 0.4))
    par_set = ParameterSet.from_specs(cfg.parameters)

    order, dists = ranking.ranking_pls(
        mets, params, jnp.asarray(obs), 0.5, box_cox=True,
        optimal_method="tolerance",
    )
    host_surv = np.asarray(order)[:keep]

    def run_dev(box_cox):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(), pls_optimal_method="tolerance",
            box_cox=box_cox, dtype=jnp.float64,
        )
        return gen.step_precomputed(
            jax.random.PRNGKey(0), params, mets, keep, 0, None
        )

    res = run_dev(True)
    np.testing.assert_array_equal(
        np.sort(np.asarray(res.survivor_idx)), np.sort(host_surv)
    )
    np.testing.assert_allclose(
        np.asarray(res.distances)[:n][host_surv],
        np.asarray(dists)[host_surv], rtol=1e-8,
    )
    # survivor metrics stay RAW (the transform is ranking-side only)
    np.testing.assert_allclose(
        np.asarray(res.survivor_metrics),
        np.asarray(mets)[np.asarray(res.survivor_idx)], rtol=1e-12,
    )
    # the stage is live: it changes the ranking on skewed data
    res_off = run_dev(False)
    assert not np.array_equal(
        np.sort(np.asarray(res.survivor_idx)),
        np.sort(np.asarray(res_off.survivor_idx)),
    )


def test_sharded_box_cox_padding_rows_cannot_poison():
    """Padding rows are real draws NOT bounded by the valid rows' metric
    minimum; if their shifted values reach log/pow unclamped, 0 * NaN = NaN
    poisons every masked Box-Cox moment psum. Regression: an adversarial
    padded buffer whose tail metrics are negative while every valid metric
    is positive (so no shift is applied) must still produce finite
    distances and weights."""
    from abcsmc_tpu.models.simulators import DeviceSimulator

    gen = make_gen(box_cox=True, pls_optimal_method="tolerance",
                   dtype=jnp.float64)
    gen.simulator = DeviceSimulator(
        lambda p, key: jnp.stack([p[0], p[0] * 2.0]), nmet=2
    )
    gen.obs = np.array([1.5, 3.0])

    n, n_pad, keep = 300, 304, 30
    rng = np.random.default_rng(5)
    params = np.empty((n_pad, 2))
    params[:n] = rng.uniform(1.0, 2.0, (n, 2))   # metrics in [1, 4]: no shift
    params[n:] = -3.0                            # tail metrics negative
    seeds = jnp.asarray(rng.integers(0, 2**31, n_pad).astype(np.uint32))
    res = gen.step(
        jax.random.PRNGKey(0), jnp.asarray(params), seeds, keep, 0,
        None, n_valid=n,
    )
    d = np.asarray(res.distances)
    assert np.all(np.isfinite(d[:n]))
    assert np.all(np.isinf(d[n:]))
    assert np.all(np.isfinite(np.asarray(res.weights)))
    assert np.all(np.asarray(res.survivor_idx) < n)


def test_sharded_systematic_resampling():
    """resample_method="systematic" on the mesh: one global set of strata
    tiles the whole next population across shards (the offset is shared, the
    stratum index is the global row index), and proposals stay in support."""
    gen = make_gen(resample_method="systematic")
    res = run_generations(gen)
    nxt = np.asarray(res.next_params)
    assert nxt.shape == (64, 2)
    assert nxt.min() >= 1 and nxt.max() <= 50
    assert np.all(nxt == np.round(nxt))
    # from a FIXED population and key, both mesh layouts must agree on the
    # survivors, and a constant column (dv == 0 -> zero noise) must pass the
    # systematic picks through unchanged on both
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(1)
    params = jnp.asarray(np.stack([
        rng.integers(1, 51, size=64),
        np.full(64, 7.0),                # constant -> dv 0 -> pure pick
    ], axis=1).astype(np.float32))
    seeds = jnp.asarray(
        rng.integers(0, 2**31, size=64, dtype=np.int64).astype(np.uint32)
    )
    res8 = gen.step(key, params, seeds, 16, 64, None)
    gen1 = make_gen(n_devices=1, resample_method="systematic")
    res1 = gen1.step(key, params, seeds, 16, 64, None)
    # same survivors both layouts; constant column passes picks through
    np.testing.assert_array_equal(
        np.sort(np.asarray(res8.survivor_idx)),
        np.sort(np.asarray(res1.survivor_idx)),
    )
    assert np.all(np.asarray(res8.next_params)[:, 1] == 7.0)
    assert np.all(np.asarray(res1.next_params)[:, 1] == 7.0)
    # (the floor/ceil count invariance of systematic picks is pinned on the
    # host function in tests/test_resample.py)


def test_sharded_systematic_non_divisible_next():
    """Padded next populations (n_next % ndev != 0) under systematic
    resampling: strata are counted over the TRUE next size, pad rows clamp
    into the last stratum, and the masked next step consumes the buffer."""
    gen = make_gen(resample_method="systematic")
    key = jax.random.PRNGKey(3)
    k0, k1, k2 = jax.random.split(key, 3)
    params, seeds = gen.init_population(k0, 64)
    r1 = gen.step(k1, params, seeds, 16, 300, None)          # next: 300 on 8 dev
    assert r1.next_params.shape[0] == 304                     # padded buffer
    nxt = np.asarray(r1.next_params)
    assert nxt.min() >= 1 and nxt.max() <= 50
    state = (r1.survivor_params, r1.weights, r1.doubled_variance)
    r2 = gen.step(k2, r1.next_params, r1.next_seeds, 20, 0, state, n_valid=300)
    assert r2.survivor_params.shape == (20, 2)
    assert np.all(np.asarray(r2.survivor_idx) < 300)          # pads never survive


@pytest.mark.parametrize(
    "noise,resample",
    [("INDEPENDENT", "multinomial"), ("MULTIVARIATE", "systematic")],
)
def test_propose_split_matches_fused_step(noise, resample):
    """The split-propose phase (its own sharded program; auto above 2^26
    rows/shard, forced here) must produce draws IDENTICAL to the fused
    step's proposal: same replicated step key -> same resample picks, same
    perturbation, same seeds."""
    n, keep = 64, 16
    cfg, params, mets, obs, sim = _linear_gaussian_problem(n)
    par_set = ParameterSet.from_specs(cfg.parameters)
    key = jax.random.PRNGKey(9)
    rng = np.random.default_rng(4)
    prev = (
        jnp.asarray(rng.uniform(0.2, 0.8, (keep, 6))),
        jnp.full((keep,), 1.0 / keep),
        jnp.full((6,), 0.01),
    )
    res = {}
    for split in (False, True):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()),
            noise_type=NoiseType[noise], resample_method=resample,
            dtype=jnp.float64, propose_split=split,
        )
        res[split] = gen.step_precomputed(key, params, mets, keep, n, prev)
    a, b = res[False], res[True]
    np.testing.assert_array_equal(
        np.asarray(a.survivor_idx), np.asarray(b.survivor_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(a.next_seeds), np.asarray(b.next_seeds)
    )
    np.testing.assert_allclose(
        np.asarray(a.next_params), np.asarray(b.next_params),
        rtol=0, atol=0,
    )
    np.testing.assert_allclose(
        np.asarray(a.weights), np.asarray(b.weights), rtol=0, atol=0
    )


def test_sorted_searchsorted_matches_searchsorted():
    """_sorted_searchsorted == jnp.searchsorted(side='left') for ascending
    queries, including zero-width buckets (zero-weight survivors) and
    queries landing in the first/last bucket."""
    from abcsmc_tpu.parallel.generation import _sorted_searchsorted

    rng = np.random.default_rng(0)
    for trial in range(8):
        k = int(rng.integers(2, 40))
        w = rng.uniform(0, 1, k)
        w[rng.uniform(size=k) < 0.3] = 0.0   # zero-weight survivors
        if w.sum() == 0:
            w[0] = 1.0
        cdf = jnp.asarray(np.cumsum(w), jnp.float64)
        n = int(rng.integers(1, 200))
        q = jnp.asarray(
            np.sort(rng.uniform(0, float(cdf[-1]) * 0.999999, n)),
            jnp.float64,
        )
        got = np.asarray(_sorted_searchsorted(cdf, q, n))
        want = np.asarray(jnp.searchsorted(cdf, q))
        np.testing.assert_array_equal(got, want)


def test_sorted_pick_path_statistics_and_equivalence():
    """The big-N sorted-spacings pick path (forced via sorted_pick_min=1)
    must (a) resample with the right marginal law - empirical parent counts
    track the weights - and (b) stay bit-identical between the fused and
    split-propose programs."""
    n, keep = 512, 8
    cfg, params, mets, obs, sim = _linear_gaussian_problem(64)
    par_set = ParameterSet.from_specs(cfg.parameters)
    rng = np.random.default_rng(7)
    w_np = rng.uniform(0.1, 1.0, keep)
    w_np[0] = 5.0                      # one heavy survivor
    prev = (
        jnp.asarray(rng.uniform(0.2, 0.8, (keep, 6))),
        jnp.asarray(w_np / np.linalg.norm(w_np)),
        jnp.full((6,), 0.01),
    )
    key = jax.random.PRNGKey(3)
    res = {}
    for split in (False, True):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()),
            dtype=jnp.float64, propose_split=split,
        )
        gen.sorted_pick_min = 1       # force the sorted-spacings path
        res[split] = gen.step_precomputed(
            key, params[:64], mets, keep, n, prev)
    np.testing.assert_array_equal(
        np.asarray(res[False].next_seeds), np.asarray(res[True].next_seeds))
    np.testing.assert_allclose(
        np.asarray(res[False].next_params),
        np.asarray(res[True].next_params), rtol=0, atol=0)

    # marginal law: propose with near-zero noise so each next row sits on
    # its parent; empirical parent frequencies must track the weights
    gen = ShardedGeneration(
        par_set, ParameterTransform(cfg.parameters), sim, obs,
        mesh=particle_mesh(jax.devices()), dtype=jnp.float64,
    )
    gen.sorted_pick_min = 1
    n_draw = 8192
    surv = jnp.asarray(rng.uniform(0.2, 0.8, (keep, 6)))
    w = jnp.asarray(w_np / w_np.sum())
    nxt, _ = gen.propose(
        key, surv, w, jnp.full((6,), 1e-12), n_draw)
    d = np.linalg.norm(
        np.asarray(nxt)[:, None, :] - np.asarray(surv)[None, :, :], axis=2)
    parent = d.argmin(axis=1)
    freq = np.bincount(parent, minlength=keep) / n_draw
    share = np.asarray(w)
    # multinomial se ~ sqrt(p(1-p)/n) <= 0.0055; allow 5 se
    np.testing.assert_allclose(freq, share, atol=0.03)


def test_systematic_sorted_pick_matches_sort_path():
    """Systematic resampling's stratum points are deterministic given the
    key, so the sorted-pick path (forced via sorted_pick_min=1, including
    the monotone cummax guard) must produce IDENTICAL proposals to the
    sort-based path on the same key."""
    n, keep = 96, 12
    cfg, params, mets, obs, sim = _linear_gaussian_problem(64)
    par_set = ParameterSet.from_specs(cfg.parameters)
    rng = np.random.default_rng(2)
    prev = (
        jnp.asarray(rng.uniform(0.2, 0.8, (keep, 6))),
        jnp.asarray(rng.uniform(0.5, 1.5, keep)),
        jnp.full((6,), 0.01),
    )
    key = jax.random.PRNGKey(13)
    res = {}
    for gate in (1, 1 << 40):
        gen = ShardedGeneration(
            par_set, ParameterTransform(cfg.parameters), sim, obs,
            mesh=particle_mesh(jax.devices()),
            resample_method="systematic", dtype=jnp.float64,
        )
        gen.sorted_pick_min = gate
        res[gate] = gen.step_precomputed(key, params[:64], mets, keep, n, prev)
    np.testing.assert_allclose(
        np.asarray(res[1].next_params), np.asarray(res[1 << 40].next_params),
        rtol=0, atol=0,
    )
    np.testing.assert_array_equal(
        np.asarray(res[1].next_seeds), np.asarray(res[1 << 40].next_seeds))


def test_vdv_miscompile_flag(monkeypatch):
    """The in-program U0 self-check: the observed row of the van der Voet
    moment matmul is a sum of squares (>= 0 in any rounding order); injecting
    a corrupted product - the fusion miscompile fingerprint of
    docs/DESIGN.md "Miscompile guard" - must surface as a NEGATIVE
    reported ncomp_used, and the engine must refuse to mirror the run."""
    import abcsmc_tpu.parallel.generation as G

    orig = G._vdv_moment_dot

    def corrupted(W, rhs):
        # negate the observed row: exactly the on-hardware failure signature
        # (row 0 of U came back negative in its sum-of-squares section)
        return orig(W, rhs).at[0, :].multiply(-1.0)

    # healthy run first (fresh builder: per-instance step cache)
    gen_ok = make_gen()
    res_ok = run_generations(gen_ok, gens=1)
    assert int(np.asarray(res_ok.ncomp_used)) >= 1

    monkeypatch.setattr(G, "_vdv_moment_dot", corrupted)
    gen_bad = make_gen()
    res_bad = run_generations(gen_bad, gens=1)
    flagged = int(np.asarray(res_bad.ncomp_used))
    assert flagged < 0, flagged
    # sign encodes the flag; magnitude is still the computed count
    assert -flagged >= 1

    # engine level: run_device raises rather than mirroring a corrupted
    # generation into the store
    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.errors import AbcError
    from abcsmc_tpu.storage import MemoryStorage

    cfg = {
        "smc_iterations": 2,
        "num_samples": 64,
        "predictive_prior_fraction": 0.25,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                 storage=MemoryStorage())
    with pytest.raises(AbcError, match="self-check"):
        abc.run_device(seed=1)
    # the check runs BEFORE any store write for the set: the poisoned
    # generation must not have been durably mirrored as complete-and-ranked
    # (a resume would otherwise ingest it as valid - the store has no ncomp
    # column to tell it apart)
    assert not abc.storage.exists() or abc.storage.is_empty()


def test_assemble_rows_chunked_matches_device_get():
    """The chunked row-psum fetch (parallel/mesh.py) - used so multi-process
    mirroring of HBM-bound populations never materializes a full replicated
    copy - reassembles the exact array for every window/size relationship:
    n a multiple of the chunk, a partial final window (which slides back and
    keeps only its fresh tail), n smaller than one chunk, and integer
    dtypes (the seeds buffer)."""
    from abcsmc_tpu.parallel.mesh import (
        assemble_rows_chunked,
        particle_mesh,
        particle_sharding,
    )

    mesh = particle_mesh()
    shard = particle_sharding(mesh)
    rng = np.random.default_rng(7)
    for n, chunk in ((64, 16), (64, 24), (40, 64), (8, 8)):
        f = jax.device_put(
            jnp.asarray(rng.normal(size=(n, 3))), shard
        )
        np.testing.assert_array_equal(
            assemble_rows_chunked(f, mesh, chunk), np.asarray(f)
        )
        u = jax.device_put(
            jnp.asarray(rng.integers(0, 2**31, size=n, dtype=np.int64),
                        jnp.uint32),
            shard,
        )
        np.testing.assert_array_equal(
            assemble_rows_chunked(u, mesh, chunk), np.asarray(u)
        )
        # scan-history layout: [G, N, ...] with the population on axis 1
        from jax.sharding import NamedSharding, PartitionSpec

        h = jax.device_put(
            jnp.asarray(rng.normal(size=(3, n, 2))),
            NamedSharding(mesh, PartitionSpec(None, "particles")),
        )
        np.testing.assert_array_equal(
            assemble_rows_chunked(h, mesh, chunk, axis=1), np.asarray(h)
        )


def test_topk_two_stage_equivalence():
    """The two-stage global top-K (distance gather -> replicated decision ->
    mesh-size-independent row psum) is BIT-identical to the single-stage
    candidate-row gather: same top_k on the same distances (identical tie
    breaks), psum of exact zeros plus exact row values. Covers keep % ndev
    != 0, keep > local_n (k_local capped), and padded populations."""
    key = jax.random.PRNGKey(3)
    for n, keep in ((64, 16), (64, 13), (40, 24), (300, 30)):
        a = make_gen(topk_two_stage=False)
        b = make_gen(topk_two_stage=True)
        key, k0, k1 = jax.random.split(key, 3)
        params, seeds = a.init_population(k0, n)
        ra = a.step(k1, params, seeds, keep, n, None, n_valid=n)
        rb = b.step(k1, params, seeds, keep, n, None, n_valid=n)
        np.testing.assert_array_equal(
            np.asarray(ra.survivor_idx), np.asarray(rb.survivor_idx),
        )
        np.testing.assert_array_equal(
            np.asarray(ra.survivor_params), np.asarray(rb.survivor_params),
        )
        np.testing.assert_array_equal(
            np.asarray(ra.survivor_metrics), np.asarray(rb.survivor_metrics),
        )
        np.testing.assert_array_equal(
            np.asarray(ra.weights), np.asarray(rb.weights),
        )
        np.testing.assert_array_equal(
            np.asarray(ra.next_params), np.asarray(rb.next_params),
        )

    # a weighted (non-first) generation through both paths too
    a = make_gen(topk_two_stage=False)
    b = make_gen(topk_two_stage=True)
    ra = run_generations(a, gens=2, seed=9)
    rb = run_generations(b, gens=2, seed=9)
    np.testing.assert_array_equal(
        np.asarray(ra.survivor_idx), np.asarray(rb.survivor_idx),
    )
    np.testing.assert_array_equal(
        np.asarray(ra.weights), np.asarray(rb.weights),
    )

    # the auto rule: off on 1 device, on above the payload threshold
    g1 = make_gen(n_devices=1)
    assert g1._topk_two_stage_active(10**6, 10**6) is False
    g8 = make_gen()
    assert g8._topk_two_stage_active(50_000, 131_072) == (
        8 * 50_000 * 4 * jnp.dtype(g8.dtype).itemsize
        >= g8._TOPK_TWO_STAGE_BYTES
    )


def test_large_mean_metric_moments_f32():
    """f32 z-scoring moments must survive |mean| >> sd data (epi-count
    scale): the raw-moment formula s2 - n*mean^2 loses every sd digit at
    mean ~1e5 (s2 and n*mean^2 agree to f32 ulp), silently zeroing or
    mis-scaling the metric scales that drive ranking. The shifted
    accumulation (generation.py, centered on the replicated observed
    vector) keeps f32 device distances within 1e-3 of the host f64
    two-pass rule on the same (f32-quantized) data."""
    from abcsmc_tpu.ops import ranking

    rng = np.random.default_rng(11)
    n, keep = 64, 16
    params = rng.uniform(1, 50, (n, 2))
    mets32 = np.stack([
        1e5 + 30.0 * rng.normal(size=n),     # |mean| >> sd
        100.0 * rng.normal(size=n),          # ordinary scale
    ], axis=1).astype(np.float32)
    obs = np.array([1e5, 0.0])

    gen = make_gen(filter_type=FilterType.SIMPLE, dtype=jnp.float32)
    gen.obs = obs
    res = gen.step_precomputed(
        jax.random.PRNGKey(0), jnp.asarray(params, jnp.float32),
        jnp.asarray(mets32), keep, 0, None,
    )
    order, host_d = ranking.ranking_simple(
        jnp.asarray(mets32, jnp.float64), jnp.asarray(obs, jnp.float64)
    )
    dev_d = np.asarray(res.distances)[:n]
    np.testing.assert_allclose(dev_d, np.asarray(host_d), rtol=1e-3)
    assert set(np.asarray(res.survivor_idx).tolist()) == set(
        np.asarray(order)[:keep].tolist()
    )


def test_large_mean_pls_moments_f32():
    """The PLS path's parameter z-scoring has the same f32 hazard; the
    shift center is the prior means on the first generation (statically
    known) and the previous survivor means afterwards. An f32 step on
    mean-1e6 parameters must agree with the f64 step on identical data."""
    from abcsmc_tpu.models.simulators import make_dice_simulator

    spec = [
        {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": 999900.0, "par2": 1000100.0},
        {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": 999900.0, "par2": 1000100.0},
    ]
    cfg = parse_config({
        "smc_iterations": 2, "num_samples": 64,
        "predictive_prior_fraction": 0.25,
        "parameters": spec,
        "metrics": [
            {"name": "m1", "num_type": "FLOAT", "value": 2e6},
            {"name": "m2", "num_type": "FLOAT", "value": 100.0},
        ],
    })
    rng = np.random.default_rng(7)
    n, keep = 64, 16
    params64 = rng.uniform(999900, 1000100, (n, 2))
    mets64 = np.stack([
        params64.sum(axis=1) + 5.0 * rng.normal(size=n),
        (params64[:, 0] - params64[:, 1]) + 5.0 * rng.normal(size=n),
    ], axis=1)
    params32 = params64.astype(np.float32)
    mets32 = mets64.astype(np.float32)
    obs = np.array([2e6, 100.0])
    key = jax.random.PRNGKey(3)

    results = {}
    for dtype, p, m in (
        (jnp.float32, params32, mets32),
        (jnp.float64, params32.astype(np.float64),
         mets32.astype(np.float64)),
    ):
        gen = ShardedGeneration(
            ParameterSet.from_specs(cfg.parameters),
            ParameterTransform(cfg.parameters),
            make_dice_simulator(max_dice=50),  # unused: precomputed mets
            obs, mesh=particle_mesh(), dtype=dtype,
        )
        results[str(dtype)] = gen.step_precomputed(
            key, jnp.asarray(p, dtype), jnp.asarray(m, dtype), keep, 0,
            None,
        )
    r32, r64 = results["<class 'jax.numpy.float32'>"], results[
        "<class 'jax.numpy.float64'>"
    ]
    assert np.all(np.isfinite(np.asarray(r32.weights)))
    assert set(np.asarray(r32.survivor_idx).tolist()) == set(
        np.asarray(r64.survivor_idx).tolist()
    )
    assert int(r32.ncomp_used) == int(r64.ncomp_used)


def test_far_obs_moments_f32():
    """The mirrored f32 hazard: centering moments on the OBSERVED vector
    alone would cancel catastrophically when a (misfit) model simulates
    far from obs - e.g. metrics ~ N(0, 0.01) against obs = 1e4 collapses
    the shifted one-pass sd to 0 exactly where the raw formula is exact.
    The dual-frame accumulators (_dual_moment_stats) pick the raw frame
    per column there, so device distances at f32 must still match the
    host f64 two-pass rule."""
    from abcsmc_tpu.ops import ranking

    rng = np.random.default_rng(5)
    n, keep = 64, 16
    params = rng.uniform(1, 50, (n, 2))
    mets32 = np.stack([
        0.01 * rng.normal(size=n),           # sims ~N(0, 0.01), obs 1e4
        100.0 * rng.normal(size=n),          # ordinary scale
    ], axis=1).astype(np.float32)
    obs = np.array([1e4, 0.0])

    gen = make_gen(filter_type=FilterType.SIMPLE, dtype=jnp.float32)
    gen.obs = obs
    res = gen.step_precomputed(
        jax.random.PRNGKey(0), jnp.asarray(params, jnp.float32),
        jnp.asarray(mets32), keep, 0, None,
    )
    order, host_d = ranking.ranking_simple(
        jnp.asarray(mets32, jnp.float64), jnp.asarray(obs, jnp.float64)
    )
    dev_d = np.asarray(res.distances)[:n]
    host_dn = np.asarray(host_d)
    np.testing.assert_allclose(dev_d, host_dn, rtol=1e-3)
    assert set(np.asarray(res.survivor_idx).tolist()) == set(
        np.asarray(order)[:keep].tolist()
    )


def test_far_obs_moments_f32_chunked():
    """The same dual-frame selection through the CHUNKED row passes
    (row_block forced): the blocked pass_moments carries both frames'
    accumulators with overlap de-counting; a mis-masked raw accumulator
    would only surface at f32 big-N production shapes otherwise."""
    from abcsmc_tpu.ops import ranking

    rng = np.random.default_rng(5)
    n, keep = 64, 16
    params = rng.uniform(1, 50, (n, 2))
    mets32 = np.stack([
        0.01 * rng.normal(size=n),           # far-obs regime vs obs 1e4
        1e5 + 30.0 * rng.normal(size=n),     # large-mean regime
    ], axis=1).astype(np.float32)
    obs = np.array([1e4, 1e5])

    gen = make_gen(filter_type=FilterType.SIMPLE, dtype=jnp.float32)
    gen.obs = obs
    gen.row_block = 8   # force the blocked scan (64/8dev -> ln=8, bs=8)
    res = gen.step_precomputed(
        jax.random.PRNGKey(0), jnp.asarray(params, jnp.float32),
        jnp.asarray(mets32), keep, 0, None,
    )
    order, host_d = ranking.ranking_simple(
        jnp.asarray(mets32, jnp.float64), jnp.asarray(obs, jnp.float64)
    )
    np.testing.assert_allclose(
        np.asarray(res.distances)[:n], np.asarray(host_d), rtol=1e-3
    )
    assert set(np.asarray(res.survivor_idx).tolist()) == set(
        np.asarray(order)[:keep].tolist()
    )


def test_dual_moment_stats_shifted_overflow_falls_back_to_raw():
    """If the SHIFTED accumulators overflow f32 (data near 0, |obs| ~ 2e19),
    ratio_c is NaN and the raw frame must be chosen: mean and sd stay the
    raw frame's finite values instead of NaN-poisoning the z-scores."""
    from abcsmc_tpu.parallel.generation import _dual_moment_stats

    f32 = jnp.float32
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    c = jnp.asarray([2e19], f32)
    s1c = jnp.asarray([np.sum(x) - 4 * 2e19], f32)
    s2c = jnp.asarray([np.inf], f32)                 # (x - c)^2 overflowed
    s1r = jnp.asarray([x.sum()], f32)
    s2r = jnp.asarray([(x * x).sum()], f32)
    mean, sd, _ = _dual_moment_stats(s1c, s2c, s1r, s2r, c, 4)
    np.testing.assert_allclose(np.asarray(mean), [2.5], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sd), [x.std(ddof=1)], rtol=1e-5)
