"""Pod-scale virtual-mesh worker: numerically EXECUTE the sharded regimes
that only appear above 8 devices, in a fresh process
whose CPU backend is configured with N virtual devices (the pytest process
itself is pinned to 8 by tests/conftest.py, so >8-device execution needs a
subprocess).

    python tests/scale_worker.py <n_devices> <scenario> <out_path>

Scenarios (each asserts internally, then writes one JSON line to out_path):

  bend_host_rule  N=4096, keep=500: local_n < keep at 16/32 devices (the
                  single-stage top-K "bend", where each shard contributes
                  its ENTIRE slice as candidates) AND keep % ndev != 0
                  (weight-kernel padding). The fused step must equal the
                  independently-written host rule (ops.ranking +
                  ops.weights) on identical inputs, and the two forced
                  top-K strategies must equal each other bit for bit.
  two_stage_auto  a shape whose candidate-gather payload crosses the
                  16 MiB/device auto threshold at this device count:
                  asserts the two-stage top-K self-activates and matches a
                  forced single-stage run bit for bit.
  engine          AbcSmc.run_device end-to-end (dice, 3 sets, 300 rows -
                  pad-and-mask since 300 % ndev != 0) with SQLite mirror.

Reference target: the cluster-scale fan-out heritage this framework
replaces (/root/reference/README.md:4, examples/scratch/job.slurm - 256
MPI ranks); these scenarios are the device-mesh analog at that count.
"""

import os
import json
import sys

import jax

n_devices = int(sys.argv[1])
scenario = sys.argv[2]
out_path = sys.argv[3]

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", n_devices)
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from abcsmc_tpu.config import FilterType, parse_config  # noqa: E402
from abcsmc_tpu.models.parameters import ParameterSet  # noqa: E402
from abcsmc_tpu.models.simulators import make_dice_simulator  # noqa: E402
from abcsmc_tpu.models.transforms import ParameterTransform  # noqa: E402
from abcsmc_tpu.parallel.generation import ShardedGeneration  # noqa: E402
from abcsmc_tpu.parallel.mesh import particle_mesh  # noqa: E402

assert len(jax.devices()) == n_devices, jax.devices()


def make_gen(**kw):
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
    return ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_dice_simulator(max_dice=50),
        np.array([44.0, 2.39925]),
        mesh=particle_mesh(),
        dtype=jnp.float64,
        **kw,
    )


def _emit(**kv):
    with open(out_path, "w") as fh:
        fh.write(json.dumps(kv) + "\n")


def bend_host_rule():
    from abcsmc_tpu.ops import ranking, stats, weights

    n, keep, npar, nmet = 4096, 500, 2, 2
    local_n = n // n_devices
    assert local_n < keep, (local_n, keep)   # the top-K bend regime
    assert keep % n_devices != 0             # weight-kernel padding regime
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

    # host rule (independently-written row-based path)
    order, dists = ranking.ranking_pls(
        mets, params, jnp.asarray(obs), 0.5, optimal_method="tolerance"
    )
    host_surv = np.asarray(order)[:keep]
    host_w = np.asarray(weights.weight_predictive_prior(
        params[host_surv], prev_par, prev_w, prev_dv,
        make_gen().par_set.prior_log_pdf,
    ))
    host_dv = np.asarray(stats.doubled_variance(params[host_surv]))

    results = {}
    for forced in (False, True):
        gen = make_gen(
            pls_optimal_method="tolerance", topk_two_stage=forced,
        )
        gen.obs = obs
        res = gen.step_precomputed(
            jax.random.PRNGKey(0), params, mets, keep, 0,
            (prev_par, prev_w, prev_dv),
        )
        results[forced] = (
            np.asarray(res.survivor_idx), np.asarray(res.weights),
            np.asarray(res.doubled_variance),
        )
        np.testing.assert_array_equal(
            np.sort(results[forced][0]), np.sort(host_surv)
        )
        dev_order = np.argsort(results[forced][0])
        host_order = np.argsort(host_surv)
        np.testing.assert_allclose(
            results[forced][1][dev_order], host_w[host_order], rtol=1e-8
        )
        np.testing.assert_allclose(results[forced][2], host_dv, rtol=1e-9)
    # the two strategies are bit-identical to EACH OTHER
    for a, b in zip(results[False], results[True]):
        np.testing.assert_array_equal(a, b)
    _emit(ok=True, scenario=scenario, n_devices=n_devices,
          local_n=local_n, keep=keep,
          surv_crc=int(np.bitwise_xor.reduce(results[False][0])),
          w_sum=float(results[False][1].sum()))


def two_stage_auto():
    n = 1 << 19
    keep = n // n_devices          # k_local == local_n == keep
    local_n = n // n_devices
    rng = np.random.default_rng(3)
    params = jnp.asarray(rng.integers(1, 51, (n, 2)), jnp.float64)
    mets = jnp.asarray(rng.normal(size=(n, 2)) + np.array([44.0, 2.4]))

    gen_auto = make_gen(filter_type=FilterType.SIMPLE)
    # candidate gather = ndev * k_local * (P+M) * 8 B = n * 32 B = 16 MiB:
    # exactly at the measured threshold -> auto must choose two-stage
    assert gen_auto._topk_two_stage_active(keep, local_n), (
        n_devices, keep, local_n,
    )
    gen_single = make_gen(filter_type=FilterType.SIMPLE,
                          topk_two_stage=False)
    r_a = gen_auto.step_precomputed(
        jax.random.PRNGKey(1), params, mets, keep, 0, None
    )
    r_s = gen_single.step_precomputed(
        jax.random.PRNGKey(1), params, mets, keep, 0, None
    )
    np.testing.assert_array_equal(
        np.asarray(r_a.survivor_idx), np.asarray(r_s.survivor_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(r_a.survivor_params), np.asarray(r_s.survivor_params)
    )
    np.testing.assert_array_equal(
        np.asarray(r_a.weights), np.asarray(r_s.weights)
    )
    _emit(ok=True, scenario=scenario, n_devices=n_devices, n=n, keep=keep,
          surv_crc=int(np.bitwise_xor.reduce(np.asarray(r_a.survivor_idx))))


def engine():
    from abcsmc_tpu.engine import AbcSmc

    cfg = {
        "smc_iterations": 3,
        "num_samples": 300,            # 300 % 16/32 != 0: pad-and-mask
        "predictive_prior_size": 30,   # 30 % 16/32 != 0: weight padding
        "database_filename": out_path + ".sqlite",
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
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50))
    abc.run_device(seed=7)
    gens = abc.storage.read_generations()
    assert len(gens) == 3 and all(g.complete for g in gens), [
        (g.set_num, g.size, g.complete) for g in gens
    ]
    assert all(g.size == 300 for g in gens)
    pars, w = abc.posterior()
    assert pars.shape == (30, 2) and np.all(np.isfinite(np.asarray(w)))
    abc.storage.close()
    _emit(ok=True, scenario=scenario, n_devices=n_devices,
          post_mean=float(np.asarray(pars).mean()))


if scenario == "bend_host_rule":
    bend_host_rule()
elif scenario == "two_stage_auto":
    two_stage_auto()
elif scenario == "engine":
    engine()
else:
    sys.exit(f"unknown scale_worker scenario {scenario!r}")
