"""A 1M-particle multi-generation SMC run sharded over whatever mesh is
available, with per-generation wall-times and survivor checkpoints.

    python examples/million_run.py [n_particles] [generations]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

from abcsmc_tpu._cache import enable_persistent_cache

enable_persistent_cache()


def main(n=1_000_000, gens=3):
    import jax.numpy as jnp

    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    npar, nmet = 6, 13
    keep = n // 20
    mesh = particle_mesh()
    ndev = mesh.devices.size
    n -= n % ndev

    rng = np.random.default_rng(42)
    truth = rng.uniform(0.2, 0.8, npar)
    sim = make_linear_gaussian_simulator(npar, nmet, noise_sd=0.1)
    obs = sim.run_batch(truth[None, :], np.array([7]), np.array([0]))[0]

    cfg = parse_config({
        "smc_iterations": gens,
        "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(nmet)
        ],
    })
    gen = ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        sim, obs, mesh=mesh,
    )

    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    t0 = time.perf_counter()
    params, seeds = gen.init_population(k0, n)
    jax.block_until_ready(params)
    print(f"[gen0 sample] {time.perf_counter()-t0:.2f}s "
          f"({n} particles, {ndev} x {jax.devices()[0].device_kind})")

    state = None
    for t in range(gens):
        key, kt = jax.random.split(key)
        t0 = time.perf_counter()
        res = gen.step(kt, params, seeds, keep, n, state)
        jax.block_until_ready(res)
        dt = time.perf_counter() - t0
        surv = np.asarray(res.survivor_params)
        err = np.abs(surv.mean(0) - truth).mean()
        label = "compile+run" if t == 0 else "run"
        print(f"[gen {t}] {label}: {dt:.2f}s  "
              f"({n/dt/1e6:.2f}M particles/s)  "
              f"mean |surv - truth| = {err:.4f}  "
              f"ncomp={int(res.ncomp_used)}")
        state = (res.survivor_params, res.weights, res.doubled_variance)
        params, seeds = res.next_params, res.next_seeds

    print("truth:    ", np.round(truth, 3).tolist())
    print("posterior:", np.round(surv.mean(0), 3).tolist())


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    g = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    main(n, g)
