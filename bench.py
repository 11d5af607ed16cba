"""One fused SMC generation on the GPU: 1M particles, 6 parameters x 13
metrics, 50k kept, simulator excluded (metrics are inputs). PLS ranking,
global top-K, mixture weights, resample and perturbation - the whole
device step.

    python bench.py

Prints one JSON line naming the device it ran on. Needs a GPU: on any other
platform it exits non-zero without a result. The helpers here build the
step and its rank-structured inputs for chip_smoke.py too.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N, KEEP = 1_000_000, 50_000
NPAR, NMET = 6, 13


def bench_generation(n: int, keep: int, mesh=None, **kw):
    """A ShardedGeneration for the bench shape: U(0, 1) priors, observed
    metrics at the origin, float32."""
    import jax.numpy as jnp

    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    cfg = parse_config({
        "smc_iterations": 2, "num_samples": n, "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": 0.0}
            for j in range(NMET)
        ],
    })
    return ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_linear_gaussian_simulator(NPAR, NMET),   # unused: metrics given
        np.zeros(NMET), mesh=mesh or particle_mesh(), dtype=jnp.float32,
        **kw,
    )


def bench_inputs(n: int, keep: int):
    """Rank-structured metrics (params @ mix + noise), made on the device, so
    PLS selection has real structure to find, and a previous generation's
    survivor state."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(2024), 4)
    params = jax.random.uniform(k1, (n, NPAR), jnp.float32)
    mix = jax.random.normal(k2, (NPAR, NMET), jnp.float32)
    mets = params @ mix + 0.3 * jax.random.normal(k3, (n, NMET), jnp.float32)
    state = (
        jax.random.uniform(k4, (keep, NPAR), jnp.float32, 0.3, 0.7),
        jnp.full((keep,), 1.0 / keep, jnp.float32),
        jnp.full((NPAR,), 0.02, jnp.float32),
    )
    return params, mets, state


def main() -> int:
    import jax

    from abcsmc_tpu._cache import enable_persistent_cache

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    gen = bench_generation(N, KEEP)
    params, mets, state = bench_inputs(N, KEEP)

    def run(i):
        k = jax.random.fold_in(jax.random.PRNGKey(0), i)
        return gen.step_precomputed(k, params, mets, KEEP, N, state)

    t0 = time.perf_counter()
    res = jax.block_until_ready(run(0))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(1, 6):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(i))
        times.append(time.perf_counter() - t0)
    # rank-structured metrics must keep more than one PLS component; a
    # negative count is the in-program vdv self-check (docs/DESIGN.md)
    ncomp = int(res.ncomp_used)
    if ncomp <= 1:
        print(f"ncomp_used={ncomp}: degenerate or corrupted PLS component "
              "selection", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": (f"SMC generation, {N} particles ({NPAR} pars x {NMET} "
                   f"mets, keep {KEEP}), simulator excluded"),
        "value": float(np.median(times)), "unit": "s", "times_s": times,
        "first_call_s": compile_s, "ncomp_used": ncomp,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
