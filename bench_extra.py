"""Extended benchmark sweep (informational; the single-line benchmark is
bench.py). Needs a GPU; prints one JSON line per measurement, each naming
the device:

- PLS fit (1k x 100 metrics, 10 components)
- mixture-weight denominator at several K: the Pallas kernel and the XLA path
- resample (inverse-CDF) at 1M draws
- full fused SMC generation at two population scales, simulator excluded
  and included (linear-gaussian surrogate)
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from abcsmc_tpu._cache import enable_persistent_cache


def timeit(f, *a, reps=5):
    """Median wall time after a warm-up call, each call ended by
    block_until_ready."""
    jax.block_until_ready(f(*a))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def emit(metric, seconds, **extra):
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric, "value": seconds * 1000, "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **extra,
    }), flush=True)


def main():
    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.ops import pls
    from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp
    from abcsmc_tpu.ops.weights import (
        _log_kernel_mixture_density_xla, _prep_scaled,
    )
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    ndev = len(jax.devices())

    # --- PLS fit: the BASELINE.md tracked shape ---
    x = jnp.asarray(rng.normal(size=(1000, 100)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(1000, 10)), jnp.float32)

    def fit10(x, y):
        return pls._fit_arrays(x, y, 10)

    emit("PLS fit 1k x 100 mets, 10 comps", timeit(jax.jit(fit10), x, y))

    # --- weight kernel vs the XLA path ---
    for k in (10_000, 50_000, 200_000):
        prev = jnp.asarray(rng.uniform(0.3, 0.7, (k, 6)), jnp.float32)
        lw = jnp.log(jnp.full((k,), 1.0 / k, jnp.float32))
        dv = jnp.full((6,), 0.02, jnp.float32)
        a, b, _ = _prep_scaled(prev, prev, dv)
        emit(f"mixture-weight denominator, Pallas kernel, {k}x{k}",
             timeit(lambda: mixture_logsumexp(a, b, lw)))
        emit(f"mixture-weight denominator, XLA path, {k}x{k}",
             timeit(lambda: _log_kernel_mixture_density_xla(
                 prev, prev, lw, dv)))

    # --- resample ---
    w = jnp.asarray(rng.uniform(0.5, 1.5, 50_000), jnp.float32)

    def resample1m(k, w):
        c = jnp.cumsum(w)
        u = jax.random.uniform(k, (1_000_000,), jnp.float32) * c[-1]
        return jnp.searchsorted(c, u, method="sort")

    emit("inverse-CDF resample 1M from 50k", timeit(jax.jit(resample1m), key, w))

    # --- full generations ---
    npar, nmet = 6, 13
    sim = make_linear_gaussian_simulator(npar, nmet)
    for n in (100_000, 1_000_000):
        n -= n % ndev
        keep = n // 20
        cfg = parse_config({
            "smc_iterations": 2, "num_samples": n,
            "predictive_prior_size": keep,
            "parameters": [
                {"name": f"p{i}", "dist_type": "UNIFORM",
                 "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                for i in range(npar)
            ],
            "metrics": [
                {"name": f"m{j}", "num_type": "FLOAT", "value": 0.0}
                for j in range(nmet)
            ],
        })
        gen = ShardedGeneration(
            ParameterSet.from_specs(cfg.parameters),
            ParameterTransform(cfg.parameters),
            sim, np.zeros(nmet), mesh=particle_mesh(),
        )
        params = jnp.asarray(rng.uniform(0, 1, (n, npar)), jnp.float32)
        seeds = jnp.asarray(
            rng.integers(0, 2**31, n, dtype=np.int64).astype(np.uint32)
        )
        mets = jnp.asarray(rng.normal(size=(n, nmet)), jnp.float32)
        state = (
            jnp.asarray(rng.uniform(0.3, 0.7, (keep, npar)), jnp.float32),
            jnp.full((keep,), 1.0 / keep, jnp.float32),
            jnp.full((npar,), 0.02, jnp.float32),
        )
        t = timeit(
            lambda k: gen.step_precomputed(k, params, mets, keep, n, state),
            key,
        )
        emit(
            f"SMC generation {n} particles (sim excluded)", t,
            particles_per_sec=round(n / t),
        )
        t = timeit(lambda k: gen.step(k, params, seeds, keep, n, state), key)
        emit(
            f"SMC generation {n} particles (sim included)", t,
            particles_per_sec=round(n / t),
        )


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench_extra.py needs a GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    enable_persistent_cache()
    main()
