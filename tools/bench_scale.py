"""Scale-decade generation benchmark: one steady-state SMC generation at an
arbitrary (N, keep) shape, with the big-N knobs exposed.

Data is generated ON DEVICE so host RAM and host-to-device transfer never
bound the measurable shape. Needs a GPU. One JSON line per measurement, each
naming the device.

Usage:
  python tools/bench_scale.py \
      --n 50000000 --keep 500000 [--row-block B] [--max-comp C] \
      [--sim] [--reps 3]

--row-block 0 forces the resident row passes, a positive value forces that
block size, omitted = the engine's auto threshold (row_chunk_threshold, a
rule in bytes against the device's memory).
--max-comp caps PLS components (the round-2 workaround for the [N, A] score
matrix; with chunked row passes the natural A fits, so the default is
uncapped). --sim adds a run with the linear-Gaussian device simulator
included (fused into the same program).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
from abcsmc_tpu._cache import enable_persistent_cache  # noqa: E402

sync = jax.block_until_ready


def timeit(f, *a, reps=3):
    """Returns (min seconds over reps, the warmup call's result)."""
    warm = f(*a)
    sync(warm)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(f(*a))
        ts.append(time.perf_counter() - t0)
    return min(ts), warm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--keep", type=int, default=500_000)
    ap.add_argument("--row-block", type=int, default=None)
    ap.add_argument("--max-comp", type=int, default=None)
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--phases", action="store_true",
        help="measure rank-phase (n_next=0) and propose-phase separately, "
        "freeing the population buffers in between - the sequence the "
        "engine runs at HBM-bound shapes (it mirrors, frees, proposes); "
        "the full-generation number is the sum",
    )
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_scale.py needs a GPU; JAX found {dev.platform!r}")
    enable_persistent_cache()

    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    npar, nmet = 6, 13
    ndev = len(jax.devices())
    n = args.n - args.n % ndev
    keep = args.keep
    cfg = parse_config({
        "smc_iterations": 2, "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": 0.0}
            for j in range(nmet)
        ],
    })
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)

    # data generated on device: at 100M the [N, M] matrices are gigabytes -
    # host-side generation would bound the bench by the host transfer
    mix = jnp.asarray(rng.normal(size=(npar, nmet)), jnp.float32)

    @jax.jit
    def make_data(k):
        kp, km = jax.random.split(k)
        params = jax.random.uniform(kp, (n, npar), jnp.float32)
        mets = params @ mix + 0.3 * jax.random.normal(
            km, (n, nmet), jnp.float32)
        return params, mets

    params, mets = make_data(key)
    sync((params, mets))
    if args.sim and args.phases:
        print(json.dumps({
            "metric": "note", "value":
            "--sim is ignored with --phases (the two-phase sequence "
            "measures the precomputed-metrics path)"}), flush=True)
        args.sim = False
    if args.sim:
        # only the sim-included run consumes seeds; don't let a dead [N]
        # buffer occupy device memory in the modes that exist because it is
        # tight
        seeds = jax.jit(
            lambda k: jax.random.randint(k, (n,), 0, 2**31 - 1, jnp.uint32)
        )(jax.random.fold_in(key, 7))
    state = (
        jnp.asarray(rng.uniform(0.3, 0.7, (keep, npar)), jnp.float32),
        jnp.full((keep,), 1.0 / keep, jnp.float32),
        jnp.full((npar,), 0.02, jnp.float32),
    )

    gen = ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_linear_gaussian_simulator(npar, nmet), np.zeros(nmet),
        mesh=particle_mesh(),
        row_block=args.row_block, max_pls_components=args.max_comp,
    )
    tag = (f"N={n} keep={keep} row_block={args.row_block}"
           f" max_comp={args.max_comp}, {ndev} x {dev.device_kind}")

    if args.phases:
        t_rank, res = timeit(
            lambda kk: gen.step_precomputed(kk, params, mets, keep, 0, state),
            key, reps=args.reps,
        )
        ncomp = int(np.asarray(jax.device_get(res.ncomp_used)))
        surv = (res.survivor_params, res.weights, res.doubled_variance)
        sync(surv)
        # free the population buffers before proposing, exactly as the
        # engine does once the generation is mirrored to the store
        del params, mets, res
        t_prop, _ = timeit(
            lambda kk: gen.propose(kk, *surv, n), key, reps=args.reps,
        )
        t = t_rank + t_prop
        print(json.dumps({
            "metric": f"SMC generation steady state, two-phase "
            f"(rank+weight then propose; buffers freed between), {tag}",
            "value": round(t, 3), "unit": "s",
            "rank_s": round(t_rank, 3), "propose_s": round(t_prop, 3),
            "particles_per_sec": round(n / t), "ncomp_used": ncomp,
        }), flush=True)
        return

    t, res = timeit(
        lambda kk: gen.step_precomputed(kk, params, mets, keep, n, state),
        key, reps=args.reps,
    )
    ncomp = int(np.asarray(jax.device_get(res.ncomp_used)))
    print(json.dumps({
        "metric": f"SMC generation steady state (sim excluded), {tag}",
        "value": round(t, 3), "unit": "s",
        "particles_per_sec": round(n / t), "ncomp_used": ncomp,
    }), flush=True)

    if args.sim:
        t, _ = timeit(lambda kk: gen.step(kk, params, seeds, keep, n, state),
                      key, reps=args.reps)
        print(json.dumps({
            "metric": f"SMC generation steady state (sim included), {tag}",
            "value": round(t, 3), "unit": "s",
            "particles_per_sec": round(n / t), "ncomp_used": ncomp,
        }), flush=True)


if __name__ == "__main__":
    main()
