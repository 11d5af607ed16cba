"""The reference quick-start, end-to-end via the chain path.

Runs the reference's documented quick-start (30 SMC sets, sizes
[300, 500, 500, 750, 1000] then 1000, predictive_prior_fraction 0.5,
MULTIVARIATE noise, the dice game with U(1,1000) priors) through
``AbcSmc.run_device`` and records the compiled-program count (one per size
TRANSITION, not per set - 7 vs 31), the wall-clock split, and the
posterior, comparable between the GPU (f32) and the CPU (f64) run.

    python tools/quickstart_chip.py --platform gpu|cpu [--db PATH]

One JSON line per run, naming the device.
"""

import argparse
import json
import os
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--platform", choices=["gpu", "cpu"], default="cpu")
ap.add_argument("--db", default="")
args = ap.parse_args()

import jax  # noqa: E402

if args.platform == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if args.platform == "gpu":
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"--platform gpu: JAX found {jax.devices()[0].platform!r}")
    from abcsmc_tpu._cache import enable_persistent_cache

    enable_persistent_cache()


def main():
    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import make_dice_simulator
    from abcsmc_tpu.storage import MemoryStorage

    cfg = {
        "smc_iterations": 30,
        "num_samples": [300, 500, 500, 750, 1000],
        "predictive_prior_fraction": 0.5,
        "pls_training_fraction": 0.5,
        "noise": "MULTIVARIATE",
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 1000},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 1000},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    storage = None if args.db else MemoryStorage()
    if args.db:
        cfg["database_filename"] = args.db
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=1000),
                 storage=storage)
    t0 = time.perf_counter()
    abc.run_device(seed=2026)
    wall = time.perf_counter() - t0
    phases = [t for t in abc.timings if t["op"] == "run_device_phases"][-1]
    summ = abc.posterior_summary()
    out = {
        "platform": args.platform,
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "sets": phases["sets"],
        "programs": phases["programs"],
        "wall_s": round(wall, 2),
        "dispatch_s": phases["dispatch_s"],
        "mirror_s": phases["mirror_s"],
        "ess": round(abc.ess(), 2),
        "posterior": {
            p: {"mean": round(v["mean"], 4), "sd": round(v["sd"], 4)}
            for p, v in summ.items()
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
