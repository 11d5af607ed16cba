"""Durable-store scaling probe: ONE engine-level run_device at device-scale N
with SQLite mirroring ON (the default), on the virtual CPU mesh.

The DB *is* the checkpoint in the reference's design
(src/AbcSmc.cpp:452-479), so the mirror must survive the
population sizes the device path unlocks. This measures the full bill - engine
wall-clock split (dispatch vs mirror), peak host RSS, database size - for a
fresh 1-set run at N particles (2 params x 2 metrics, linear-Gaussian device
simulator). Results recorded in docs/SCALING.md 'The durable-store bill'.

    python tools/mirror_scale.py --n 10000000 --keep 50000 [--db PATH]
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--keep", type=int, default=50_000)
    ap.add_argument("--db", default="")
    args = ap.parse_args()

    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator

    td = None
    db = args.db
    if not db:
        td = tempfile.mkdtemp(prefix="mirror_scale_")
        db = os.path.join(td, "scale.sqlite")

    cfg = {
        "smc_iterations": 1,
        "num_samples": args.n,
        "predictive_prior_size": args.keep,
        "database_filename": db,
        "parameters": [
            {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -2.0, "par2": 2.0},
            {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -2.0, "par2": 2.0},
        ],
        "metrics": [
            {"name": "m1", "num_type": "FLOAT", "value": 0.5},
            {"name": "m2", "num_type": "FLOAT", "value": -0.2},
        ],
    }
    abc = AbcSmc(cfg, simulator=make_linear_gaussian_simulator(2, 2))
    t0 = time.perf_counter()
    abc.run_device(seed=42)
    wall = time.perf_counter() - t0
    phases = [t for t in abc.timings if t["op"] == "run_device_phases"][-1]
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    import sqlite3

    conn = sqlite3.connect(db)
    rows = conn.execute(
        "select count(*), sum(status = 'D'), sum(posterior > -1) from job"
    ).fetchone()
    conn.close()
    assert rows == (args.n, args.n, args.keep), rows
    out = {
        "n": args.n,
        "keep": args.keep,
        "wall_s": round(wall, 2),
        "dispatch_s": phases["dispatch_s"],
        "mirror_s": phases["mirror_s"],
        "peak_rss_gb": round(rss_gb, 2),
        "db_gb": round(os.path.getsize(db) / 2**30, 3),
        "rows_ok": True,
    }
    print(json.dumps(out))
    if td:
        import shutil

        shutil.rmtree(td, ignore_errors=True)


if __name__ == "__main__":
    main()
