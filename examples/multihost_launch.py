"""Multi-host (multi-process) fitting against one shared database.

The reference's deployment model is many OS processes sharing one durable
SQLite store (/root/reference/src/AbcSmc.cpp:877-965; SLURM/Torque arrays in
examples/scratch/). Here: one jax.distributed session whose
processes each hold some of the mesh's cards, all calling ``run_device``
against the SAME database file (shared filesystem). The engine is
single-writer by construction - process 0 mirrors generations into the
store, everyone else computes the identical replicated result and writes
nothing - so the database comes out exactly as a single-process run's
(tests/test_multihost.py pins byte-level equality).

Run once per host (e.g. one SLURM task per host):

    python examples/multihost_launch.py CONFIG.json \
        --coordinator host0:1234 --num-processes 4 --process-id $SLURM_PROCID \
        --local-device-ids 0

Single-host multi-process also works (as the test suite does) with
--coordinator localhost:PORT; give each process its own card there
(``--local-device-ids $RANK``), since a JAX process reserves most of every
card it opens. The config's ``database_filename`` must resolve to the same
file on every host.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-device-ids", type=int, nargs="+", default=None,
                    help="this process's cards on its host (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # wire the hosts BEFORE any device query (replaces the reference's
    # MPI_Init); jax.devices() then spans every process's cards
    from abcsmc_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=args.local_device_ids,
    )

    from abcsmc_tpu import AbcSmc

    abc = AbcSmc(args.config)
    abc.run_device(seed=args.seed)

    import jax

    if jax.process_index() == 0:
        for name, s in abc.posterior_summary().items():
            print(f"{name}: mean={s['mean']:.6g} sd={s['sd']:.6g}")


if __name__ == "__main__":
    main()
