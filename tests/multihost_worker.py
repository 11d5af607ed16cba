"""Worker script for the multi-host tests: run as N processes, each with
4 virtual CPU devices (8 when N == 1), forming one global mesh via
jax.distributed - the DCN-across-hosts topology of SURVEY 5.8, minus the
network.

    python tests/multihost_worker.py <process_id> <num_processes> <port> \
        [mode] [db_path] [seed]

Modes:
    raw            (default) two sharded SMC generation steps; reports the
                   replicated survivor summary so the parent can check all
                   processes agree (argv[5], optional: sidecar result-file
                   base path; without it the result is stdout-only).
    engine         AbcSmc.run_device end-to-end against ONE shared SQLite
                   store (fresh run): the reference's deployment model -
                   one durable database, many processes
                   (/root/reference/src/AbcSmc.cpp:877-965) - with the
                   engine's replicated writes gated to process 0.
    engine_resume  run_device resuming whatever state the parent left in
                   the shared store (mid-set or boundary).
    engine_chain   varying-size schedule ([64, 96, 96, 96]) -> the
                   bucketed run_chain fast path with the multi-process
                   stacked-leaf mirror fetch.
    engine_proj    projection sweep (PSEUDO grid) on the shared store.
    engine_fail    failure propagation: a StorageError injected into the
                   writer's mirror must abort EVERY process promptly
                   (engine._writer_guard), never hang the peers.
    engine_tol     NRMSE-tolerance run on the varying-size chain: the fused
                   dispatch computes every set, every process computes the
                   SAME convergence cut from the replicated survivor-metric
                   leaves, and the straddling scan bucket's stacked leaves
                   are sliced on device before the multi-process mirror
                   fetch - the shared store must hold exactly the converged
                   prefix (engine.run_device cut logic).
    engine_tol_scan  the same convergence-cut contract on the UNIFORM-size
                   run_scan fast path: the cut slices the stacked [G, ...]
                   history leaves on device before the multi-process fetch.
    engine_bridge  HostBridgeSimulator (io_callback black-box host
                   simulator) inside the fused device program on the
                   multi-process mesh: each process's callback fires for
                   its ADDRESSABLE shard only, so every particle's
                   simulator must run EXACTLY ONCE fleet-wide - proven by
                   a per-process append-only journal the parent audits
                   against the store (docs/MIGRATION.md "Host-bridged
                   simulators", multi-process contract).

Any other mode string is an error (exit 2), never a silent fallback.
"""

import os
import sys

import jax

proc_id = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = sys.argv[3]
mode = sys.argv[4] if len(sys.argv) > 4 else "raw"

jax.config.update("jax_platforms", "cpu")
# keep the GLOBAL device count at 8 regardless of the process layout, so a
# 1-process and a 2-process run compile the identical SPMD program
jax.config.update("jax_num_cpu_devices", 8 // nprocs)

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nprocs,
    process_id=proc_id,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from abcsmc_tpu.config import parse_config  # noqa: E402
from abcsmc_tpu.models.parameters import ParameterSet  # noqa: E402
from abcsmc_tpu.models.simulators import make_dice_simulator  # noqa: E402
from abcsmc_tpu.models.transforms import ParameterTransform  # noqa: E402
from abcsmc_tpu.parallel.generation import ShardedGeneration  # noqa: E402
from abcsmc_tpu.parallel.mesh import particle_mesh  # noqa: E402

assert len(jax.devices()) == 8, jax.devices()
assert len(jax.local_devices()) == 8 // nprocs

CFG = {
    "smc_iterations": 3,
    "num_samples": 96,
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


def run_raw(result_base=None):
    cfg = parse_config(dict(CFG, smc_iterations=2, num_samples=64))
    gen = ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_dice_simulator(max_dice=50),
        np.array([44.0, 2.39925]),
        mesh=particle_mesh(),  # global mesh across all processes
    )
    key = jax.random.PRNGKey(7)
    key, k0, k1, k2 = jax.random.split(key, 4)
    params, seeds = gen.init_population(k0, 64)
    r0 = gen.step(k1, params, seeds, 16, 64, None)
    state = (r0.survivor_params, r0.weights, r0.doubled_variance)
    r1 = gen.step(k2, r0.next_params, r0.next_seeds, 16, 64, state)

    # replicated outputs: every process can read them fully
    w = np.asarray(jax.device_get(r1.weights))
    surv = np.asarray(jax.device_get(r1.survivor_params))
    assert w.shape == (16,) and np.all(np.isfinite(w))

    # the chunked row-psum fetch (parallel/mesh.py::fetch_rows_global, the
    # HBM-safe multi-process mirror path) reassembles the exact sharded
    # population on THIS multi-process mesh, partial final window included
    from abcsmc_tpu.parallel.mesh import (
        fetch_rows_global,
        replicate_ident,
    )

    mesh = gen.mesh
    full = np.asarray(jax.device_get(replicate_ident(mesh)(r1.next_params)))
    np.testing.assert_array_equal(
        fetch_rows_global(r1.next_params, mesh, chunk_rows=24), full
    )
    np.testing.assert_array_equal(
        fetch_rows_global(r1.next_seeds, mesh, chunk_rows=24),
        np.asarray(jax.device_get(replicate_ident(mesh)(r1.next_seeds))),
    )
    _emit_result(
        result_base, np.round(float(surv.mean()), 6),
        np.round(float(np.linalg.norm(w)), 6),
    )


def run_engine(db_path: str, seed: int, chain: bool = False,
               tolerance: float | None = None,
               expect_sets: int | None = None):
    from abcsmc_tpu.engine import AbcSmc

    cfg = dict(CFG, database_filename=db_path)
    if chain:
        # varying sizes -> the bucketed run_chain fast path (singles + a
        # 2-set scanned bucket), exercising the multi-process stacked-leaf
        # mirror fetch (engine.run_device chain_hist branch)
        cfg.update(num_samples=[64, 96, 96, 96], smc_iterations=4)
    if tolerance is not None:
        cfg["nrmse_tolerance"] = tolerance
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50))
    abc.run_device(seed=seed)
    gens = abc.storage.read_generations()
    if expect_sets is not None:
        # a tolerance run: the convergence cut must have truncated the
        # fused run at exactly this many sets (strictly fewer than the
        # schedule) - the (seed, tolerance) pair in the test is pinned to
        # make the cut deterministic, so a pass genuinely exercised the
        # mid-run truncation the mode exists for
        n_sets = expect_sets
    else:
        n_sets = 4 if chain else 3
    assert len(gens) == n_sets and all(g.complete for g in gens), [
        (g.set_num, g.size, g.complete) for g in gens
    ]
    # posterior surfaces agree on every process (replicated device math)
    pars, w = abc.posterior()
    abc.storage.close()
    _emit_result(
        db_path, np.round(float(np.asarray(pars).mean()), 6),
        np.round(float(np.linalg.norm(np.asarray(w))), 6),
    )


def run_engine_projection(db_path: str, seed: int):
    """Projection sweep (PSEUDO grid) on the multi-process mesh: the brain
    runs on process 0, every process participates in the lockstep SPMD
    simulate (claim by the writer, Storage.read_runnable elsewhere)."""
    from abcsmc_tpu.engine import AbcSmc

    cfg = {
        "database_filename": db_path,
        "parameters": [
            {"name": "ndice", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 1, "par2": 12},
            {"name": "sides", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 2, "par2": 9},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=12))
    abc.run_device(seed=seed)
    gens = abc.storage.read_generations()
    assert len(gens) == 1 and gens[0].complete, gens
    assert gens[0].size == 12 * 8  # full factorial grid
    mets = np.asarray(gens[0].metrics)
    abc.storage.close()
    _emit_result(
        db_path, np.round(float(mets.mean()), 6),
        np.round(float(mets.std()), 6),
    )


def run_engine_fail(db_path: str, seed: int):
    """Failure propagation (engine._writer_guard): a store error injected
    into the WRITER's mirror must abort every process promptly - the writer
    with the injected StorageError, the peers with the coded 'peer process
    failed' AbcError - instead of stranding the peers in the final barrier
    until the distributed runtime's timeout."""
    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.errors import AbcError, StorageError

    cfg = dict(CFG, database_filename=db_path)
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50))
    if jax.process_index() == 0:
        orig = abc.storage.insert_generation_complete
        calls = {"n": 0}

        def boom(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:  # second set's mirror: mid-run, post-create
                raise StorageError("injected mirror failure", code=99)
            return orig(*a, **k)

        abc.storage.insert_generation_complete = boom
    try:
        abc.run_device(seed=seed)
    except StorageError as e:
        assert proc_id == 0 and "injected mirror failure" in str(e), e
        _emit_result(db_path, "writer-raised", 99)
        return
    except AbcError as e:
        assert proc_id != 0 and "peer process failed" in str(e), e
        _emit_result(db_path, "peer-raised", 99)
        return
    sys.exit("run_device should have raised on every process")


def run_engine_bridge(db_path: str, seed: int):
    """run_device with a HostBridgeSimulator: the black-box host function
    journals every row it simulates (params + seed) into THIS process's
    append-only sidecar, and computes metrics deterministically from the
    per-particle seed - so the parent can assert (a) exactly-once fleet-wide
    execution by auditing journals against the store and (b) bit-equal
    databases across process layouts."""
    import numpy as _np

    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import HostBridgeSimulator

    journal = f"{db_path}.journal.{proc_id}"

    def dice_host(params, seeds):
        params = _np.asarray(params)
        seeds = _np.asarray(seeds).astype(_np.uint64)
        out = _np.empty((len(params), 2), params.dtype)
        with open(journal, "a") as fh:
            for i in range(len(params)):
                nd, sd = int(round(float(params[i, 0]))), int(
                    round(float(params[i, 1]))
                )
                rng = _np.random.default_rng(int(seeds[i]))
                rolls = rng.integers(1, sd + 1, size=nd)
                out[i, 0] = rolls.sum()
                out[i, 1] = rolls.std(ddof=0) if nd > 1 else 0.0
                fh.write(f"{nd} {sd} {int(seeds[i])}\n")
        return out

    cfg = dict(CFG, database_filename=db_path)
    abc = AbcSmc(cfg, simulator=HostBridgeSimulator(dice_host, nmet=2))
    abc.run_device(seed=seed)
    gens = abc.storage.read_generations()
    assert len(gens) == 3 and all(g.complete for g in gens), [
        (g.set_num, g.size, g.complete) for g in gens
    ]
    pars, w = abc.posterior()
    abc.storage.close()
    _emit_result(
        db_path, np.round(float(np.asarray(pars).mean()), 6),
        np.round(float(np.linalg.norm(np.asarray(w))), 6),
    )


def _emit_result(db_path, a, b):
    """Report (a, b) for this process. Written to a sidecar file when a
    db path exists (gloo writes straight to fd 1, which can interleave
    with - and corrupt - a stdout line mid-write; observed in round 4),
    and echoed to stdout for debugging."""
    if db_path is not None:
        with open(f"{db_path}.result.{proc_id}", "w") as fh:
            fh.write(f"{a} {b}\n")
    print(f"\nRESULT {proc_id} {a} {b}", flush=True)


if mode == "raw":
    run_raw(sys.argv[5] if len(sys.argv) > 5 else None)
elif mode == "engine_proj":
    run_engine_projection(sys.argv[5], int(sys.argv[6]))
elif mode == "engine_fail":
    run_engine_fail(sys.argv[5], int(sys.argv[6]))
elif mode == "engine_bridge":
    run_engine_bridge(sys.argv[5], int(sys.argv[6]))
elif mode == "engine_chain":
    run_engine(sys.argv[5], int(sys.argv[6]), chain=True)
elif mode == "engine_tol":
    run_engine(sys.argv[5], int(sys.argv[6]), chain=True,
               tolerance=float(sys.argv[7]), expect_sets=3)
elif mode == "engine_tol_scan":
    # uniform sizes -> the run_scan fast path: the cut slices the stacked
    # [G, ...] history leaves on device before the multi-process fetch
    run_engine(sys.argv[5], int(sys.argv[6]),
               tolerance=float(sys.argv[7]), expect_sets=2)
elif mode in ("engine", "engine_resume"):
    run_engine(sys.argv[5], int(sys.argv[6]))
else:
    # never fall through silently: a typo'd mode must not green-light a
    # scenario that ran the wrong code path
    sys.exit(f"unknown multihost_worker mode {mode!r}")
