"""Multi-host (multi-process) SMC: two OS processes with 4 CPU devices each
form one 8-device mesh via jax.distributed - the DCN-across-hosts topology of
SURVEY 5.8, minus the network.

Covers the raw sharded step (all processes compute identical replicated
survivors) AND the full engine against one shared SQLite store: the
reference's deployment model is many OS processes sharing one durable
database (/root/reference/src/AbcSmc.cpp:877-965); here the 2-process
engine run must produce the same store, row for row, as a 1-process run
of the identical 8-device program (timestamps excluded - the only
non-deterministic columns)."""

import os
import socket
import sqlite3
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nprocs: int, extra_args=()):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "tests/multihost_worker.py", str(i),
             str(nprocs), str(port), *map(str, extra_args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        )
        for i in range(nprocs)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=500)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    results = {}
    # every mode reports via sidecar result files (gloo's raw fd-1 writes
    # can interleave with - and corrupt - a stdout line mid-write), keyed
    # by the base path at extra_args[1]
    assert extra_args, "pass a mode + result/db base path"
    db = str(extra_args[1])
    for i in range(nprocs):
        with open(f"{db}.result.{i}") as fh:
            a, b = fh.read().split()
        results[str(i)] = (a, b)
    assert set(results) == {str(i) for i in range(nprocs)}, (results, outs)
    return results


def _dump_db(path):
    """Full deterministic content of a run store: every column except the
    wall-clock ones (startTime, duration)."""
    conn = sqlite3.connect(path)
    job = conn.execute(
        "select serial, smcSet, particleIdx, status, posterior, attempts "
        "from job order by serial"
    ).fetchall()
    par = conn.execute("select * from par order by serial").fetchall()
    met = conn.execute("select * from met order by serial").fetchall()
    conn.close()
    return job, par, met


def test_two_process_mesh_generation(tmp_path):
    results = _run_workers(2, ["raw", str(tmp_path / "raw")])
    # both processes computed the same replicated survivors/weights
    assert results["0"] == results["1"], results


def test_two_process_engine_matches_single_process(tmp_path):
    """AbcSmc.run_device end-to-end on a 2-process x 4-device mesh against
    ONE shared SQLite store == the 1-process 8-device run: same rows, same
    ranks, same seeds, same metrics - one row per particle (no write
    races)."""
    db2 = str(tmp_path / "two_proc.sqlite")
    db1 = str(tmp_path / "one_proc.sqlite")
    r2 = _run_workers(2, ["engine", db2, 11])
    r1 = _run_workers(1, ["engine", db1, 11])
    # posterior surfaces replicated across processes and layouts
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)


def test_two_process_chain_engine_matches_single_process(tmp_path):
    """Varying-size schedules take the bucketed run_chain fast path; on a
    multi-process mesh the mirror fetches each scanned bucket's STACKED
    leaves through the chunked row-psum path (axis 1) and slices per set
    on the host - the store must still come out byte-identical to the
    1-process run."""
    db2 = str(tmp_path / "chain_two.sqlite")
    db1 = str(tmp_path / "chain_one.sqlite")
    r2 = _run_workers(2, ["engine_chain", db2, 23])
    r1 = _run_workers(1, ["engine_chain", db1, 23])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)


def test_four_process_engine_matches_single_process(tmp_path):
    """The same engine contract at a 4-process x 2-device layout: four
    jax.distributed processes against ONE shared store must
    produce the byte-identical database as the 1-process 8-device run -
    writer gating, barriers, and failure scopes hold at fan-outs beyond the
    2-process case every prior round exercised."""
    db4 = str(tmp_path / "four_proc.sqlite")
    db1 = str(tmp_path / "one_proc.sqlite")
    r4 = _run_workers(4, ["engine", db4, 11])
    r1 = _run_workers(1, ["engine", db1, 11])
    assert r4["0"] == r4["1"] == r4["2"] == r4["3"] == r1["0"], (r4, r1)
    assert _dump_db(db4) == _dump_db(db1)


def test_two_process_engine_resume_matches_single_process(tmp_path):
    """Mid-set resume on a multi-process mesh: a half-simulated store (the
    reference's crash-anywhere restart contract, src/AbcSmc.cpp:452-479)
    resumed by a 2-process engine produces the same database as a 1-process
    resume of an identical copy."""
    import shutil

    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import make_dice_simulator

    # must match multihost_worker.CFG (the worker is a standalone script -
    # importing it would run jax.distributed.initialize)
    db2 = str(tmp_path / "resume_two.sqlite")
    cfg = {
        "smc_iterations": 3,
        "num_samples": 96,
        "predictive_prior_fraction": 0.25,
        "database_filename": db2,
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
    abc.build_database(seed=5)
    abc.simulate_next_particles(n=48)  # half of set 0
    abc.storage.close()
    db1 = str(tmp_path / "resume_one.sqlite")
    shutil.copyfile(db2, db1)

    r2 = _run_workers(2, ["engine_resume", db2, 11])
    r1 = _run_workers(1, ["engine_resume", db1, 11])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    d2, d1 = _dump_db(db2), _dump_db(db1)
    assert d2 == d1
    # the pre-simulated half kept its host-f64 metrics (first-write-wins)
    conn = sqlite3.connect(db2)
    n_done = conn.execute(
        "select count(*) from job where smcSet = 0 and status = 'D'"
    ).fetchone()[0]
    conn.close()
    assert n_done == 96


def test_two_process_engine_boundary_resume_matches_single_process(tmp_path):
    """SET-BOUNDARY resume on a multi-process mesh: a store whose last set
    is complete but unranked (the crash window between a simulate pass and
    the next process pass) makes the STORE WRITER run the host brain
    (rank + weight + enqueue set 1) while the other process barriers and
    rebuilds identical state from the rank-stamped store - the round-4
    race fix: a non-writer running the brain concurrently could observe
    the writer's enqueue commit mid-pass and read a spuriously incomplete
    store (engine.py run_device boundary branch)."""
    import shutil

    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import make_dice_simulator

    db2 = str(tmp_path / "bres_two.sqlite")
    cfg = {
        "smc_iterations": 3,
        "num_samples": 96,
        "predictive_prior_fraction": 0.25,
        "database_filename": db2,
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
    abc.build_database(seed=5)
    abc.simulate_next_particles(n=-1)  # ALL of set 0: boundary, unranked
    abc.storage.close()
    db1 = str(tmp_path / "bres_one.sqlite")
    shutil.copyfile(db2, db1)

    r2 = _run_workers(2, ["engine_resume", db2, 11])
    r1 = _run_workers(1, ["engine_resume", db1, 11])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)


def test_two_process_projection_sweep_matches_single_process(tmp_path):
    """Projection mode on a multi-process mesh: process 0 runs the brain
    and claims; every process participates in the lockstep SPMD simulate
    via the read-only claim view (Storage.read_runnable); results match the
    1-process sweep row for row."""
    db2 = str(tmp_path / "proj_two.sqlite")
    db1 = str(tmp_path / "proj_one.sqlite")
    r2 = _run_workers(2, ["engine_proj", db2, 7])
    r1 = _run_workers(1, ["engine_proj", db1, 7])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)
    # one claim attempt per row on the shared store (writer-only claims)
    conn = sqlite3.connect(db2)
    att = conn.execute("select min(attempts), max(attempts) from job").fetchone()
    conn.close()
    assert att == (1, 1), att


def test_two_process_tolerance_cut_matches_single_process(tmp_path):
    """NRMSE-tolerance run on the fused multi-process chain: every process
    computes the SAME convergence cut from the replicated survivor-metric
    leaves (fetched BEFORE any O(N) population leaf), and the straddling
    scan bucket's stacked leaves are sliced on device before the mirror
    fetch. Seed 23's NRMSE trajectory (0.321, 0.218, 0.118, 0.030) with
    tolerance 0.15 cuts at set 2 - one set into the trailing 2-set scanned
    bucket - so the store must hold exactly 3 complete sets (the worker
    asserts the count), byte-identical across process layouts."""
    db2 = str(tmp_path / "tol_two.sqlite")
    db1 = str(tmp_path / "tol_one.sqlite")
    r2 = _run_workers(2, ["engine_tol", db2, 23, 0.15])
    r1 = _run_workers(1, ["engine_tol", db1, 23, 0.15])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)
    conn = sqlite3.connect(db2)
    sets = conn.execute(
        "select smcSet, count(*) from job group by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(0, 64), (1, 96), (2, 96)], sets


def test_two_process_tolerance_scan_cut_matches_single_process(tmp_path):
    """The same convergence-cut contract on the UNIFORM-size run_scan fast
    path: the stacked [G, ...] history leaves are sliced to the cut on
    device before the multi-process row-psum fetch. Seed 11's trajectory
    (0.350, 0.224, 0.088) with tolerance 0.3 cuts at set 1, so exactly 2 of
    the 3 scheduled sets land (the worker asserts the count)."""
    db2 = str(tmp_path / "tolscan_two.sqlite")
    db1 = str(tmp_path / "tolscan_one.sqlite")
    r2 = _run_workers(2, ["engine_tol_scan", db2, 11, 0.3])
    r1 = _run_workers(1, ["engine_tol_scan", db1, 11, 0.3])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)
    conn = sqlite3.connect(db2)
    sets = conn.execute(
        "select smcSet, count(*) from job group by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(0, 96), (1, 96)], sets


def test_two_process_host_bridge_exactly_once(tmp_path):
    """HostBridgeSimulator on a multi-process mesh:
    each process's io_callback fires for its ADDRESSABLE shard only, so a
    side-effecting black-box simulator runs EXACTLY ONCE per particle
    fleet-wide - audited via per-process append-only journals whose union
    must equal the store's rows (no duplicates, none missing), with both
    processes carrying a share of the work, and the database bit-equal to
    the 1-process run."""
    db2 = str(tmp_path / "bridge_two.sqlite")
    db1 = str(tmp_path / "bridge_one.sqlite")
    r2 = _run_workers(2, ["engine_bridge", db2, 19])
    r1 = _run_workers(1, ["engine_bridge", db1, 19])
    assert r2["0"] == r2["1"] == r1["0"], (r2, r1)
    assert _dump_db(db2) == _dump_db(db1)

    def journal_rows(db, nprocs):
        per_proc = []
        for i in range(nprocs):
            with open(f"{db}.journal.{i}") as fh:
                per_proc.append(
                    [tuple(map(int, ln.split())) for ln in fh if ln.strip()]
                )
        return per_proc

    j0, j1 = journal_rows(db2, 2)
    conn = sqlite3.connect(db2)
    store = conn.execute(
        "select cast(ndice as integer), cast(sides as integer), "
        "cast(seed as integer) from par"
    ).fetchall()
    conn.close()
    assert len(store) == 3 * 96
    # exactly once: journal union == store rows as multisets
    assert sorted(j0 + j1) == sorted(store)
    # the simulation work is actually sharded across processes
    assert 0 < len(j0) < 3 * 96 and 0 < len(j1) < 3 * 96


def test_two_process_writer_failure_aborts_peers_promptly(tmp_path):
    """A store error on the WRITER must fail the whole fleet fast
    (engine._writer_guard), not strand the non-writers in the final
    barrier until the distributed runtime's timeout: process 0 exits with
    the injected StorageError, process 1 with the coded 'peer process
    failed' AbcError - both within the normal worker budget."""
    import time

    db = str(tmp_path / "fail_two.sqlite")
    t0 = time.monotonic()
    results = _run_workers(2, ["engine_fail", db, 13])
    elapsed = time.monotonic() - t0
    assert results["0"] == ("writer-raised", "99"), results
    assert results["1"] == ("peer-raised", "99"), results
    # well under any collective timeout (gloo defaults to 30 min)
    assert elapsed < 400, elapsed
    # the injected failure hit the SECOND set's mirror: set 0 is durable,
    # set 1 is not - the poisoned run left no partially-written set 1 rows
    import sqlite3 as _sq

    conn = _sq.connect(db)
    sets = conn.execute(
        "select smcSet, count(*) from job group by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(0, 96)], sets
