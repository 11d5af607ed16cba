"""End-to-end SMC runs: the dice game (the reference's canonical example,
examples/README.md:27-34) with its analytic inverse as the statistical oracle,
plus storage / lifecycle parity checks."""

import os
import json
import sqlite3

import numpy as np
import pytest

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.models.simulators import make_dice_simulator, make_gaussian_simulator
from abcsmc_tpu.storage import MemoryStorage, SQLiteStorage


def dice_config(**overrides):
    cfg = {
        "smc_iterations": 4,
        "num_samples": 400,
        "predictive_prior_fraction": 0.1,
        "pls_training_fraction": 0.5,
        "noise": "INDEPENDENT",
        "parameters": [
            {"name": "number of dice", "short_name": "ndice",
             "dist_type": "UNIFORM", "num_type": "INT", "par1": 1, "par2": 100},
            {"name": "number of sides", "short_name": "sides",
             "dist_type": "UNIFORM", "num_type": "INT", "par1": 1, "par2": 100},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    cfg.update(overrides)
    return cfg


def analytic_dice_inverse(mu, sigma):
    # examples/README.md:27-34
    m = np.sqrt(12 * sigma**2 + 1)
    n = 2 * mu / (m + 1)
    return n, m


def test_dice_fitting_converges_memory_store():
    abc = AbcSmc(
        dice_config(), simulator=make_dice_simulator(max_dice=100),
        storage=MemoryStorage(),
    )
    abc.run(seed=7)
    pars, w = abc.posterior()
    n_true, m_true = analytic_dice_inverse(44, 2.39925)  # ~ (9.4, 8.4)
    w_norm = w / w.sum()
    mean_n = float((pars[:, 0] * w_norm).sum())
    mean_m = float((pars[:, 1] * w_norm).sum())
    # generous: 4 generations from U(1,100) priors should land in the vicinity
    assert abs(mean_n - n_true) < 6.0, (mean_n, n_true)
    assert abs(mean_m - m_true) < 6.0, (mean_m, m_true)
    # posterior concentrates vs prior (prior sd ~ 28.6)
    assert pars[:, 0].std() < 12.0
    assert pars[:, 1].std() < 12.0


def test_dice_fitting_multivariate_noise():
    abc = AbcSmc(
        dice_config(noise="MULTIVARIATE", smc_iterations=3),
        simulator=make_dice_simulator(max_dice=100),
        storage=MemoryStorage(),
    )
    abc.run(seed=3)
    pars, _ = abc.posterior()
    assert np.all(pars >= 1) and np.all(pars <= 100)
    assert np.all(pars == np.round(pars))  # INT recast preserved through MVN


def test_simple_filter_mode():
    abc = AbcSmc(
        dice_config(filter="SIMPLE", smc_iterations=2),
        simulator=make_dice_simulator(max_dice=100),
        storage=MemoryStorage(),
    )
    abc.run(seed=5)
    pars, _ = abc.posterior()
    assert pars.shape == (40, 2)


def test_gaussian_conjugate_posterior():
    """Gaussian toy with known ground truth (BASELINE.json configs[1]): metrics
    are sufficient statistics, so the ABC posterior should tighten around the
    generating parameters."""
    cfg = {
        "smc_iterations": 4,
        "num_samples": 500,
        "predictive_prior_fraction": 0.1,
        "noise": "INDEPENDENT",
        "parameters": [
            {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -10, "par2": 10},
            {"name": "sigma", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.1, "par2": 5},
        ],
        "metrics": [
            {"name": "mean", "num_type": "FLOAT", "value": 2.0},
            {"name": "sd", "num_type": "FLOAT", "value": 1.5},
        ],
    }
    abc = AbcSmc(
        cfg, simulator=make_gaussian_simulator(n_obs=100),
        storage=MemoryStorage(),
    )
    abc.run(seed=11)
    pars, w = abc.posterior()
    w = w / w.sum()
    mu_hat = float((pars[:, 0] * w).sum())
    sd_hat = float((pars[:, 1] * w).sum())
    assert abs(mu_hat - 2.0) < 0.5
    assert abs(sd_hat - 1.5) < 0.5
    # posterior sd of mu should be near sigma/sqrt(n) scale (inflated by kernel)
    assert pars[:, 0].std() < 1.0


def test_sqlite_storage_reference_schema(tmp_path):
    db = str(tmp_path / "dice.sqlite")
    cfg = dice_config(smc_iterations=2, num_samples=120,
                      database_filename=db)
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=100))
    abc.run(seed=1)

    conn = sqlite3.connect(db)
    tables = {
        r[0] for r in conn.execute(
            "select name from sqlite_master where type='table'"
        )
    }
    assert {"job", "par", "met"} <= tables
    # reference job schema columns (src/AbcSmc.cpp:819)
    cols = [r[1] for r in conn.execute("pragma table_info(job)")]
    assert cols == [
        "serial", "smcSet", "particleIdx", "startTime", "duration",
        "status", "posterior", "attempts",
    ]
    # all jobs done, two sets of 120
    rows = conn.execute(
        "select smcSet, count(*), sum(status = 'D') from job group by smcSet"
    ).fetchall()
    assert rows == [(0, 120, 120), (1, 120, 120)]
    # posterior ranks assigned: 12 per set (fraction 0.1)
    nposts = conn.execute(
        "select count(*) from job where posterior > -1"
    ).fetchone()[0]
    assert nposts == 24
    # par table: serial, seed blob, named columns
    cols = [r[1] for r in conn.execute("pragma table_info(par)")]
    assert cols == ["serial", "seed", "ndice", "sides"]
    # attempts incremented exactly once per job
    assert conn.execute(
        "select min(attempts), max(attempts) from job"
    ).fetchone() == (1, 1)
    conn.close()


def test_resume_from_sqlite(tmp_path):
    """The DB is the checkpoint: a brand-new engine instance picks up where the
    old one stopped (SURVEY 5.4 / src/AbcSmc.cpp:452-479)."""
    db = str(tmp_path / "resume.sqlite")
    cfg = dice_config(smc_iterations=2, num_samples=100, database_filename=db)
    sim = make_dice_simulator(max_dice=100)

    abc1 = AbcSmc(cfg, simulator=sim)
    abc1.process_database(seed=1)       # builds gen 0
    abc1.simulate_next_particles(n=40)  # partial simulation
    abc1.storage.close()

    abc2 = AbcSmc(cfg, simulator=sim)
    # not complete -> process returns False (reference returns false & reports)
    assert abc2.process_database(seed=2) is False
    abc2.simulate_next_particles(n=-1)  # finish the rest
    assert abc2.process_database(seed=3) is True  # ranks + proposes gen 1
    abc2.simulate_next_particles(n=-1)
    abc2.process_database(seed=4)
    pars, _ = abc2.posterior()
    assert pars.shape[0] == 10


def test_at_least_once_reclaim(tmp_path):
    """'R' jobs are re-claimable, ordered after 'Q' by attempts
    (src/AbcSmc.cpp:983-991); writeback is idempotent via the status guard."""
    db = str(tmp_path / "claims.sqlite")
    cfg = dice_config(smc_iterations=1, num_samples=10, database_filename=db)
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=100))
    abc.build_database(seed=0)
    store = abc.storage

    # worker A claims 4 jobs and dies (no writeback)
    a = store.claim_jobs(4)
    assert list(a.serials) == [0, 1, 2, 3]
    # worker B claims 8: first the 6 queued, then 2 stuck 'R' jobs
    b = store.claim_jobs(8)
    assert list(b.serials)[:6] == [4, 5, 6, 7, 8, 9]
    assert set(b.serials[6:]) <= {0, 1, 2, 3}

    # B writes back everything it claimed
    mets = np.ones((8, 2))
    n1 = store.write_results(
        b.serials, mets, np.zeros(8), np.zeros(8)
    )
    assert n1 == 8
    # A's late writeback only lands on rows still R (first-write-wins on others)
    n2 = store.write_results(
        a.serials, np.full((4, 2), 9.0), np.zeros(4), np.zeros(4)
    )
    assert n2 == 2  # the two not already completed by B

    conn = sqlite3.connect(db)
    assert conn.execute(
        "select count(*) from job where status = 'D'"
    ).fetchone()[0] == 10
    conn.close()


def test_engine_accepts_reference_config_file():
    abc = AbcSmc(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "reference_quickstart.json"),
        simulator=make_dice_simulator(max_dice=1000),
        storage=MemoryStorage(),
    )
    assert abc.npar == 2 and abc.nmet == 2
    assert abc.config.smc_size_at(0) == 300


def test_concurrent_process_claims(tmp_path):
    """Two OS processes claiming from one database concurrently must not
    double-claim queued jobs (BEGIN EXCLUSIVE serialization parity with the
    reference's multi-worker deployment)."""
    import subprocess
    import sys as _sys

    db = str(tmp_path / "conc.sqlite")
    cfg = dice_config(smc_iterations=1, num_samples=60,
                      database_filename=db)
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=100))
    abc.build_database(seed=0)
    abc.storage.close()

    worker = (
        "import sys, json\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from abcsmc_tpu.storage import SQLiteStorage\n"
        f"st = SQLiteStorage({db!r})\n"
        "claimed = []\n"
        "for _ in range(10):\n"
        "    jobs = st.claim_jobs(3)\n"
        "    claimed.extend(int(s) for s in jobs.serials)\n"
        "print(json.dumps(claimed))\n"
    )
    procs = [
        subprocess.Popen([_sys.executable, "-c", worker],
                         stdout=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [json.loads(p.communicate()[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    # 60 queued jobs; 60 claims total: every job claimed at least once, and
    # any overlap only begins after the queue of 'Q' jobs is exhausted
    # (re-claims of 'R' jobs are legal at-least-once behavior)
    all_claims = outs[0] + outs[1]
    assert set(all_claims) == set(range(60))
    conn = sqlite3.connect(db)
    statuses = conn.execute(
        "select count(*) from job where status = 'R'"
    ).fetchone()[0]
    assert statuses == 60
    attempts = [r[0] for r in conn.execute("select attempts from job")]
    assert sum(attempts) == 60  # exactly 60 claims happened in total
    conn.close()


def test_memstore_unknown_serial_claim_is_empty():
    abc = AbcSmc(dice_config(smc_iterations=1, num_samples=10),
                 simulator=make_dice_simulator(max_dice=100),
                 storage=MemoryStorage())
    abc.build_database(seed=0)
    claimed = abc.storage.claim_jobs(1, serial_req=999)
    assert claimed.serials.size == 0


def test_legacy_view_names(tmp_path):
    """Old-schema view names (jobs/parameters/metrics) for the reference's
    historical R scripts."""
    from abcsmc_tpu.storage.sqlite_store import create_legacy_views

    db = str(tmp_path / "legacy.sqlite")
    abc = AbcSmc(dice_config(smc_iterations=1, num_samples=20,
                             database_filename=db),
                 simulator=make_dice_simulator(max_dice=100))
    abc.run(seed=1)
    create_legacy_views(db)
    conn = sqlite3.connect(db)
    assert conn.execute("select count(*) from jobs").fetchone()[0] == 20
    assert conn.execute(
        "select count(*) from parameters where ndice is not null"
    ).fetchone()[0] == 20
    assert conn.execute(
        "select count(*) from metrics where sum is not null"
    ).fetchone()[0] == 20
    conn.close()


def test_read_runnable_matches_claims():
    """Storage.read_runnable: the read-only claim view (multi-process
    lockstep simulate) returns exactly the Q/R rows, serial-ordered, on
    both stores - and drains to empty once results land."""
    import numpy as np

    from abcsmc_tpu.storage import MemoryStorage, SQLiteStorage

    def drive(store):
        store.create(["a", "b"], ["m"], False)
        params = np.arange(12, dtype=np.float64).reshape(6, 2)
        serials = store.insert_generation(0, params, np.arange(6))
        view = store.read_runnable()
        np.testing.assert_array_equal(view.serials, serials)
        np.testing.assert_array_equal(view.params, params)
        # claim 4 (Q->R); runnable view unchanged (Q or R both runnable)
        claimed = store.claim_jobs(4)
        view2 = store.read_runnable()
        np.testing.assert_array_equal(view2.serials, serials)
        # finish the claimed 4: runnable drops to the 2 still-Q rows
        store.write_results(
            claimed.serials, np.ones((4, 1)), np.zeros(4), np.zeros(4)
        )
        view3 = store.read_runnable()
        left = sorted(set(map(int, serials)) - set(map(int, claimed.serials)))
        np.testing.assert_array_equal(view3.serials, left)

    drive(MemoryStorage())
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        st = SQLiteStorage(f"{td}/r.sqlite")
        drive(st)
        st.close()
