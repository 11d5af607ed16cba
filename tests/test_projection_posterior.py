"""Projection mode (PSEUDO grids), POSTERIOR parameter sourcing from a previous
run's database, and untransform (upar) flows - reference parity for
src/AbcSmc.cpp:341-396 (slurp_posterior, retain_posterior_rank) and
:432-447/:863-867 (_to_model_space / upar table)."""

import sqlite3

import numpy as np
import pytest

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.models.simulators import PySimulator, make_dice_simulator
from abcsmc_tpu.storage import MemoryStorage


def echo_sim():
    """Simulator whose metrics are the (model-space) params it received."""
    return PySimulator(lambda pars, seed, serial: list(pars))


def test_projection_pseudo_sweep_enumerates_grid(tmp_path):
    db = str(tmp_path / "proj.sqlite")
    cfg = {
        "database_filename": db,
        "parameters": [
            {"name": "a", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 1, "par2": 3},
            {"name": "b", "dist_type": "PSEUDO", "num_type": "FLOAT",
             "vals": [0.5, 1.5]},
        ],
        "metrics": [
            {"name": "m1", "num_type": "FLOAT", "value": 0},
            {"name": "m2", "num_type": "FLOAT", "value": 0},
        ],
    }
    abc = AbcSmc(cfg, simulator=echo_sim())
    assert abc.config.projection_mode
    assert abc.config.smc_set_sizes == [6]

    abc.process_database(seed=0)       # builds the full factorial sweep
    abc.simulate_next_particles(n=-1)
    assert abc.process_database(seed=1) is True  # completes without filtering

    conn = sqlite3.connect(db)
    rows = conn.execute(
        "select p.a, p.b, m.m1, m.m2 from par p, met m "
        "where p.serial = m.serial order by p.serial"
    ).fetchall()
    conn.close()
    # odometer semantics: first parameter fastest (ParRNG.h:17-36)
    assert [(r[0], r[1]) for r in rows] == [
        (1.0, 0.5), (2.0, 0.5), (3.0, 0.5), (1.0, 1.5), (2.0, 1.5), (3.0, 1.5),
    ]
    # echo simulator: metrics == params
    for a, b, m1, m2 in rows:
        assert (m1, m2) == (a, b)


def fit_then_project(tmp_path, retain=True):
    """Fit dice, then drive a projection run whose POSTERIOR parameters source
    values from the fitted database (the reference's two-stage workflow,
    examples/README.md 'Use Cases')."""
    fit_db = str(tmp_path / "fit.sqlite")
    fit_cfg = {
        "smc_iterations": 2,
        "num_samples": 60,
        "predictive_prior_size": 8,
        "database_filename": fit_db,
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
    abc = AbcSmc(fit_cfg, simulator=make_dice_simulator(max_dice=50))
    abc.run(seed=4)
    abc.storage.close()

    proj_db = str(tmp_path / "proj.sqlite")
    proj_cfg = {
        "database_filename": proj_db,
        "posterior_database_filename": fit_db,
        "retain_posterior_rank": retain,
        "parameters": [
            {"name": "scenario", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 0, "par2": 2},
            {"name": "ndice", "dist_type": "POSTERIOR", "num_type": "INT",
             "par1": 0, "par2": 7},
            {"name": "sides", "dist_type": "POSTERIOR", "num_type": "INT",
             "par1": 0, "par2": 7},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 0},
            {"name": "sd", "num_type": "FLOAT", "value": 0},
            {"name": "scen", "num_type": "FLOAT", "value": 0},
        ],
    }
    sim = PySimulator(
        lambda pars, seed, serial: [pars[1] * 2, pars[2] * 3, pars[0]]
    )
    return AbcSmc(proj_cfg, simulator=sim), fit_db, proj_db


def test_posterior_parameters_source_from_fit_db(tmp_path):
    abc, fit_db, proj_db = fit_then_project(tmp_path)
    assert abc.config.projection_mode
    # 3 scenarios x 8 posterior rows
    assert abc.config.smc_set_sizes == [24]
    # parity quirk: slurp_posterior takes rows with posterior > -1 across ALL
    # sets in serial order (src/AbcSmc.cpp:302-334) - 2 sets x 8 survivors;
    # ranks 0..7 then index the first 8 rows
    assert abc._posterior_matrix.shape == (16, 2)

    abc.process_database(seed=0)
    abc.simulate_next_particles(n=-1)
    assert abc.process_database(seed=1) is True

    # posterior values must be actual rows of the fitted posterior
    conn = sqlite3.connect(fit_db)
    post_rows = {
        tuple(r) for r in conn.execute(
            "select p.ndice, p.sides from par p, job j "
            "where p.serial = j.serial and j.posterior > -1"
        )
    }
    conn.close()
    conn = sqlite3.connect(proj_db)
    rows = conn.execute(
        "select j.posterior, p.scenario, p.ndice, p.sides from par p, job j "
        "where p.serial = j.serial order by j.serial"
    ).fetchall()
    conn.close()
    assert len(rows) == 24
    for rank, scen, nd, sd in rows:
        assert (nd, sd) in post_rows
        assert rank > -1  # retained source rank
    # scenario odometer: fastest digit cycles 0,1,2
    assert [r[1] for r in rows[:6]] == [0, 1, 2, 0, 1, 2]
    # posterior index advances when pseudo rolls over: ranks constant in
    # blocks of 3
    ranks = [r[0] for r in rows]
    assert ranks[0] == ranks[1] == ranks[2]
    assert ranks[3] == ranks[4] == ranks[5]


def test_untransform_upar_table(tmp_path):
    db = str(tmp_path / "u.sqlite")
    cfg = {
        "smc_iterations": 3,
        "num_samples": 150,
        "predictive_prior_size": 15,
        "database_filename": db,
        "parameters": [
            {"name": "logx", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -2, "par2": 2, "untransform": "POW_10"},
            {"name": "p", "dist_type": "NORMAL", "num_type": "FLOAT",
             "par1": 0, "par2": 1,
             "untransform": {"type": "LOGISTIC", "min": 0.2, "max": 0.8}},
        ],
        "metrics": [
            {"name": "mx", "num_type": "FLOAT", "value": 10.0},
            {"name": "mp", "num_type": "FLOAT", "value": 0.5},
        ],
    }
    # simulator sees MODEL-space params (upar): echo them back
    abc = AbcSmc(cfg, simulator=echo_sim())
    abc.run(seed=2)

    conn = sqlite3.connect(db)
    tables = {r[0] for r in conn.execute(
        "select name from sqlite_master where type='table'")}
    assert "upar" in tables
    rows = conn.execute(
        "select p.logx, p.p, u.logx, u.p, m.mx, m.mp "
        "from par p, upar u, met m "
        "where p.serial = u.serial and p.serial = m.serial limit 20"
    ).fetchall()
    conn.close()
    # f64 on the CPU mesh (x64); the looser bound covers float32 transforms
    import jax

    rel = 1e-12 if jax.config.jax_enable_x64 else 2e-5
    for fx, fp, ux, up, mx, mp in rows:
        assert ux == pytest.approx(10**fx, rel=rel)
        expected_p = 0.6 / (1 + np.exp(-fp)) + 0.2
        assert up == pytest.approx(expected_p, rel=rel)
        # the simulator received model-space values
        assert mx == pytest.approx(ux, rel=max(rel, 1e-9))
        assert mp == pytest.approx(up, rel=max(rel, 1e-9))
    # fitting-space posterior concentrates toward logx ~ 1 (10**1 = 10)
    pars, _ = abc.posterior()
    assert abs(pars[:, 0].mean() - 1.0) < 0.6


def test_weights_with_indexed_pars_rejected():
    """Fitting mode mixing priors with PSEUDO aborts at the weight step in the
    reference (IndexedPars.h:20-28); we raise at the same point."""
    from abcsmc_tpu.errors import ConfigError
    cfg = {
        "smc_iterations": 3,
        "num_samples": 20,
        "predictive_prior_size": 5,
        "parameters": [
            {"name": "x", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0, "par2": 1},
            {"name": "g", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 0, "par2": 3},
        ],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.5}],
    }
    abc = AbcSmc(
        cfg, simulator=PySimulator(lambda p, s, ser: [p[0]]),
        storage=MemoryStorage(),
    )
    with pytest.raises(ConfigError):
        abc.run(seed=0)


def test_reads_historical_reference_database(tmp_path):
    """The reference tree ships a real 2015-era dengue posterior database with
    the OLD table names (jobs/parameters/metrics - see vis/abc_plots.R:5).
    SQLiteStorage detects the legacy schema, so old posteriors keep working as
    POSTERIOR sources (src/AbcSmc.cpp:293-335 slurp_posterior semantics)."""
    import os
    import shutil

    from abcsmc_tpu.storage import SQLiteStorage

    src = "/root/reference/examples/scratch/posterior.sqlite"
    if not os.path.exists(src):
        pytest.skip("reference posterior.sqlite not present")
    db = str(tmp_path / "old.sqlite")
    shutil.copy(src, db)

    store = SQLiteStorage(db)
    assert store.exists()
    assert store.par_names == ["caseEF", "mos_mov", "exp_coef", "num_mos",
                               "beta"]
    mat = store.read_posterior_matrix(["mos_mov", "beta"])
    assert mat.shape == (1000, 2)
    assert np.isfinite(mat).all()
    gens = store.read_generations()
    assert gens[-1].complete and gens[-1].has_posterior
    store.close()

    # two-stage workflow: POSTERIOR parameters sourced from the legacy DB
    proj = {
        "database_filename": str(tmp_path / "proj.sqlite"),
        "posterior_database_filename": db,
        "parameters": [
            {"name": "scenario", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 0, "par2": 1},
            {"name": "mos_mov", "dist_type": "POSTERIOR", "num_type": "FLOAT",
             "par1": 0, "par2": 9},
            {"name": "beta", "dist_type": "POSTERIOR", "num_type": "FLOAT",
             "par1": 0, "par2": 9},
        ],
        "metrics": [
            {"name": "m1", "num_type": "FLOAT", "value": 0},
            {"name": "m2", "num_type": "FLOAT", "value": 0},
            {"name": "m3", "num_type": "FLOAT", "value": 0},
        ],
    }
    abc = AbcSmc(proj, simulator=PySimulator(
        lambda pars, seed, serial: [pars[0], pars[1], pars[2]]))
    abc.process_database(seed=0)
    abc.simulate_next_particles(n=-1)
    assert abc.process_database(seed=1) is True
    import sqlite3 as _sq

    conn = _sq.connect(proj["database_filename"])
    n, = conn.execute("select count(*) from job where status='D'").fetchone()
    # 2 scenarios x 10 posterior rows
    assert n == 20
    # echoed metrics carry the sourced posterior values
    rows = conn.execute(
        "select p.mos_mov, m.m2 from par p, met m where p.serial = m.serial"
    ).fetchall()
    conn.close()
    for mm, m2 in rows:
        assert m2 == mm
