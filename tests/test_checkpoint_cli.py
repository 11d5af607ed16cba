"""Checkpointing (memstore -> SQLite snapshot), ESS diagnostic, CLI worker
pool flag, and simulator failure modes."""

import os
import sqlite3

import numpy as np
import pytest

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.errors import SimulatorError
from abcsmc_tpu.models.simulators import PySimulator, make_dice_simulator
from abcsmc_tpu.storage import MemoryStorage, SQLiteStorage


def cfg(n=40, iters=2, **kw):
    c = {
        "smc_iterations": iters,
        "num_samples": n,
        "predictive_prior_size": 10,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 30},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 30},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    c.update(kw)
    return c


def test_checkpoint_snapshot_roundtrip(tmp_path):
    abc = AbcSmc(cfg(), simulator=make_dice_simulator(max_dice=30),
                 storage=MemoryStorage())
    abc.run(seed=2)
    path = str(tmp_path / "ckpt.sqlite")
    stamp = abc.checkpoint(path)

    # the CRC stamp documents the shipped file and verifies round-trip
    from abcsmc_tpu import crc32

    assert stamp["crc32"] == f"{crc32.file_crc(path):08x}"
    assert crc32.verify_checkpoint(path) is True

    conn = sqlite3.connect(path)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet"
    ).fetchall()
    assert sets == [(0, 40, 40, 10), (1, 40, 40, 10)]
    conn.close()

    # the snapshot is a live checkpoint: a fresh engine resumes from it
    c2 = cfg(iters=3, database_filename=path)
    abc2 = AbcSmc(c2, simulator=make_dice_simulator(max_dice=30))
    assert abc2.process_database(seed=5) is True  # proposes set 2
    abc2.simulate_next_particles(n=-1)
    abc2.process_database(seed=6)
    pars, _ = abc2.posterior()
    assert pars.shape == (10, 2)


def test_checkpoint_copies_sqlite_backed_store(tmp_path):
    """checkpoint(path) on a SQLite-backed run copies the live DB (online
    backup API) to the new path and stamps it; same path = no-op + stamp."""
    live = str(tmp_path / "live.sqlite")
    abc = AbcSmc(cfg(database_filename=live),
                 simulator=make_dice_simulator(max_dice=30),
                 storage=SQLiteStorage(live))
    abc.run(seed=3)
    copy = str(tmp_path / "shipped.sqlite")
    stamp = abc.checkpoint(copy)

    import sqlite3 as sq

    rows = sq.connect(copy).execute(
        "select count(*), sum(status='D') from job"
    ).fetchone()
    assert rows == (80, 80)
    from abcsmc_tpu import crc32

    assert crc32.verify_checkpoint(copy) is True
    assert stamp["bytes"] > 0
    # stamping the live DB in place also works
    stamp2 = abc.checkpoint(live)
    assert crc32.verify_checkpoint(live) is True
    assert stamp2["path"] == live
    # os.PathLike targets work end-to-end (incl. the .crc.json sidecar)
    from pathlib import Path

    stamp3 = abc.checkpoint(Path(tmp_path) / "pathlike.sqlite")
    assert crc32.verify_checkpoint(tmp_path / "pathlike.sqlite") is True
    assert stamp3["bytes"] > 0


def test_ess_diagnostic():
    abc = AbcSmc(cfg(), simulator=make_dice_simulator(max_dice=30),
                 storage=MemoryStorage())
    abc.run(seed=3)
    # gen 0 uniform weights -> ESS == K
    assert abc.ess(0) == pytest.approx(10.0)
    assert 1.0 <= abc.ess(1) <= 10.0


def test_metric_count_mismatch_raises_211():
    abc = AbcSmc(
        cfg(iters=1),
        simulator=PySimulator(lambda p, s, ser: [1.0, 2.0, 3.0]),  # 3 != 2
        storage=MemoryStorage(),
    )
    abc.build_database(seed=0)
    with pytest.raises(SimulatorError) as ei:
        abc.simulate_next_particles(n=4)
    assert ei.value.code == -211


def test_cli_workers_flag(tmp_path):
    import stat
    from abcsmc_tpu.cli import main

    script = tmp_path / "sim.py"
    script.write_text(
        "#!/usr/bin/env python3\n"
        "import sys, os, random, statistics\n"
        "n = int(float(sys.argv[1])); m = int(float(sys.argv[2]))\n"
        "random.seed(int(os.environ.get('ABC_RNG_SEED', 0)))\n"
        "rolls = [random.randint(1, max(m,1)) for _ in range(max(n,1))]\n"
        "print(sum(rolls), statistics.stdev(rolls) if len(rolls)>1 else 0.0)\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    db = str(tmp_path / "w.sqlite")
    import json
    c = cfg(n=16, iters=1, database_filename=db,
            executable=f"python3 {script}")
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps(c))

    assert main([str(cfg_path), "--process", "--seed", "1"]) == 0
    assert main([str(cfg_path), "--simulate", "-n", "-1",
                 "--workers", "3", "--seed", "1"]) == 0
    conn = sqlite3.connect(db)
    assert conn.execute(
        "select count(*) from job where status = 'D'"
    ).fetchone()[0] == 16
    conn.close()


def test_cli_device_e2e(tmp_path):
    """The CLI --device path end-to-end (cli.py argparse -> run_device):
    builtin device simulator, fused sharded generations over the CPU mesh,
    complete reference-schema store, AbcLog-parity report on stderr
    (reference CLI surface: examples/include/examples.h:57-94). Run as a
    subprocess so the real exit code and stderr surface are exercised."""
    import json
    import os
    import subprocess
    import sys

    db = str(tmp_path / "dev.sqlite")
    c = cfg(n=64, iters=2, database_filename=db, simulator="dice")
    cfg_path = tmp_path / "dev.json"
    cfg_path.write_text(json.dumps(c))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    def invoke(seed):
        return subprocess.run(
            [sys.executable, "-m", "abcsmc_tpu", str(cfg_path), "--device",
             "--seed", str(seed)],
            capture_output=True, text=True, env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=500,
        )

    out = invoke(3)
    assert out.returncode == 0, out.stderr
    # filtering report (per ranked set) + convergence report ran
    assert "Set 0" in out.stderr and "Set 1" in out.stderr
    assert "Posterior means:" in out.stderr
    assert "Convergence data for predictive priors:" in out.stderr

    conn = sqlite3.connect(db)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet order by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(0, 64, 64, 10), (1, 64, 64, 10)]

    # idempotent re-invocation: the run is already complete; exit 0, no
    # new rows
    out2 = invoke(4)
    assert out2.returncode == 0, out2.stderr
    conn = sqlite3.connect(db)
    assert conn.execute("select count(*) from job").fetchone()[0] == 128
    conn.close()


def test_direct_api_construction():
    """Reference examples/direct/main.cpp surface: build without a config
    file."""
    abc = AbcSmc.direct(
        parameters=[
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
        ],
        metrics=[
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
        num_samples=100,
        smc_iterations=2,
        predictive_prior_fraction=0.1,
        simulator=make_dice_simulator(max_dice=100),
        storage=MemoryStorage(),
    )
    abc.run(seed=9)
    pars, _ = abc.posterior()
    assert pars.shape == (10, 2)


def test_posterior_summary_and_compare(tmp_path):
    from abcsmc_tpu import compare as C

    db1 = str(tmp_path / "a.sqlite")
    db2 = str(tmp_path / "b.sqlite")
    for db, seed in ((db1, 1), (db2, 2)):
        abc = AbcSmc(cfg(n=120, iters=3, database_filename=db),
                     simulator=make_dice_simulator(max_dice=30))
        abc.run(seed=seed)
    summ = abc.posterior_summary()
    assert set(summ) == {"ndice", "sides"}
    s = summ["ndice"]
    assert s["quantiles"][0.025] <= s["quantiles"][0.5] <= s["quantiles"][0.975]
    assert 1 <= s["ess"] <= 10

    res = C.compare(db1, db2)
    assert set(res) == {"ndice", "sides"}
    for v in res.values():
        assert 0.0 <= v["ks"] <= 1.0
        # two seeds of the same converging analysis should roughly agree
        assert v["mean_diff_in_sd"] < 3.0


def test_posterior_predictive():
    abc = AbcSmc(cfg(n=200, iters=3), simulator=make_dice_simulator(max_dice=30),
                 storage=MemoryStorage())
    abc.run(seed=8)
    pp = abc.posterior_predictive(n=200, seed=1)
    assert pp.shape == (200, 2)
    # predictive draws should bracket the observed metrics
    lo, hi = np.percentile(pp[:, 0], [2, 98])
    assert lo <= 44 <= hi, (lo, hi)


def test_config_fuzz_no_crashes():
    """Random garbage configs must raise ConfigError (or KeyError-free parse),
    never crash with unrelated exceptions."""
    import random
    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.errors import ConfigError

    rng = random.Random(0)
    tokens = [None, -1, 0, 1.5, "UNIFORM", "PSEUDO", "WIBBLE", [], {}, "INT",
              [1, 2], True, "0.5", float("nan")]
    for _ in range(300):
        cfg = {
            "smc_iterations": rng.choice(tokens),
            "num_samples": rng.choice(tokens),
            "predictive_prior_fraction": rng.choice(tokens),
            "parameters": rng.choice([
                [], [{"name": "x",
                      "dist_type": rng.choice(tokens),
                      "num_type": rng.choice(tokens),
                      "par1": rng.choice(tokens),
                      "par2": rng.choice(tokens)}],
                rng.choice(tokens),
            ]),
            "metrics": rng.choice([
                [], [{"name": "m", "num_type": rng.choice(tokens),
                      "value": rng.choice(tokens)}],
            ]),
        }
        try:
            parse_config(cfg)
        except (ConfigError, KeyError, TypeError, ValueError):
            pass  # rejected cleanly


@pytest.mark.parametrize("flags,sim_key,host_only", [
    (["--simulate"], {"executable": "./sim"}, True),
    (["--simulate", "-n", "10"], {"shared": "./libsim.so"}, True),
    (["--simulate", "--process"], {"executable": "./sim"}, False),
    (["--simulate"], {"simulator": "dice"}, False),
    (["--device"], {"executable": "./sim"}, False),
])
def test_cli_host_only_workers_stay_off_the_device(tmp_path, flags, sim_key,
                                                    host_only):
    """A pure --simulate worker of an external simulator never needs the
    accelerator, so it selects the CPU before any backend starts (many such
    workers share one card's host); anything that ranks, fuses or runs a
    device simulator does not."""
    import json

    from abcsmc_tpu.cli import _host_only, build_argparser

    c = cfg(n=16, iters=1, database_filename=str(tmp_path / "h.sqlite"),
            **sim_key)
    path = tmp_path / "h.json"
    path.write_text(json.dumps(c))
    args = build_argparser().parse_args([str(path)] + flags)
    assert _host_only(args) is host_only
