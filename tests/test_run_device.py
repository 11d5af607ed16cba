"""Engine on-device fast path: fused sharded generations + store mirroring."""

import sqlite3

import numpy as np
import pytest

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.models.simulators import PySimulator, make_dice_simulator
from abcsmc_tpu.storage import MemoryStorage


def dice_cfg(db=None, n=64):
    cfg = {
        "smc_iterations": 3,
        "num_samples": n,
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
    if db:
        cfg["database_filename"] = db
    return cfg


def test_run_device_mirrors_reference_schema(tmp_path):
    db = str(tmp_path / "dev.sqlite")
    abc = AbcSmc(dice_cfg(db), simulator=make_dice_simulator(max_dice=50))
    abc.run_device(seed=3)

    conn = sqlite3.connect(db)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet"
    ).fetchall()
    assert sets == [(0, 64, 64, 16), (1, 64, 64, 16), (2, 64, 64, 16)]
    # seeds stored, params in range
    row = conn.execute(
        "select seed, ndice, sides from par where serial = 0"
    ).fetchone()
    assert int(row[0]) >= 0
    assert 1 <= row[1] <= 50
    conn.close()

    pars, w = abc.posterior()
    assert pars.shape == (16, 2)
    assert np.all(np.isfinite(w))


def test_run_device_converges_like_host():
    abc = AbcSmc(
        dice_cfg(n=512), simulator=make_dice_simulator(max_dice=50),
        storage=MemoryStorage(),
    )
    abc.run_device(seed=11)
    pars, _ = abc.posterior()
    # analytic dice inverse ~ (9.4, 8.4)
    assert abs(pars[:, 0].mean() - 9.4) < 6
    assert abs(pars[:, 1].mean() - 8.4) < 6


def test_run_device_row_block_config_matches_default():
    """`row_block` flows config -> engine -> ShardedGeneration; a forced
    tiny block must reproduce the default (resident) device run exactly."""
    cfg = dice_cfg(n=64)
    abc_a = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_a.run_device(seed=23)
    abc_b = AbcSmc(dict(cfg, row_block=4),
                   simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_b.run_device(seed=23)
    p1, w1 = abc_a.posterior()
    p2, w2 = abc_b.posterior()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_run_device_topk_config_matches_default():
    """`topk_two_stage` flows config -> engine -> ShardedGeneration; forcing
    the two-stage top-K must reproduce the default (single-stage at this
    payload) device run exactly."""
    cfg = dice_cfg(n=64)
    abc_a = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_a.run_device(seed=23)
    abc_b = AbcSmc(dict(cfg, topk_two_stage=True),
                   simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_b.run_device(seed=23)
    p1, w1 = abc_a.posterior()
    p2, w2 = abc_b.posterior()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_run_device_scan_path_matches_sequential_loop():
    """Fresh constant-shape runs take the one-program run_scan fast path;
    forcing the sequential per-set loop (device_dispatch='sequential') must
    give the identical stored result on CPU (the fused chain replicates the
    key-split chain exactly; see generation.ShardedGeneration.run_scan)."""
    cfg = dice_cfg(n=64)
    abc_scan = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                      storage=MemoryStorage())
    abc_scan.run_device(seed=17)
    phases = [t for t in abc_scan.timings if t["op"] == "run_device_phases"]
    assert phases, "phase observability entry missing"

    cfg_seq = dict(cfg, device_dispatch="sequential")
    abc_seq = AbcSmc(cfg_seq, simulator=make_dice_simulator(max_dice=50),
                     storage=MemoryStorage())
    abc_seq.run_device(seed=17)

    for t in range(3):
        np.testing.assert_array_equal(
            abc_scan.particle_parameters[t], abc_seq.particle_parameters[t]
        )
        np.testing.assert_array_equal(
            abc_scan.particle_metrics[t], abc_seq.particle_metrics[t]
        )
    p1, w1 = abc_scan.posterior()
    p2, w2 = abc_seq.posterior()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_run_device_chain_path_matches_sequential_loop():
    """Fresh VARYING-size runs take the bucketed run_chain fast path (the
    reference quick-start's [300, 500, 500, 750, 1000] schedule never hit
    run_scan); forcing the sequential per-set loop
    must give the identical stored result on CPU (run_chain replicates the
    key-split chain exactly)."""
    sizes = [32, 64, 64, 64, 96]
    base = dict(dice_cfg(), num_samples=sizes, smc_iterations=len(sizes))
    base.pop("database_filename", None)
    fixed_keep = dict(base, predictive_prior_size=8)
    fixed_keep.pop("predictive_prior_fraction", None)  # XOR'd with _size
    # fraction-based keep VARIES with the set size (keeps [8, 16, 16, 16,
    # 24]) - the reference quick-start's actual shape, and the case where
    # a bucket's incoming survivor state is sized by the previous keep
    # (the scan carry must peel it; caught by the round-4 verify drive)
    varying_keep = dict(base, predictive_prior_fraction=0.25)
    for cfg in (fixed_keep, varying_keep):
        abc_chain = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                           storage=MemoryStorage())
        abc_chain.run_device(seed=29)

        cfg_seq = dict(cfg, device_dispatch="sequential")
        abc_seq = AbcSmc(cfg_seq, simulator=make_dice_simulator(max_dice=50),
                         storage=MemoryStorage())
        abc_seq.run_device(seed=29)

        for t in range(len(sizes)):
            assert abc_chain.particle_parameters[t].shape == (sizes[t], 2)
            np.testing.assert_array_equal(
                abc_chain.particle_parameters[t],
                abc_seq.particle_parameters[t],
            )
            np.testing.assert_array_equal(
                abc_chain.particle_metrics[t], abc_seq.particle_metrics[t]
            )
            np.testing.assert_array_equal(
                abc_chain._predictive_prior[t], abc_seq._predictive_prior[t]
            )
        p1, w1 = abc_chain.posterior()
        p2, w2 = abc_seq.posterior()
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_run_chain_dispatch_bucketing():
    """run_chain collapses maximal same-shape runs into single lax.scan
    dispatches: a [32, 64x4, 96] schedule compiles 4 step-shaped programs
    (first-32, single-64 transition, 3-set 64 bucket, final-96), not one
    per set."""
    import jax

    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh

    sizes = [32, 64, 64, 64, 64, 96]
    keeps = [8] * len(sizes)
    cfg_d = dict(dice_cfg(), num_samples=sizes, smc_iterations=len(sizes),
                 predictive_prior_size=8)
    cfg_d.pop("predictive_prior_fraction", None)
    cfg = parse_config(cfg_d)
    gen = ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_dice_simulator(max_dice=50),
        np.array([44.0, 2.39925]),
        mesh=particle_mesh(),
    )
    state, hist = gen.run_chain(jax.random.PRNGKey(4), sizes, keeps)
    assert len(hist) == len(sizes)
    # one "chain" scan entry covers sets 1-3 (n=64 with 64-successors);
    # set 0 (first), set 4 (64 -> 96 transition) and set 5 (final 96)
    # dispatch singly
    chain_entries = [k for k in gen._step_cache if k[0] == "chain"]
    assert len(chain_entries) == 1, gen._step_cache.keys()
    assert chain_entries[0][4] == 3  # bucket length L
    # every set produced K-sized survivor data
    for h in hist:
        assert np.asarray(h[3]).shape == (8,)
        assert np.all(np.isfinite(np.asarray(h[3])))


def test_run_device_falls_back_for_host_simulator():
    abc = AbcSmc(
        dice_cfg(n=20),
        simulator=PySimulator(lambda p, s, ser: [p[0] * 3.5, p[1] * 0.5]),
        storage=MemoryStorage(),
    )
    abc.run_device(seed=1)  # silently uses the host engine
    pars, _ = abc.posterior()
    assert pars.shape[0] == 5


def test_run_device_resume_via_host_path(tmp_path):
    """A device-run database is a valid checkpoint: the host engine reads it
    and continues (e.g. proposes more generations under a longer config)."""
    db = str(tmp_path / "resume.sqlite")
    abc = AbcSmc(dice_cfg(db), simulator=make_dice_simulator(max_dice=50))
    abc.run_device(seed=5)
    abc.storage.close()

    cfg2 = dice_cfg(db)
    cfg2["smc_iterations"] = 4  # one more generation than the device run
    abc2 = AbcSmc(cfg2, simulator=make_dice_simulator(max_dice=50))
    assert abc2.process_database(seed=6) is True  # proposes set 3
    abc2.simulate_next_particles(n=-1)
    abc2.process_database(seed=7)
    pars, _ = abc2.posterior()
    assert pars.shape == (16, 2)


def test_thirty_generation_soak():
    """The reference's default-scale generation count (30 in its quick-start
    config): weights must stay finite and non-degenerate across a long chain
    of INDEPENDENT-noise generations."""
    cfg = dice_cfg(n=96)
    cfg["smc_iterations"] = 30
    cfg["predictive_prior_fraction"] = 0.25
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                 storage=MemoryStorage())
    abc.run_device(seed=30)
    assert len(abc._weights) == 30
    for t in range(30):
        w = abc._weights[t]
        assert np.all(np.isfinite(w)) and w.sum() > 0
    # ESS never collapses to a single particle
    ess = [abc.ess(t) for t in range(30)]
    assert min(ess) > 1.5, ess
    pars, _ = abc.posterior()
    # converged near the analytic inverse after 30 generations
    assert abs(pars[:, 1].mean() - 8.4) < 4


def test_nrmse_early_stopping():
    """'nrmse_tolerance' stops both loops early once the posterior metric
    means match the observed within tolerance."""
    cfg = dice_cfg(n=96)
    cfg["smc_iterations"] = 30
    cfg["nrmse_tolerance"] = 0.3  # loose: reached within a few generations
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                 storage=MemoryStorage())
    abc.run_device(seed=13)
    assert 1 <= len(abc._weights) < 30

    abc2 = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                  storage=MemoryStorage())
    abc2.run(seed=13)
    assert 1 <= len(abc2._weights) < 30
    # early stop must not leave a dangling unsimulated 'Q' generation
    gens = abc2.storage.read_generations()
    assert all(g.complete for g in gens)
    assert len(gens) == len(abc2._weights)


def test_run_device_non_divisible_population(tmp_path):
    """Reference-shaped sizes (not divisible by the 8-device mesh) stay on the
    device path via tail pad-and-mask (examples/reference.json uses 300/1000).
    The store must contain exactly the configured rows - no padding leaks."""
    db = str(tmp_path / "odd.sqlite")
    cfg = dice_cfg(db, n=100)          # 100 % 8 != 0
    del cfg["predictive_prior_fraction"]
    cfg["predictive_prior_size"] = 25  # 25 % 8 != 0
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50))
    abc.run_device(seed=7)

    conn = sqlite3.connect(db)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(0, 100, 100, 25), (1, 100, 100, 25), (2, 100, 100, 25)]
    pars, w = abc.posterior()
    assert pars.shape == (25, 2)
    assert np.all(np.isfinite(w))
    for t in range(3):
        assert abc._particle_parameters[t].shape == (100, 2)
        assert abc._particle_metrics[t].shape == (100, 2)
        assert np.isfinite(abc._particle_metrics[t]).all()


def test_run_device_resumes_half_simulated_store(tmp_path):
    """Device-side resume (reference crash-anywhere property,
    src/AbcSmc.cpp:452-479): a store with set 0 half simulated is picked up
    by run_device, already-written metrics are kept (first-write-wins), and
    the run completes entirely on device."""
    db = str(tmp_path / "half.sqlite")
    sim = make_dice_simulator(max_dice=50)
    abc = AbcSmc(dice_cfg(db), simulator=sim)
    abc.build_database(seed=9)
    abc.simulate_next_particles(n=24)   # 24 of 64 rows of set 0
    conn = sqlite3.connect(db)
    before = conn.execute(
        "select m.serial, m.sum, m.sd from met m, job j "
        "where m.serial = j.serial and j.status = 'D' order by m.serial"
    ).fetchall()
    conn.close()
    assert len(before) == 24
    abc.storage.close()

    abc2 = AbcSmc(dice_cfg(db), simulator=sim)
    abc2.run_device(seed=21)
    conn = sqlite3.connect(db)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet"
    ).fetchall()
    after = conn.execute(
        "select m.serial, m.sum, m.sd from met m "
        f"where m.serial in ({','.join(str(r[0]) for r in before)}) "
        "order by m.serial"
    ).fetchall()
    conn.close()
    assert sets == [(0, 64, 64, 16), (1, 64, 64, 16), (2, 64, 64, 16)]
    assert after == before   # stored results not overwritten

    # posterior agrees with a pure host continuation of the same checkpoint
    pars, _ = abc2.posterior()
    assert abs(pars[:, 0].mean() - 9.4) < 8
    assert abs(pars[:, 1].mean() - 8.4) < 8


def test_run_device_resume_ranks_from_stored_metrics(tmp_path):
    """A mid-set device resume must rank from the
    DURABLE metrics, not from its own re-simulation. Stored 'D' rows here are
    perturbed as if written by a different backend/dtype; the posterior ranks
    the device continuation writes for the resumed set must equal a pure-host
    continuation's (the reference ranking always reads the DB,
    src/AbcSmc.cpp:596-661)."""
    import shutil

    from abcsmc_tpu.models.simulators import make_gaussian_simulator

    def gauss_cfg(db):
        return {
            "smc_iterations": 2,
            "num_samples": 64,
            "predictive_prior_fraction": 0.25,
            "filter": "SIMPLE",   # key-free ranking: host/device bit-compare
            "parameters": [
                {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
                 "par1": -5.0, "par2": 5.0},
                {"name": "sigma", "dist_type": "UNIFORM",
                 "num_type": "FLOAT", "par1": 0.5, "par2": 5.0},
            ],
            "metrics": [
                {"name": "mean", "num_type": "FLOAT", "value": 1.0},
                {"name": "sd", "num_type": "FLOAT", "value": 2.0},
            ],
            "database_filename": db,
        }

    sim = make_gaussian_simulator()
    db = str(tmp_path / "seed.sqlite")
    abc = AbcSmc(gauss_cfg(db), simulator=sim)
    abc.build_database(seed=2)
    abc.simulate_next_particles(n=24)     # 24 of 64 rows of set 0 are 'D'
    abc.storage.close()
    # make the stored metrics distinguishable from what re-simulating the
    # same seeds would produce (as a foreign-backend store would be)
    conn = sqlite3.connect(db)
    conn.execute(
        "update met set mean = mean + 0.37, sd = sd * 1.05 where serial in "
        "(select serial from job where status = 'D')"
    )
    conn.commit()
    conn.close()

    db_host = str(tmp_path / "host.sqlite")
    db_dev = str(tmp_path / "dev.sqlite")
    shutil.copy(db, db_host)
    shutil.copy(db, db_dev)

    AbcSmc(gauss_cfg(db_host), simulator=sim).run(seed=21)
    AbcSmc(gauss_cfg(db_dev), simulator=sim).run_device(seed=21)

    def set0_ranks(path):
        conn = sqlite3.connect(path)
        rows = conn.execute(
            "select serial, posterior from job where smcSet = 0 "
            "order by serial"
        ).fetchall()
        conn.close()
        return rows

    assert set0_ranks(db_dev) == set0_ranks(db_host)


def test_run_device_resumes_at_set_boundary(tmp_path):
    """A finished shorter run extends on the device path when the config asks
    for more sets (reference behavior: --process proposes the next set)."""
    db = str(tmp_path / "extend.sqlite")
    sim = make_dice_simulator(max_dice=50)
    cfg2 = dice_cfg(db)
    cfg2["smc_iterations"] = 2
    AbcSmc(cfg2, simulator=sim).run_device(seed=5)

    cfg4 = dice_cfg(db)
    cfg4["smc_iterations"] = 4
    abc = AbcSmc(cfg4, simulator=sim)
    abc.run_device(seed=6)
    conn = sqlite3.connect(db)
    sets = conn.execute(
        "select smcSet, count(*), sum(status='D'), sum(posterior > -1) "
        "from job group by smcSet"
    ).fetchall()
    conn.close()
    assert sets == [(t, 64, 64, 16) for t in range(4)]
    assert len(abc._weights) == 4
    # idempotent: running again reports completion, changes nothing
    abc3 = AbcSmc(cfg4, simulator=sim)
    abc3.run_device(seed=8)
    assert len(abc3._weights) == 4


def test_run_device_projection_sweep(tmp_path):
    """PSEUDO sweeps run sharded on the device path (src/AbcSmc.cpp:54-137):
    same odometer order (first parameter fastest, ParRNG.h:17-36 semantics),
    simulated as one mesh program."""
    import jax.numpy as jnp
    from abcsmc_tpu.models.simulators import DeviceSimulator

    db = str(tmp_path / "proj_dev.sqlite")
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
    echo = DeviceSimulator(lambda p, key: jnp.asarray(p), nmet=2)
    abc = AbcSmc(cfg, simulator=echo)
    abc.run_device(seed=0)

    conn = sqlite3.connect(db)
    rows = conn.execute(
        "select p.a, p.b, m.m1, m.m2, j.status from par p, met m, job j "
        "where p.serial = m.serial and p.serial = j.serial order by p.serial"
    ).fetchall()
    conn.close()
    assert [(r[0], r[1]) for r in rows] == [
        (1.0, 0.5), (2.0, 0.5), (3.0, 0.5), (1.0, 1.5), (2.0, 1.5), (3.0, 1.5),
    ]
    for a, b, m1, m2, status in rows:
        assert (m1, m2) == (a, b)
        assert status == "D"


def test_run_device_box_cox_stays_on_device():
    """box_cox configs run the fused device path (the
    transform is a device stage now, parallel/generation.py) - the host
    fallback must NOT be taken."""
    cfg = dice_cfg(n=24)
    cfg["box_cox"] = True
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                 storage=MemoryStorage())

    def _no_host_fallback(*a, **k):
        raise AssertionError("run_device fell back to the host engine")

    abc.run = _no_host_fallback
    abc.run_device(seed=2)
    pars, _ = abc.posterior()
    assert pars.shape == (6, 2)
    assert len(abc._weights) == 3


def test_run_device_propose_split_matches_default():
    """`propose_split: true` flows config -> engine; the engine then
    sequences rank -> eager mirror fetch -> FREE -> propose per generation
    (the HBM-bound big-N ordering). The stored results must be identical to
    the default fused run: the split proposal uses the same step key, so
    the draws are bit-equal."""
    cfg = dice_cfg(n=64)
    abc_a = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_a.run_device(seed=31)
    abc_b = AbcSmc(dict(cfg, propose_split=True, nrmse_tolerance=0.0),
                   simulator=make_dice_simulator(max_dice=50),
                   storage=MemoryStorage())
    abc_b.run_device(seed=31)
    for t in range(3):
        np.testing.assert_array_equal(
            abc_a.particle_parameters[t], abc_b.particle_parameters[t]
        )
        np.testing.assert_array_equal(
            abc_a.particle_metrics[t], abc_b.particle_metrics[t]
        )
    p1, w1 = abc_a.posterior()
    p2, w2 = abc_b.posterior()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_run_device_resume_with_propose_split(tmp_path):
    """Resuming a half-simulated store with the split-propose sequencing
    active must produce the identical database as the fused resume (the
    split proposal uses the same step key, and the resumed set's
    metrics-precomputed step is followed by an engine-level propose)."""
    dbs = {}
    for split in (False, True):
        db = str(tmp_path / f"resume_{split}.sqlite")
        sim = make_dice_simulator(max_dice=50)
        abc = AbcSmc(dice_cfg(db), simulator=sim)
        abc.build_database(seed=9)
        abc.simulate_next_particles(n=24)
        abc.storage.close()
        cfg = dict(dice_cfg(db))
        if split:
            cfg["propose_split"] = True
        abc2 = AbcSmc(cfg, simulator=sim)
        abc2.run_device(seed=21)
        conn = sqlite3.connect(db)
        dbs[split] = (
            conn.execute(
                "select smcSet, count(*), sum(status='D'), "
                "sum(posterior > -1) from job group by smcSet").fetchall(),
            conn.execute(
                "select serial, ndice, sides from par order by serial"
            ).fetchall(),
            conn.execute(
                "select serial, posterior from job order by serial"
            ).fetchall(),
        )
        conn.close()
        abc2.storage.close()
    assert dbs[False] == dbs[True]


def test_run_device_host_fallback_refuses_multiprocess(tmp_path, monkeypatch):
    """run_device's host-engine fallbacks (non-device simulator; >1
    incomplete set) have no process gating: on a multi-process mesh with a
    shared store every process would drive the brain against the same
    database at once. The engine must refuse loudly, not silently race."""
    import jax

    from abcsmc_tpu.errors import AbcError

    db = str(tmp_path / "mp.sqlite")
    abc = AbcSmc(
        dice_cfg(db),
        simulator=PySimulator(lambda pars, seed: [float(pars[0]), 1.0]),
    )
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(AbcError, match="multi-process"):
        abc.run_device(seed=5)
    # process-private stores are fine: each process runs an independent
    # identical host fit
    abc_mem = AbcSmc(
        dice_cfg(),
        simulator=PySimulator(lambda pars, seed: [float(pars[0]), 1.0]),
        storage=MemoryStorage(),
    )
    assert not getattr(abc_mem.storage, "shared", True)
    abc_mem._require_single_process_for_host_fallback("test")  # no raise


def test_writer_guard_single_process_semantics():
    """engine._writer_guard on a single-process mesh is a transparent
    scope: clean pass-through adds nothing, and a local error re-raises
    unchanged (no wrapping, no collective) — the multi-process
    failure-propagation leg is pinned in tests/test_multihost.py."""
    abc = AbcSmc(dice_cfg(), simulator=make_dice_simulator(max_dice=50))
    with abc._writer_guard("a no-op phase"):
        pass
    planted = ValueError("planted")
    with pytest.raises(ValueError) as exc:
        with abc._writer_guard("the store mirror"):
            raise planted
    assert exc.value is planted
