"""device_dispatch control + NRMSE-tolerance runs on the fused paths.

`nrmse_tolerance` used to disable every fused dispatch path (one program
launch per SMC set - the exact cost run_scan/run_chain exist to remove). Now the fused chain computes every set
and the mirror truncates at the first converged set, landing exactly the
rows the sequential loop (which stops dispatching there) stores. The
`device_dispatch` config key ("auto" | "fused" | "sequential") makes the
choice explicit, and `AbcSmc.timings`' ``programs`` field pins the chain
path's dispatch count to size TRANSITIONS, not sets (the reference
quick-start's 30-set varying schedule, examples/reference.json:2-4).
"""

import numpy as np
import pytest

from abcsmc_tpu.config import parse_config
from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.errors import ConfigError
from abcsmc_tpu.models.simulators import make_dice_simulator
from abcsmc_tpu.storage import MemoryStorage


def dice_cfg(**over):
    cfg = {
        "smc_iterations": 3,
        "num_samples": 64,
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
    cfg.update(over)
    return cfg


def _programs(abc):
    phases = [t for t in abc.timings if t["op"] == "run_device_phases"]
    assert phases, "phase observability entry missing"
    return phases[-1]["programs"]


def test_device_dispatch_validation():
    with pytest.raises(ConfigError):
        parse_config(dice_cfg(device_dispatch="both"))
    for v in ("auto", "fused", "sequential"):
        assert parse_config(dice_cfg(device_dispatch=v)).device_dispatch == v


def test_tolerance_run_stays_fused_and_matches_sequential():
    """A tolerance run must (a) still take a fused dispatch path (programs
    well below one-per-set) and (b) store row-for-row what the sequential
    loop stores, early stop included."""
    cfg = dice_cfg(num_samples=96, smc_iterations=12, nrmse_tolerance=0.3)

    abc_seq = AbcSmc(dict(cfg, device_dispatch="sequential"),
                     simulator=make_dice_simulator(max_dice=50),
                     storage=MemoryStorage())
    abc_seq.run_device(seed=13)
    n_sets = len(abc_seq._weights)
    assert 1 <= n_sets < 12  # tolerance actually triggered mid-run
    # sequential loop: one step program per set it ran (+ gen-0 init)
    assert _programs(abc_seq) >= n_sets + 1

    abc_fused = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                       storage=MemoryStorage())
    abc_fused.run_device(seed=13)
    # constant shapes -> run_scan: ONE whole-chain program (+ the traced
    # init the first compile counts)
    assert _programs(abc_fused) <= 2

    assert len(abc_fused._weights) == n_sets
    for t in range(n_sets):
        np.testing.assert_array_equal(
            abc_fused.particle_parameters[t], abc_seq.particle_parameters[t]
        )
        np.testing.assert_array_equal(
            abc_fused.particle_metrics[t], abc_seq.particle_metrics[t]
        )
        np.testing.assert_array_equal(
            abc_fused._predictive_prior[t], abc_seq._predictive_prior[t]
        )
    p1, w1 = abc_fused.posterior()
    p2, w2 = abc_seq.posterior()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(w1, w2, rtol=1e-12)


def test_tolerance_store_truncated_like_sequential(tmp_path):
    """The durable store of a fused tolerance run holds exactly the sets the
    sequential loop would mirror - no dangling over-computed tail sets."""
    seq_db = str(tmp_path / "seq.sqlite")
    fus_db = str(tmp_path / "fus.sqlite")
    cfg = dice_cfg(num_samples=96, smc_iterations=12, nrmse_tolerance=0.3)

    AbcSmc(dict(cfg, device_dispatch="sequential", database_filename=seq_db),
           simulator=make_dice_simulator(max_dice=50)).run_device(seed=13)
    AbcSmc(dict(cfg, database_filename=fus_db),
           simulator=make_dice_simulator(max_dice=50)).run_device(seed=13)

    from abcsmc_tpu.storage import SQLiteStorage

    gs = SQLiteStorage(seq_db).read_generations()
    gf = SQLiteStorage(fus_db).read_generations()
    assert len(gs) == len(gf) and len(gs) < 12
    for a, b in zip(gs, gf):
        assert a.complete and b.complete
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.metrics, b.metrics)
        np.testing.assert_array_equal(a.posterior_ranks, b.posterior_ranks)
        np.testing.assert_array_equal(a.seeds, b.seeds)


def test_tolerance_cut_mid_bucket_matches_sequential():
    """A tolerance that converges INSIDE a scanned same-size bucket
    exercises the straddling-bucket device slice (the [L, ...] stacked
    leaves are cut to [:take] before the fetch, engine.run_device): the
    fused chain's store must still match the sequential loop row for row."""
    sizes = [48, 80] + [96] * 10   # 12 sets; the 96 bucket scans as peel+scan
    # seed 13's NRMSE trajectory first drops below 0.04 at set 4 - two sets
    # into the 96-bucket's 9-set scan, so the cut slices the stacked leaves
    cfg = dice_cfg(
        num_samples=sizes, smc_iterations=len(sizes),
        predictive_prior_size=12, nrmse_tolerance=0.04,
    )
    cfg.pop("predictive_prior_fraction")

    abc_seq = AbcSmc(dict(cfg, device_dispatch="sequential"),
                     simulator=make_dice_simulator(max_dice=50),
                     storage=MemoryStorage())
    abc_seq.run_device(seed=13)
    n_sets = len(abc_seq._weights)
    # the cut must land strictly inside the trailing 96-bucket's scan (sets
    # 3..11 after the set-2 peel) for this test to exercise the straddle;
    # the (seed, tolerance) pair is pinned to make that deterministic
    assert 3 < n_sets < 12, n_sets

    abc_fused = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                       storage=MemoryStorage())
    abc_fused.run_device(seed=13)
    assert _programs(abc_fused) < _programs(abc_seq)
    assert len(abc_fused._weights) == n_sets
    for t in range(n_sets):
        np.testing.assert_array_equal(
            abc_fused.particle_parameters[t], abc_seq.particle_parameters[t]
        )
        np.testing.assert_array_equal(
            abc_fused.particle_metrics[t], abc_seq.particle_metrics[t]
        )
        np.testing.assert_array_equal(
            abc_fused._predictive_prior[t], abc_seq._predictive_prior[t]
        )


def test_chain_dispatch_count_scales_with_size_transitions():
    """The reference quick-start's varying schedule (300/500/750/1000-like,
    here shrunk) must dispatch one program per SIZE TRANSITION, not per set -
    including when an NRMSE tolerance is configured (too tight to trigger)."""
    sizes = [48, 80, 80, 120] + [160] * 8   # 12 sets, 4 distinct shapes
    cfg = dice_cfg(
        num_samples=sizes, smc_iterations=len(sizes),
        predictive_prior_size=12, nrmse_tolerance=1e-12,
    )
    cfg.pop("predictive_prior_fraction")
    abc = AbcSmc(cfg, simulator=make_dice_simulator(max_dice=50),
                 storage=MemoryStorage())
    abc.run_device(seed=29)
    assert len(abc._weights) == len(sizes)  # tolerance never triggered
    # run_chain buckets: 48 single, 80-pair scan, 120 single, 160-run
    # (peel + scan) -> <= 6 step programs + init, vs 13 sequential
    assert _programs(abc) <= 7, abc.timings[-1]
