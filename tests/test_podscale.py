"""Numeric execution at pod-representative device counts (16 / 32 / 64
virtual CPU devices), via subprocess workers (the pytest process is pinned
to the 8-device mesh by conftest).

everything that had ever RUN used <= 8 devices; the
16/32-device story was compile-level only. These tests EXECUTE the regimes
that only exist above 8 devices and assert equality with the host rule and
across mesh sizes:

  - local_n < keep (the single-stage top-K "bend": every shard contributes
    its whole slice as candidates) - tests/scale_worker.py::bend_host_rule
  - keep % ndev != 0 weight-kernel padding - same scenario
  - the two-stage top-K auto-activating at its 16 MiB payload threshold and
    matching single-stage bit for bit - ::two_stage_auto
  - a full engine run (pad-and-mask sizes) - ::engine
  - a 4-process x 2-device jax.distributed engine run against one shared
    store - test_multihost.py::test_four_process_engine_matches_single_process

Reference target: the cluster-scale fan-out heritage
(/root/reference/README.md:4, examples/scratch/job.slurm - 256 MPI ranks).
"""

import json
import os
import subprocess
import sys

import pytest


def _run_scale_worker(n_devices: int, scenario: str, out_path: str) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "tests/scale_worker.py", str(n_devices), scenario,
         out_path],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        timeout=540,
    )
    assert p.returncode == 0, f"scale_worker failed:\n{p.stdout}\n{p.stderr}"
    with open(out_path) as fh:
        return json.loads(fh.read())


@pytest.mark.parametrize("ndev", [16, 32, 64])
def test_topk_bend_and_weight_padding_match_host_rule(ndev, tmp_path):
    r = _run_scale_worker(ndev, "bend_host_rule", str(tmp_path / "bend.json"))
    assert r["ok"] and r["local_n"] < r["keep"] and r["keep"] % ndev != 0


def test_bend_survivors_invariant_across_mesh_sizes(tmp_path):
    """The same data must select the same survivors at 16, 32, and 64
    devices (and the worker already pinned each against the host rule,
    which the 8-device suite pins everywhere else - transitively
    8 == 16 == 32 == 64)."""
    r16 = _run_scale_worker(16, "bend_host_rule", str(tmp_path / "b16.json"))
    r32 = _run_scale_worker(32, "bend_host_rule", str(tmp_path / "b32.json"))
    r64 = _run_scale_worker(64, "bend_host_rule", str(tmp_path / "b64.json"))
    assert r16["surv_crc"] == r32["surv_crc"] == r64["surv_crc"]
    assert abs(r16["w_sum"] - r32["w_sum"]) < 1e-9 * abs(r16["w_sum"])
    assert abs(r16["w_sum"] - r64["w_sum"]) < 1e-9 * abs(r16["w_sum"])


@pytest.mark.parametrize("ndev", [16, 32, 64])
def test_two_stage_topk_auto_activates_and_matches(ndev, tmp_path):
    r = _run_scale_worker(ndev, "two_stage_auto", str(tmp_path / "two.json"))
    assert r["ok"] and r["n"] == 1 << 19 and r["keep"] == (1 << 19) // ndev


def test_engine_runs_at_32_devices(tmp_path):
    r = _run_scale_worker(32, "engine", str(tmp_path / "eng.json"))
    assert r["ok"]
    # dice posterior pulls toward the analytic inverse (~(9.4, 8.4))
    assert 2.0 < r["post_mean"] < 16.0, r
