"""Run the ABC-SMC system's main path once on one NVIDIA GPU and check it.

    python chip_smoke.py            # phases 0-4 on one card
    python chip_smoke.py --four     # the four-card mesh path and its 1-card
                                    # comparison only

Phases (each prints its own lines; any failure exits non-zero):

0. device  - JAX must see a GPU (no fallback); prints the card's name and
             power limit, which every later timing line repeats.
1. weights - the mixture-weight denominator at 50k x 50k and 500k x 500k
             (p = 6): the GPU route and the plain XLA path, each against a
             float64 numpy oracle on 1,000 sampled rows, then timed.
2. step    - the fused generation step at 1M particles / 50k kept (6 x 13):
             component selection, resident vs chunked row passes, the
             float64 host rule in ``ops/``, and device memory.
3. fit     - the reference's production fit through the CLI
             (10,000 particles x 10 sets, keep 1 %, 6 x 13, SQLite store),
             read back from the database.
4. bridge  - a HostBridgeSimulator fit whose host function runs inside the
             fused device program through ``io_callback``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase that ran passed. Scratch files go to
``chiprun_out/chip_smoke/`` beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import time

import numpy as np

from bench import bench_generation, bench_inputs

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chiprun_out", "chip_smoke")
NPAR, NMET = 6, 13
TOL_NATS = 1e-4   # log-weights enter exp() after the max is subtracted:
#                   1e-4 nats is a 0.01 % weight error
CARD = ""
# sizes of the phases (module constants so a CPU rehearsal can shrink them)
WEIGHT_SIZES = (50_000, 500_000)
STEP_N, STEP_KEEP = 1_000_000, 50_000
FIT_N, FOUR_FIT_N = 10_000, 40_000
FOUR_N = 4_000_000
ORACLE_ROWS = 1000


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(fn, reps: int = 5) -> tuple[float, list[float]]:
    """Median wall time of ``fn()`` after one warm-up call, each call ended
    by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


# --------------------------------------------------------------- phase 0
def phase_device() -> dict:
    global CARD
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    check(platform == "gpu",
          f"JAX found platform {platform!r} ({devs[0].device_kind}); "
          "this check needs a GPU and has no fallback")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {CARD}", flush=True)
    say("device", platform=platform, kind=devs[0].device_kind,
        count=len(devs), card=CARD)
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# --------------------------------------------------------------- phase 1
def _mixture_data(n: int, seed: int = 0):
    """An SMC-like state: centers spread over the prior's middle, queries
    resampled from them plus half a kernel sd of noise."""
    rng = np.random.default_rng(seed)
    dv = np.full(NPAR, 0.02)
    prev = rng.uniform(0.3, 0.7, (n, NPAR))
    lw = np.log(rng.dirichlet(np.ones(n)))
    par = prev[rng.integers(0, n, n)] + rng.normal(0, np.sqrt(dv / 2),
                                                   (n, NPAR))
    return par, prev, lw, dv


def _oracle(par, prev, lw, dv, rows) -> np.ndarray:
    """float64 log mixture density for the sampled query rows."""
    a = (par[rows] - prev.mean(0)) / np.sqrt(dv)
    b = (prev - prev.mean(0)) / np.sqrt(dv)
    b2 = (b * b).sum(1)
    out = []
    for s in range(0, len(rows), 50):
        aa = a[s:s + 50]
        lg = lw[None, :] - 0.5 * ((aa * aa).sum(1)[:, None] + b2[None, :]
                                  - 2.0 * aa @ b.T)
        mx = lg.max(1, keepdims=True)
        out.append(mx[:, 0] + np.log(np.exp(lg - mx).sum(1)))
    return np.concatenate(out) - 0.5 * np.sum(np.log(2 * np.pi * dv))


def phase_weights() -> None:
    import jax
    import jax.numpy as jnp

    from abcsmc_tpu.ops import weights as W

    say("weights", precision=(
        "float32: the GPU kernel's product runs as F32_F32_F32 (FMAs on "
        "the CUDA cores) and the XLA path's dot at Precision.HIGHEST, so "
        "no TF32 anywhere"))
    for n in WEIGHT_SIZES:
        par, prev, lw, dv = _mixture_data(n)
        rows = np.random.default_rng(1).choice(n, ORACLE_ROWS, replace=False)
        want = _oracle(par, prev, lw, dv, rows)
        args = [jnp.asarray(x, jnp.float32) for x in (par, prev, lw, dv)]
        paths = {
            "gpu_route": jax.jit(W.log_kernel_mixture_density),
            "xla": jax.jit(W._log_kernel_mixture_density_xla),
        }
        for name, fn in paths.items():
            t0 = time.perf_counter()
            got = np.asarray(fn(*args))
            first = time.perf_counter() - t0
            err = float(np.abs(got[rows] - want).max())
            check(np.all(np.isfinite(got)), f"weights {name} {n}: non-finite")
            check(err <= TOL_NATS,
                  f"weights {name} {n}^2: {err:.3g} nats > {TOL_NATS}")
            med, allt = timed(lambda: fn(*args))
            say("weights", path=name, queries=n, centers=n, p=NPAR,
                max_abs_err_nats=err, tol_nats=TOL_NATS, median_s=med,
                times_s=allt, first_call_s=first, card=CARD)
        del args


# --------------------------------------------------------------- phase 2
def _compare(a, b, keep: int) -> dict:
    """Survivor overlap and weight agreement of two step results."""
    ia, ib = np.asarray(a.survivor_idx), np.asarray(b.survivor_idx)
    wa = dict(zip(ia.tolist(), np.asarray(a.weights).tolist()))
    wb = dict(zip(ib.tolist(), np.asarray(b.weights).tolist()))
    common = sorted(set(wa) & set(wb))
    wmax = max(max(wa.values()), max(wb.values()))
    dw = max((abs(wa[i] - wb[i]) for i in common), default=np.inf)
    return {
        "ncomp": [int(a.ncomp_used), int(b.ncomp_used)],
        "survivor_overlap": len(common) / keep,
        "max_rel_weight_diff": float(dw / wmax),
    }


class _HostResult:
    """The host rule's survivors, weights and component count, shaped like
    the fields of a GenerationResult that :func:`_compare` reads."""

    def __init__(self, survivor_idx, weights, ncomp_used):
        self.survivor_idx = survivor_idx
        self.weights = weights
        self.ncomp_used = ncomp_used


def _host_rule(params, mets, state, keep: int, par_set) -> _HostResult:
    """The float64 host implementation in ops/ (ranking + weights) on the
    same metrics, on the CPU."""
    import jax
    import jax.numpy as jnp

    from abcsmc_tpu.ops import ranking, stats, weights

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        p64 = jnp.asarray(np.asarray(params), jnp.float64)
        m64 = jnp.asarray(np.asarray(mets), jnp.float64)
        sim_s, obs_s, ncomp = ranking.pls_scores_for_ranking(
            m64, p64, jnp.zeros(NMET), 0.5
        )
        dists = np.asarray(stats.euclidean(sim_s, obs_s))
        surv = np.argsort(dists, kind="stable")[:keep]
        prev = [jnp.asarray(np.asarray(x), jnp.float64) for x in state]
        w = np.asarray(weights.weight_predictive_prior(
            p64[surv], prev[0], prev[1], prev[2], par_set.prior_log_pdf,
        ))
    return _HostResult(surv, w, ncomp)


def phase_step() -> None:
    import jax

    n, keep = STEP_N, STEP_KEEP
    params, mets, state = bench_inputs(n, keep)
    key = jax.random.PRNGKey(0)
    dev = jax.devices()[0]

    gen = bench_generation(n, keep)
    run = lambda: gen.step_precomputed(key, params, mets, keep, n, state)  # noqa: E731
    res = run()
    ncomp = int(res.ncomp_used)
    check(ncomp > 1, f"step: ncomp_used={ncomp} on rank-structured metrics "
          "(negative = the vdv self-check fired)")
    check(bool(np.all(np.isfinite(np.asarray(res.weights)))),
          "step: non-finite weights")
    med, allt = timed(run)
    say("step", particles=n, keep=keep, ncomp_used=ncomp, median_s=med,
        times_s=allt, card=CARD)

    # memory: the compiled program beside the bytes rule's thresholds
    lowered = jax.jit(
        lambda k, p, m, s: gen.step_precomputed(k, p, m, keep, n, s)
    ).lower(key, params, mets, state)
    ma = lowered.compile().memory_analysis()
    temp = int(getattr(ma, "temp_size_in_bytes", 0))
    say("step_memory", temp_bytes=temp,
        temp_bytes_per_row=temp / n,
        rule_resident_row_bytes=gen.resident_row_bytes,
        rule_propose_row_bytes=gen.propose_row_bytes,
        argument_bytes=int(getattr(ma, "argument_size_in_bytes", 0)),
        output_bytes=int(getattr(ma, "output_size_in_bytes", 0)),
        peak_bytes_in_use=(dev.memory_stats() or {}).get("peak_bytes_in_use"),
        device_bytes_limit=gen.device_bytes,
        row_chunk_threshold_rows=gen.row_chunk_threshold,
        split_threshold_rows=gen.split_threshold)

    # chunked row passes must select exactly what the resident program does
    gen_chk = bench_generation(n, keep, row_block=1 << 17)
    res_chk = gen_chk.step_precomputed(key, params, mets, keep, n, state)
    cmp = _compare(res, res_chk, keep)
    say("step_chunked", row_block=1 << 17, **cmp,
        reason="same algebra, reduction order differs: f32 ties at the "
               "K-th distance may swap")
    check(cmp["ncomp"][0] == cmp["ncomp"][1], f"chunked ncomp {cmp}")
    check(cmp["survivor_overlap"] >= 0.999, f"chunked survivors {cmp}")
    check(cmp["max_rel_weight_diff"] <= 1e-4, f"chunked weights {cmp}")

    # the float64 host rule on the same metrics; the device's vdv window is
    # uncapped here so both run the same statistic on the same rows
    gen_full = bench_generation(n, keep, vdv_max_rows=n)
    res_full = gen_full.step_precomputed(key, params, mets, keep, n, state)
    host = _host_rule(params, mets, state, keep, gen.par_set)
    cmp = _compare(res_full, host, keep)
    say("step_vs_host_f64", **cmp,
        reason="f32 device vs f64 host: distances differ by ~1e-6 "
               "relative, which can swap near-ties at the K-th distance; "
               "weights agree to the f32 kernel's 1e-4 nats")
    check(cmp["ncomp"][0] == cmp["ncomp"][1], f"host-rule ncomp {cmp}")
    check(cmp["survivor_overlap"] >= 0.999, f"host-rule survivors {cmp}")
    check(cmp["max_rel_weight_diff"] <= 1e-3, f"host-rule weights {cmp}")


# --------------------------------------------------------------- phase 3
def _fit_config(n: int, db: str) -> tuple[dict, np.ndarray]:
    from abcsmc_tpu.models.simulators import make_linear_gaussian_simulator

    truth = np.random.default_rng(42).uniform(0.2, 0.8, NPAR)
    sim = make_linear_gaussian_simulator(NPAR, NMET)
    obs = np.asarray(sim.run_batch(truth[None, :], np.array([7]),
                                   np.array([0]))[0])
    cfg = {
        "smc_iterations": 10, "num_samples": n,
        "predictive_prior_fraction": 0.01, "pls_training_fraction": 0.5,
        "noise": "INDEPENDENT", "simulator": "linear_gaussian",
        "database_filename": db,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(NMET)
        ],
    }
    return cfg, truth


def _check_fit_db(cfg_path: str, cfg: dict, truth, label: str,
                  log: str) -> dict:
    from abcsmc_tpu.engine import AbcSmc

    n, sets = cfg["num_samples"], cfg["smc_iterations"]
    keep = round(n * cfg["predictive_prior_fraction"])
    with sqlite3.connect(cfg["database_filename"]) as con:
        rows = con.execute(
            "select smcSet, count(*), sum(status = 'D'), "
            "sum(posterior > -1) from job group by smcSet order by smcSet"
        ).fetchall()
    check(len(rows) == sets, f"{label}: {len(rows)} sets in the store")
    for s, cnt, done, post in rows:
        check(cnt == n and done == n,
              f"{label}: set {s} has {done}/{cnt} of {n} rows done")
        check(post == keep, f"{label}: set {s} has {post} posterior rows")
    # the engine rebuilds its state from the finished store (no new sets)
    abc = AbcSmc(cfg_path)
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        abc.run_device(seed=11)
    pars, w = abc.posterior()
    w = np.asarray(w) / np.sum(w)
    mean = (pars * w[:, None]).sum(0)
    sd = np.sqrt((w[:, None] * (pars - mean) ** 2).sum(0))
    z = np.abs(mean - truth) / sd
    # the truth is one draw consistent with the data; a weighted mean more
    # than 3 posterior sds away from it flags a broken fit
    check(bool(np.all(z <= 3.0)), f"{label}: posterior z-scores {z}")
    check(bool(np.all(sd < 1 / np.sqrt(12))),
          f"{label}: posterior sd {sd} not below the prior's")
    return {"sets_complete": sets, "posterior_rows_per_set": keep,
            "max_abs_err": float(np.abs(mean - truth).max()),
            "max_z": float(z.max()), "z_tol": 3.0}


def phase_fit(n: int | None = None, mesh_note: str = "1 card") -> None:
    from abcsmc_tpu.cli import main as cli_main

    n = n or FIT_N
    os.makedirs(WORK, exist_ok=True)
    db = os.path.join(WORK, f"fit_{n}.sqlite")
    cfg, truth = _fit_config(n, db)
    cfg_path = os.path.join(WORK, f"fit_{n}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    log = os.path.join(WORK, f"fit_{n}.log")
    for label in ("cold", "warm"):
        if os.path.exists(db):
            os.remove(db)
        t0 = time.perf_counter()
        with open(log, "a") as f, contextlib.redirect_stdout(f):
            rc = cli_main([cfg_path, "--device", "--seed", "11"])
        wall = time.perf_counter() - t0
        check(rc == 0, f"fit {label}: CLI exit code {rc} (log {log})")
        got = _check_fit_db(cfg_path, cfg, truth, f"fit {label}", log)
        say("fit", run=label, particles=n, sets=cfg["smc_iterations"],
            wall_s=wall, mesh=mesh_note, card=CARD, **got)
    os.remove(db)


# --------------------------------------------------------------- phase 4
def phase_bridge() -> None:
    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.models.simulators import HostBridgeSimulator
    from abcsmc_tpu.storage import MemoryStorage

    calls = []
    mix = np.random.default_rng(3).normal(size=(2, 3))

    def host_fn(params, seeds):
        calls.append(len(params))
        noise = np.stack([np.random.default_rng(int(s)).normal(0, 0.1, 3)
                          for s in seeds])
        return np.asarray(params) @ mix + noise

    truth = np.array([0.3, 0.6])
    obs = truth @ mix
    cfg = {
        "smc_iterations": 3, "num_samples": 2000,
        "predictive_prior_fraction": 0.05,
        "parameters": [
            {"name": f"q{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(2)
        ],
        "metrics": [{"name": f"y{j}", "num_type": "FLOAT",
                     "value": float(obs[j])} for j in range(3)],
    }
    abc = AbcSmc(cfg, simulator=HostBridgeSimulator(host_fn, nmet=3),
                 storage=MemoryStorage())

    def host_loop(*a, **k):
        raise PhaseError("bridge: run_device fell back to the host loop")

    abc.run = host_loop
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(WORK, "bridge.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        abc.run_device(seed=5)
    wall = time.perf_counter() - t0
    pars, w = abc.posterior()
    check(sum(calls) >= 3 * 2000,
          f"bridge: host function saw {sum(calls)} rows")
    check(bool(np.all(np.isfinite(w))), "bridge: non-finite weights")
    w = np.asarray(w) / np.sum(w)
    err = np.abs((pars * w[:, None]).sum(0) - truth)
    check(bool(np.all(err < 0.15)), f"bridge: posterior mean error {err}")
    say("bridge", host_calls=len(calls), host_rows=sum(calls),
        max_abs_err=float(err.max()), wall_s=wall, card=CARD,
        note="io_callback inside the fused step; run() never called")


# --------------------------------------------------------------- --four
def phase_four() -> None:
    import jax

    from abcsmc_tpu.parallel.mesh import particle_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 cards, JAX sees {len(devs)}")
    n, keep = FOUR_N, STEP_KEEP
    params, mets, state = bench_inputs(n, keep)
    key = jax.random.PRNGKey(0)
    out = {}
    for label, mesh in (("1card", particle_mesh(devs[:1])),
                        ("4card", particle_mesh(devs))):
        # vdv window uncapped: the statistic is then layout-invariant, so
        # both meshes must select the same components
        gen = bench_generation(n, keep, mesh=mesh, vdv_max_rows=n)
        run = lambda: gen.step_precomputed(key, params, mets, keep, n, state)  # noqa: E731,B023
        out[label] = run()
        med, allt = timed(run, reps=3)
        say("four_step", mesh=label, particles=n, keep=keep,
            ncomp_used=int(out[label].ncomp_used), median_s=med,
            times_s=allt, card=CARD)
    cmp = _compare(out["1card"], out["4card"], keep)
    say("four_step_compare", **cmp,
        reason="same inputs and key; psum order differs across meshes, so "
               "f32 near-ties at the K-th distance may swap")
    check(min(cmp["ncomp"]) > 1 and cmp["ncomp"][0] == cmp["ncomp"][1],
          f"four: ncomp {cmp}")
    check(cmp["survivor_overlap"] >= 0.999, f"four: survivors {cmp}")
    check(cmp["max_rel_weight_diff"] <= 1e-4, f"four: weights {cmp}")
    del params, mets, out
    phase_fit(n=FOUR_FIT_N, mesh_note="4 cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    from abcsmc_tpu._cache import enable_persistent_cache

    enable_persistent_cache()
    try:
        device = phase_device()
        phases = ([phase_four] if args.four else
                  [phase_weights, phase_step, phase_fit, phase_bridge])
        for ph in phases:
            t0 = time.perf_counter()
            ph()
            say(ph.__name__[6:], passed=True,
                phase_wall_s=time.perf_counter() - t0, card=CARD)
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if os.path.isdir(WORK) and not os.listdir(WORK):
            shutil.rmtree(WORK)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
