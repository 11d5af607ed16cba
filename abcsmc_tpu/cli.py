"""Command-line driver, argument-compatible with the reference example binaries
(examples/include/examples.h:12-94):

    abcsmc-tpu config.json --process
    abcsmc-tpu config.json --simulate [-n N]
    abcsmc-tpu config.json --process --simulate -n N [--all]

Extensions: --seed for reproducible runs (the reference seeds from
time(NULL) * getpid(), examples.h:63), --verbose.
"""

from __future__ import annotations

import argparse
import os
import sqlite3
import sys
import time

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.errors import AbcError


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="abcsmc-tpu",
        description="ABC-SMC with PLS particle filtering, in JAX",
    )
    ap.add_argument("config_file")
    ap.add_argument("--process", action="store_true", dest="process_db")
    ap.add_argument("--simulate", action="store_true", dest="simulate_db")
    ap.add_argument("-n", type=int, default=1, dest="buffer_size",
                    help="simulations per database write")
    ap.add_argument("--all", action="store_true", dest="do_all")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument(
        "--device", action="store_true",
        help="run the full SMC loop on-device (fused sharded generations); "
             "falls back to the host engine when not applicable",
    )
    ap.add_argument(
        "--serial", type=int, default=-1,
        help="re-simulate the particle with this serial "
             "(simulate_particle_by_serial parity)",
    )
    ap.add_argument(
        "--posterior", type=int, default=-1,
        help="simulate the particle with this posterior rank in the latest "
             "ranked set (simulate_particle_by_posterior_idx parity)",
    )
    ap.add_argument(
        "--profile-dir", default="",
        help="write a jax profiler trace of the run to this directory",
    )
    ap.add_argument(
        "--workers", type=int, default=1,
        help="run external-executable simulations through the native "
             "parallel worker pool with this many processes",
    )
    ap.add_argument(
        "--vis", default="", metavar="PREFIX",
        help="after the run (or standalone, with no action flags), write "
             "posterior-violin and pairs-panel plots of the config's "
             "database to PREFIX_posteriors.png / PREFIX_pairs.png — the "
             "reference's offline vis/abc_plots.R + abc.pairs.ex.R "
             "workflow, built in",
    )
    return ap


def _simulate(abc, args, n):
    if (
        args.workers > 1
        and abc.config.executable
        and abc.config.database_filename
    ):
        from abcsmc_tpu.native import run_workers

        run_workers(
            abc.config.database_filename, abc.config.executable,
            n_jobs=n, n_workers=args.workers, verbose=args.verbose,
        )
    else:
        abc.simulate_next_particles(n)


def _write_plots(abc, prefix: str) -> None:
    """Render the two offline-analysis plots the reference ships as R
    scripts (vis/abc_plots.R, vis/abc.pairs.ex.R) from the run database."""
    db = abc.config.database_filename
    if not db:
        raise AbcError("--vis requires a database_filename in the config")
    if not os.path.exists(db):
        raise AbcError(f"--vis: database not found: {db}")
    from abcsmc_tpu import vis

    for path in (
        vis.plot_posteriors(db, f"{prefix}_posteriors.png"),
        vis.plot_pairs(db, f"{prefix}_pairs.png"),
    ):
        sys.stderr.write(f"{path}\n")


def _host_only(args) -> bool:
    """True when this invocation never needs the accelerator: a pure
    ``--simulate`` worker whose simulator is an external executable or a
    shared library. Such workers are started in any number against one
    database, and each JAX process that touched the GPU would reserve most
    of its memory."""
    if args.process_db or args.device or args.vis or not args.simulate_db:
        return False
    from abcsmc_tpu.config import parse_config

    try:
        cfg = parse_config(args.config_file)
    except AbcError:
        return False          # AbcSmc() below reports the config error
    return bool(cfg.executable or cfg.shared) and not cfg.simulator_name


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    if _host_only(args):
        import jax

        jax.config.update("jax_platforms", "cpu")
    from abcsmc_tpu._cache import enable_persistent_cache
    enable_persistent_cache()
    seed = args.seed
    if seed is None:
        # reference: time(NULL) * getpid() (examples.h:63)
        seed = (int(time.time()) * os.getpid()) & 0x7FFFFFFF

    try:
        abc = AbcSmc(args.config_file)
        if args.profile_dir:
            import jax
            try:
                jax.profiler.start_trace(args.profile_dir)
            except Exception as e:
                sys.stderr.write(f"profiler unavailable: {e}\n")
                args.profile_dir = ""
        if args.serial > -1:
            abc.simulate_particle_by_serial(args.serial)
        elif args.posterior > -1:
            abc.simulate_particle_by_posterior_idx(args.posterior)
        elif args.device:
            abc.run_device(seed, verbose=args.verbose)
        elif args.do_all:
            # examples.h:76-93: per set, process + simulate the whole set,
            # then one final process pass
            for t in range(abc.config.num_smc_sets):
                if args.process_db:
                    abc.process_database(seed + t, args.verbose)
                if args.simulate_db:
                    _simulate(abc, args, -1)
            if args.process_db:
                abc.process_database(seed + abc.config.num_smc_sets, args.verbose)
        else:
            if args.process_db:
                abc.process_database(seed, args.verbose)
            if args.simulate_db:
                _simulate(abc, args, args.buffer_size)
        if args.vis and abc._proc0():
            _write_plots(abc, args.vis)
    except AbcError as e:
        sys.stderr.write(f"{e}\n")
        return -(e.code or 1) if e.code and e.code < 0 else (e.code or 1)
    except sqlite3.Error as e:
        # operational sqlite failures (disk I/O, corruption appearing
        # mid-run, lock timeout past busy_timeout) - message, not traceback
        sys.stderr.write(f"database error: {e}\n")
        return 1
    finally:
        if args.profile_dir:
            import jax
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
    if args.verbose and abc.timings:
        for row in abc.timings:
            sys.stderr.write(f"[timing] {row}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
