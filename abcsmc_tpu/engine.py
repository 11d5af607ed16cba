"""The SMC orchestrator.

Mirrors the public surface of class AbcSmc (include/AbcSmc/AbcSmc.h:37-127):
``parse_config`` -> constructor, ``build_database``, ``process_database``,
``simulate_next_particles`` (+ by-serial / by-posterior-idx variants), and the
convenience full-loop ``run``. The SQL-string-building internals of the
reference dissolve into array ops over a columnar run store; all SMC math runs
as jitted JAX (sharded over a device mesh when one is provided).
"""

from __future__ import annotations

import collections
import json
from contextlib import contextmanager
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from abcsmc_tpu import reports
from abcsmc_tpu.config import FilterType, NoiseType, SmcConfig, parse_config
from abcsmc_tpu.errors import AbcError, SimulatorError, StorageError
from abcsmc_tpu.models.metrics import Metric, observed_vector
from abcsmc_tpu.models.parameters import ParameterSet
from abcsmc_tpu.models.simulators import Simulator, resolve_simulator
from abcsmc_tpu.models.transforms import ParameterTransform
from abcsmc_tpu.ops import ranking, resample, stats, weights
from abcsmc_tpu.storage import MemoryStorage, SQLiteStorage, Storage

# host-side stand-in for a GenerationResult whose O(N) device buffers were
# eagerly fetched and freed (the HBM-bound split-propose path); carries
# exactly the fields the mirror phase reads
_SlimResult = collections.namedtuple(
    "_SlimResult",
    ["survivor_idx", "weights", "doubled_variance", "ncomp_used"],
)


class AbcSmc:
    """One ABC-SMC-PLS analysis.

    Parameters
    ----------
    config:
        An :class:`SmcConfig` (or path / dict accepted by :func:`parse_config`).
    simulator:
        Optional explicit simulator; otherwise bound from the config
        (builtin name / shared object / executable), mirroring
        src/AbcSmc.cpp:402-406.
    storage:
        Optional run store; defaults to SQLite at ``config.database_filename``
        (reference behavior) or an in-memory store when no filename is set.
    """

    def __init__(
        self,
        config: SmcConfig | str | dict,
        simulator: Simulator | None = None,
        storage: Storage | None = None,
    ):
        if not isinstance(config, SmcConfig):
            config = parse_config(config)
        self.config = config
        self.par_set = ParameterSet.from_specs(config.parameters)
        self.transform = ParameterTransform(config.parameters)
        self.metrics = [Metric.from_spec(m) for m in config.metrics]
        self.obs = observed_vector(self.metrics)
        self.simulator = resolve_simulator(config, simulator)

        if storage is not None:
            self.storage = storage
        elif config.database_filename:
            self.storage = SQLiteStorage(config.database_filename)
        else:
            self.storage = MemoryStorage()
        if hasattr(self.storage, "meta") and self.storage.meta is None:
            from abcsmc_tpu import __version__

            self.storage.meta = {
                "framework": f"abcsmc-tpu {__version__}",
                "created": int(time.time()),
                "config": json.dumps(config.raw) if config.raw else "",
            }

        # POSTERIOR parameters source their values from a previous run's DB
        # (src/AbcSmc.cpp:385-396)
        self._posterior_matrix = None
        if self.par_set.posterior_idx:
            post_names = [
                self.par_set.params[i].short_name
                for i in self.par_set.posterior_idx
            ]
            src = SQLiteStorage(config.posterior_database_filename)
            self._posterior_matrix = src.read_posterior_matrix(post_names)
            src.close()

        #: per-call stage timings (the reference only records per-job
        #: startTime/duration in the job table; kept, plus these)
        self.timings: list[dict] = []

        # per-set state, exactly the reference's members (AbcSmc.h:166-174)
        self._particle_parameters: list[np.ndarray] = []
        self._particle_metrics: list[np.ndarray] = []
        self._predictive_prior: list[np.ndarray] = []
        self._weights: list[np.ndarray] = []
        self._doubled_variance: list[np.ndarray] = []

    # ------------------------------------------------------------------ direct
    @classmethod
    def direct(
        cls,
        parameters: list[dict],
        metrics: list[dict],
        num_samples,
        smc_iterations: int | None = None,
        predictive_prior_fraction=None,
        predictive_prior_size=None,
        pls_training_fraction: float = 0.5,
        noise: str = "INDEPENDENT",
        database_filename: str = "",
        simulator: Simulator | None = None,
        storage: Storage | None = None,
        **extra,
    ) -> "AbcSmc":
        """Programmatic construction without a config file - the reference's
        'direct' example surface (examples/direct/main.cpp: add_next_parameter
        / add_next_metric / set_smc_iterations / set_num_samples / ...).

        ``parameters`` and ``metrics`` take the same dicts as the JSON schema.
        """
        cfg: dict = {
            "parameters": parameters,
            "metrics": metrics,
            "num_samples": num_samples,
            "pls_training_fraction": pls_training_fraction,
            "noise": noise,
            **extra,
        }
        if smc_iterations is not None:
            cfg["smc_iterations"] = smc_iterations
        if predictive_prior_fraction is not None:
            cfg["predictive_prior_fraction"] = predictive_prior_fraction
        if predictive_prior_size is not None:
            cfg["predictive_prior_size"] = predictive_prior_size
        if database_filename:
            cfg["database_filename"] = database_filename
        return cls(cfg, simulator=simulator, storage=storage)

    # ------------------------------------------------------------------ utils
    @staticmethod
    def _proc0() -> bool:
        """True on the coordinator process (process_index 0), which is the
        single writer of all deterministic-replicated store mutations on a
        multi-process (jax.distributed) mesh. The reference's analog is one
        durable store shared by many OS processes (src/AbcSmc.cpp:877-965);
        there the writes are *disjoint claims* arbitrated by EXCLUSIVE
        transactions, but the device path's writes are REPLICATED (every
        process computes identical generations), so without this gate every
        process of a mesh would race to mirror the same rows. Single-process
        sessions (jax.distributed never initialized) are always process 0."""
        return jax.process_index() == 0

    def _store_writer(self) -> bool:
        """True when THIS process performs the engine's replicated store
        mutations: process 0 for shared stores, every process for
        process-private ones (each then holds its own identical copy)."""
        return self._proc0() or not getattr(self.storage, "shared", True)

    def _require_single_process_for_host_fallback(self, why: str) -> None:
        """run_device falls back to the host engine (``run``) for states or
        configurations the device path doesn't cover - but ``run`` has no
        process gating or barriers: on a multi-process (jax.distributed)
        mesh with a SHARED store, every process would drive the host brain
        against the same database at once, racing the writer's uncommitted
        enqueues (spurious incomplete-set errors, doubled rows). Refuse
        loudly instead of silently degrading. Process-private stores are
        fine: each process then runs an independent identical host fit."""
        if jax.process_count() > 1 and getattr(self.storage, "shared", True):
            raise AbcError(
                f"run_device: {why}, which requires the host engine - but "
                "the host engine cannot run on a multi-process mesh against "
                "a shared store (no single-writer gating). Run it as one "
                "process, or give each process a private store.",
            )

    @staticmethod
    def _mesh_sync():
        """Barrier across all processes of a multi-process mesh: returns
        after every process reached it, so a store write by process 0
        before the barrier is visible to every process's read after it
        (the shared SQLite file is the cross-process medium, exactly the
        reference's deployment model). No-op single-process."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("abcsmc_tpu.engine")

    @staticmethod
    def _fetch_global(tree, mesh):
        """device_get that works on multi-process meshes: sharded leaves of
        a global mesh are not fully addressable per process, so replicate
        them first with a jitted identity (an all-gather riding the mesh
        interconnect), then fetch. Single-process: plain device_get.

        The replication is element-at-a-time over the top level of ``tree``
        (the mirror phase passes one entry per SMC set), each replicated
        copy dying before the next is made: peak extra HBM is one set's
        buffers, not the whole run history at once. Single-process fetches
        are untouched — they batch every transfer into one round-trip."""
        if jax.process_count() == 1:
            return jax.device_get(tree)
        ident = AbcSmc._replicate_ident(mesh)

        def fetch_one(el):
            replicated = ident(el)
            host = jax.device_get(replicated)
            del replicated
            return host

        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
            return type(tree)(fetch_one(el) for el in tree)
        return fetch_one(tree)

    @staticmethod
    def _replicate_ident(mesh):
        """Cached jitted replicate-identity per mesh (parallel/mesh.py)."""
        from abcsmc_tpu.parallel.mesh import replicate_ident

        return replicate_ident(mesh)

    @property
    def npar(self) -> int:
        return self.config.npar

    @property
    def nmet(self) -> int:
        return self.config.nmet

    def _key(self, seed: int):
        return jax.random.PRNGKey(seed & 0xFFFFFFFF)

    def _draw_seeds(self, key, n: int) -> np.ndarray:
        """Per-particle stored RNG seeds (replayability parity with the seed
        blob, src/AbcSmc.cpp:535-537)."""
        return np.asarray(
            jax.random.randint(key, (n,), 0, np.iinfo(np.int32).max),
            np.uint64,
        )

    # ------------------------------------------------------------ build (gen 0)
    def build_database(self, seed: int = 0, verbose: bool = False) -> bool:
        """Create the store + enqueue generation 0 if it doesn't exist
        (src/AbcSmc.cpp:810-874). Returns True if it created it.

        Multi-process meshes: only the store-writer process mutates the
        shared store; the others return the SAME decision (control-flow
        lockstep) without writing - callers that need the written rows
        barrier via :meth:`_mesh_sync` before re-reading."""
        repairing = False
        if self.storage.exists():
            if not self.storage.is_empty():
                return False
            # tables exist but no generation was ever enqueued: table
            # creation and the generation-0 insert are separate
            # transactions, so a crash between them leaves this state.
            # Repair by enqueueing generation 0 into the existing tables
            # (without this, process_database would index into empty
            # weight/survivor state and crash on resume).
            repairing = True
            # before inserting into a schema this engine did not create,
            # verify it actually matches the config - an equal-count schema
            # with different column names would otherwise be silently
            # populated under the wrong columns, and a count mismatch would
            # surface as a raw sqlite binding error
            want_par = list(self.par_set.short_names())
            want_met = [m.short_name for m in self.metrics]
            have_par = list(getattr(self.storage, "par_names", want_par))
            have_met = list(getattr(self.storage, "met_names", want_met))
            if have_par != want_par or have_met != want_met:
                raise StorageError(
                    "existing (empty) database schema does not match the "
                    f"configuration: par columns {have_par} vs config "
                    f"{want_par}; met columns {have_met} vs config "
                    f"{want_met}",
                    code=1,
                )
            if not self._store_writer():
                return True  # the writer repairs; same decision, no write
        else:
            if not self._store_writer():
                return True  # the writer creates; same decision, no write
            self.storage.create(
                self.par_set.short_names(),
                [m.short_name for m in self.metrics],
                self.transform.has_any,
            )
        key = self._key(seed)
        k_par, k_seed = jax.random.split(key)
        n = self.config.smc_size_at(0)
        samples, post_ranks = self.par_set.sample_priors(
            k_par, n, self._posterior_matrix
        )
        params = np.asarray(samples, np.float64)
        seeds = self._draw_seeds(k_seed, n)
        upars = (
            np.asarray(self.transform.to_model_space(samples), np.float64)
            if self.transform.has_any else None
        )
        ranks = (
            np.asarray(post_ranks, np.int64)
            if (self.config.retain_posterior_rank and len(post_ranks)) else None
        )
        serials = self.storage.insert_generation(
            0, params, seeds, upars, ranks, if_empty=repairing
        )
        if serials is None:
            # another worker repaired the crash window between our emptiness
            # check and the insert transaction; behave as if the database
            # already existed (the caller then reads it like any other store)
            return False
        return True

    # ------------------------------------------------------------------ process
    def process_database(self, seed: int = 0, verbose: bool = False) -> bool:
        """The SMC brain (src/AbcSmc.cpp:452-559): build if absent; otherwise
        read complete sets, filter/rank any unfiltered set, compute weights,
        report, and enqueue the next generation if more sets are needed."""
        # reset up front so an aborted pass (e.g. incomplete set) can never
        # leave a STALE True from a previous converged run on this object -
        # run_device's loop control reads this attribute
        self._stopped_early = False
        if self.build_database(seed, verbose):
            return True

        self._particle_parameters.clear()
        self._particle_metrics.clear()
        self._weights.clear()
        self._predictive_prior.clear()
        self._doubled_variance.clear()

        t0 = time.perf_counter()
        gens = self._read_smc_sets()
        t_read = time.perf_counter() - t0
        if gens is None:
            return False
        next_set = len(gens)
        last_set = next_set - 1

        if self._proc0():
            reports.report_convergence_data(self, last_set)
            sys.stderr.write("\n\n")

        t0 = time.perf_counter()
        self._stopped_early = (
            self.config.num_smc_sets > next_set and self._converged()
        )
        if self._stopped_early:
            # convergence-based early stop (extension): don't enqueue the
            # next generation at all, so no dangling 'Q' set lands in the
            # store and any --all loop or worker fleet drains naturally
            pass
        elif self.config.num_smc_sets > next_set and not self._store_writer():
            # non-writer process of a multi-process mesh: the writer
            # proposes + enqueues; callers barrier (_mesh_sync) and re-read
            pass
        elif self.config.num_smc_sets > next_set:
            key = self._key(seed)
            k_noise, k_seed = jax.random.split(key)
            n = self.config.smc_size_at(next_set)
            surv = self._predictive_prior[last_set]
            prev_params = jnp.asarray(self._particle_parameters[last_set][surv])
            prev_w = jnp.asarray(self._weights[last_set])

            if self.config.noise == NoiseType.MULTIVARIATE:
                L = resample.setup_mvn_sampler(prev_params)
                noised = resample.sample_mvn_predictive_priors(
                    k_noise, n, prev_w, prev_params, self.par_set, L,
                    self.config.max_retries, self.config.resample_method,
                )
                if verbose:
                    sys.stderr.write(
                        "Populating next set using MULTIVARIATE noising of "
                        "parameters.\n"
                    )
            else:
                noised = resample.sample_predictive_priors(
                    k_noise, n, prev_w, prev_params, self.par_set,
                    jnp.asarray(self._doubled_variance[last_set]),
                    self.config.max_retries, self.config.resample_method,
                )
                if verbose:
                    sys.stderr.write(
                        "Populating next set using INDEPENDENT noising of "
                        "parameters.\n"
                    )

            params = np.asarray(noised, np.float64)
            seeds = self._draw_seeds(k_seed, n)
            upars = (
                np.asarray(self.transform.to_model_space(noised), np.float64)
                if self.transform.has_any else None
            )
            self.storage.insert_generation(next_set, params, seeds, upars)
        elif self._proc0():
            sys.stderr.write(
                f"Database already contains {self.config.num_smc_sets} "
                "complete sets.\n"
            )
        self.timings.append({
            "op": "process", "sets": next_set,
            "read_rank_weight_s": round(t_read, 4),
            "propose_s": round(time.perf_counter() - t0, 4),
        })
        return True

    def _read_smc_sets(self):
        """read_SMC_sets_from_database parity (src/AbcSmc.cpp:562-679)."""
        gens = self.storage.read_generations()
        for gen in gens:
            t = gen.set_num
            if not gen.complete:
                sys.stderr.write(
                    "ERROR: Failed to read SMC set from database because not "
                    f"all particles are complete in set {t}\n"
                )
                return None
            if gen.size != self.config.smc_size_at(t):
                raise StorageError(
                    f"Set {t} in configuration file has size "
                    f"{self.config.smc_size_at(t)} vs size {gen.size} in "
                    "database.",
                    code=1,
                )
            self._particle_parameters.append(gen.params)
            self._particle_metrics.append(gen.metrics)

            if self.config.projection_mode:
                # projection: no filtering/weighting - the sweep itself is the
                # product; retained ranks (if any) came from the source
                # posterior (src/AbcSmc.cpp:341, 849-853)
                if gen.has_posterior:
                    self._predictive_prior.append(
                        gen.predictive_prior_indices()
                    )
                else:
                    self._predictive_prior.append(np.arange(gen.size))
                self._doubled_variance.append(
                    np.asarray(stats.doubled_variance(
                        jnp.asarray(gen.params)
                    ))
                )
                self._weights.append(
                    np.full(len(self._predictive_prior[-1]),
                            1.0 / len(self._predictive_prior[-1]))
                )
                continue

            self._ingest_complete_set(gen, t)
        return gens

    def _ingest_complete_set(self, gen, t: int):
        """Fold one complete fitting-mode set into in-memory state: survivors
        (ranking + rank writeback if the set is unranked) and importance
        weights. Shared by :meth:`_read_smc_sets` and device-path resume.
        Expects ``self._particle_parameters``/``_metrics`` already appended."""
        if gen.has_posterior:
            self._predictive_prior.append(gen.predictive_prior_indices())
        else:
            order = self._rank_particles(gen.metrics, gen.params)
            keep = self.config.pred_prior_size_at(t)
            surv = np.asarray(order)[:keep]
            self._predictive_prior.append(surv)
            if self._store_writer():
                self.storage.write_posterior_ranks(
                    gen.serials[surv], np.arange(keep)
                )
            if self._proc0():
                reports.filtering_report(
                    self, t, gen.params[surv], gen.metrics[surv]
                )
        self._calculate_predictive_prior_weights(t)

    def _rank_particles(self, mets: np.ndarray, pars: np.ndarray) -> np.ndarray:
        if self.config.filter == FilterType.PLS:
            order, _ = ranking.ranking_pls(
                jnp.asarray(mets), jnp.asarray(pars), jnp.asarray(self.obs),
                self.config.pls_training_fraction,
                box_cox=self.config.box_cox,
                optimal_method=self.config.pls_optimal_method,
            )
        else:
            order, _ = ranking.ranking_simple(
                jnp.asarray(mets), jnp.asarray(self.obs)
            )
        return np.asarray(order)

    def _calculate_predictive_prior_weights(self, set_num: int):
        """src/AbcSmc.cpp:1041-1066."""
        assert len(self._doubled_variance) == set_num
        surv = self._predictive_prior[set_num]
        pars = self._particle_parameters[set_num][surv]
        self._doubled_variance.append(
            np.asarray(stats.doubled_variance(jnp.asarray(pars)))
        )
        if set_num == 0:
            self._weights.append(
                np.asarray(weights.uniform_weights(len(surv), jnp.float64
                           if jax.config.jax_enable_x64 else jnp.float32))
            )
        else:
            prev_surv = self._predictive_prior[set_num - 1]
            prev_pars = self._particle_parameters[set_num - 1][prev_surv]
            w = weights.weight_predictive_prior(
                jnp.asarray(pars),
                jnp.asarray(prev_pars),
                jnp.asarray(self._weights[set_num - 1]),
                jnp.asarray(self._doubled_variance[set_num - 1]),
                self.par_set.prior_log_pdf,
            )
            self._weights.append(np.asarray(w))

    # ------------------------------------------------------------------ simulate
    def simulate_next_particles(
        self, n: int = 1, serial_req: int = -1, posterior_req: int = -1
    ) -> bool:
        """Claim-and-run workers (src/AbcSmc.cpp:967-1039): claim up to n queued
        or stuck-running jobs (ordered by status then attempts), run the
        simulator, write back metrics guarded by job status."""
        assert n == 1 or (serial_req == -1 and posterior_req == -1)
        assert serial_req == -1 or posterior_req == -1
        if self.simulator is None:
            raise SimulatorError(
                "simulator not set (no executable/shared/builtin binding)",
                code=-211,
            )
        t0 = time.perf_counter()
        claimed = self.storage.claim_jobs(n, serial_req, posterior_req)
        t_claim = time.perf_counter() - t0
        if claimed.serials.size == 0:
            return True
        start = time.time()
        t0 = time.perf_counter()
        mets = self.simulator.run_batch(
            claimed.params, claimed.seeds, claimed.serials
        )
        t_sim = time.perf_counter() - t0
        if mets.shape[1] != self.nmet:
            # reference exits -211 (src/AbcSmc.cpp:683-687, 1014)
            raise SimulatorError(
                "simulator function returned the wrong number of metrics: "
                f"expected {self.nmet}, received {mets.shape[1]}",
                code=-211,
            )
        if not np.isfinite(mets).all():
            # non-finite metric bandaid (src/AbcMPI.cpp:81-94: overwrite the
            # offending row's metrics with DBL_MIN)
            bad = ~np.isfinite(mets).all(axis=1)
            sys.stderr.write(
                f"WARNING: {int(bad.sum())} particle(s) returned non-finite "
                "metrics; overwriting with DBL_MIN\n"
            )
            mets[bad] = np.finfo(np.float64).tiny
        nrun = len(claimed.serials)
        t0 = time.perf_counter()
        self.storage.write_results(
            claimed.serials,
            mets,
            np.full(nrun, int(start)),
            np.full(nrun, t_sim / max(nrun, 1)),
        )
        self.timings.append({
            "op": "simulate", "n": nrun, "claim_s": round(t_claim, 4),
            "sim_s": round(t_sim, 4),
            "writeback_s": round(time.perf_counter() - t0, 4),
        })
        return True

    def simulate_particle_by_serial(self, serial_req: int) -> bool:
        return self.simulate_next_particles(1, serial_req, -1)

    def simulate_particle_by_posterior_idx(self, posterior_req: int) -> bool:
        return self.simulate_next_particles(1, -1, posterior_req)

    # ------------------------------------------------------------------ full loop
    def _nrmse_converged(self, survivor_metrics, set_num: int) -> bool:
        """Early-stopping rule (extension): NRMSE of a posterior's metric
        means vs observed below config.nrmse_tolerance."""
        tol = self.config.nrmse_tolerance
        if not tol:
            return False
        val = float(stats.nrmse(np.asarray(survivor_metrics), self.obs))
        if val < tol:
            sys.stderr.write(
                f"Converged: NRMSE {val:.6g} < tolerance {tol} after set "
                f"{set_num}; stopping early.\n"
            )
            return True
        return False

    def _converged(self) -> bool:
        if not self.config.nrmse_tolerance or not self._predictive_prior:
            return False
        t = len(self._predictive_prior) - 1
        surv = self._predictive_prior[t]
        return self._nrmse_converged(self._particle_metrics[t][surv], t)

    def run(self, seed: int = 0, verbose: bool = False):
        """The --all loop (examples/include/examples.h:57-94): for each SMC set,
        process then simulate the whole set; one final process pass extracts the
        last posterior. Stops early if config.nrmse_tolerance is reached.

        Multi-process deployments use either (a) the reference's pattern -
        independent `--simulate` worker PROCESSES against one shared store,
        each a plain single-process session (claims arbitrated by EXCLUSIVE
        transactions) - or (b) :meth:`run_device` on a jax.distributed mesh
        (single-writer, barrier-published; tests/test_multihost.py). Calling
        THIS loop from multiple processes of one jax.distributed session is
        not a supported pattern: it has no cross-process barriers, so a
        non-coordinator process can observe half-written brain state (and
        its own brain passes are write-gated to process 0)."""
        for t in range(self.config.num_smc_sets):
            self.process_database(seed + t, verbose)
            if getattr(self, "_stopped_early", False):
                return self
            self.simulate_next_particles(n=-1)
        self.process_database(seed + self.config.num_smc_sets, verbose)
        return self

    # ------------------------------------------------------------- device path
    def run_device(
        self, seed: int = 0, mesh=None, verbose: bool = False,
        mirror_store: bool = True,
    ):
        """Fully on-device SMC run (device simulators): every generation is
        one fused, mesh-sharded XLA program (abcsmc_tpu.parallel.generation);
        results are mirrored into the run store afterwards so the database is
        indistinguishable from a host run (checkpoint/durability/R-vis parity).

        Populations of any size run (tail pad-and-mask squares them over the
        mesh). An existing store resumes from wherever it stopped - mid-set
        included - matching the reference's crash-anywhere resume
        (src/AbcSmc.cpp:452-479, set-completeness gating at :571-592).

        Fresh runs with uniform (n, keep) across sets execute the WHOLE
        chain as one jitted program (run_scan with full history) when the
        stacked-population memory bill is modest, which removes the per-set
        launch and fetch cost. The key-split chain is identical
        to the sequential loop (bit-equal on CPU, pinned by test); on an
        accelerator the differently-fused program may differ in last-ulp f32 rounding,
        which can flip near-threshold vdv component counts — statistically
        equivalent, and each path is individually deterministic.
        Projection sweeps (PSEUDO/POSTERIOR) run through the sharded sweep
        path. Falls back to :meth:`run` only for host-only simulators.
        """
        from abcsmc_tpu.models.simulators import (
            DeviceSimulator,
        )
        from abcsmc_tpu.parallel.generation import ShardedGeneration
        from abcsmc_tpu.parallel.mesh import fetch_rows_global, particle_mesh

        cfg = self.config
        if mesh is None:
            mesh = particle_mesh()
        if not isinstance(self.simulator, DeviceSimulator):
            self._require_single_process_for_host_fallback(
                "configuration not device-runnable"
            )
            if verbose:
                sys.stderr.write(
                    "run_device: configuration not device-runnable, "
                    "falling back to host engine\n"
                )
            return self.run(seed, verbose)
        if (
            cfg.projection_mode
            or self.par_set.pseudo_idx
            or self.par_set.posterior_idx
        ):
            return self._run_device_projection(seed, mesh, verbose)

        # ---- resume: rebuild state from whatever the store already holds ----
        self._particle_parameters.clear()
        self._particle_metrics.clear()
        self._weights.clear()
        self._predictive_prior.clear()
        self._doubled_variance.clear()
        pending = None      # trailing not-yet-complete set, if any
        t0 = 0              # first set the device loop will run
        if self.storage.exists():
            gens = self.storage.read_generations()
            for g in gens:
                if g.size != cfg.smc_size_at(g.set_num):
                    raise StorageError(
                        f"Set {g.set_num} in configuration file has size "
                        f"{cfg.smc_size_at(g.set_num)} vs size {g.size} in "
                        "database.",
                        code=1,
                    )
            n_complete = 0
            while n_complete < len(gens) and gens[n_complete].complete:
                n_complete += 1
            if len(gens) - n_complete > 1:
                # more than one incomplete set: not a state this engine (or
                # the reference) produces; let the host path report it
                self._require_single_process_for_host_fallback(
                    "store holds more than one incomplete set"
                )
                return self.run(seed, verbose)
            if n_complete == len(gens):
                # store ended exactly at a set boundary: the host brain
                # ingests state, reports, honors early stopping, and enqueues
                # the next set (or declares the run finished). Only the
                # STORE WRITER runs the brain on a shared store: a
                # non-writer's concurrent process_database could race the
                # writer's final enqueue commit and read the half-advanced
                # store (observing the fresh 'Q' set as a spurious
                # incomplete-set error). The others barrier, take the
                # writer's stop decision by broadcast, and rebuild identical
                # host state from the now rank-stamped store below.
                with self._writer_guard("the boundary-resume brain pass"):
                    if self._store_writer():
                        self.process_database(seed, verbose)
                self._mesh_sync()  # writer's enqueue/ranks visible to all
                stopped = self._broadcast_flag(
                    bool(getattr(self, "_stopped_early", False))
                )
                with self._writer_guard("the boundary-resume state rebuild"):
                    gens = self.storage.read_generations()
                    if not self._store_writer():
                        # non-writer of a shared store: rebuild the host
                        # state the writer's brain holds (same math; ranks
                        # read back from the store the writer just stamped)
                        # - including before the early returns, so
                        # posterior()/reports on this process see the
                        # finished run too
                        done = gens if gens[-1].complete else gens[:-1]
                        for t, g in enumerate(done):
                            self._particle_parameters.append(g.params)
                            self._particle_metrics.append(g.metrics)
                            self._ingest_complete_set(g, t)
                if stopped:
                    return self
                if gens[-1].complete:
                    return self       # all requested sets already complete
            else:
                for t, g in enumerate(gens[:n_complete]):
                    self._particle_parameters.append(g.params)
                    self._particle_metrics.append(g.metrics)
                    self._ingest_complete_set(g, t)
            pending = gens[-1]
            t0 = len(gens) - 1

        gen = ShardedGeneration(
            self.par_set,
            self.transform,
            self.simulator,
            self.obs,
            mesh=mesh,
            filter_type=cfg.filter,
            noise_type=cfg.noise,
            training_fraction=cfg.pls_training_fraction,
            max_retries=cfg.max_retries,
            pls_optimal_method=cfg.pls_optimal_method,
            resample_method=cfg.resample_method,
            box_cox=cfg.box_cox,
            row_block=cfg.row_block,
            propose_split=cfg.propose_split,
            topk_two_stage=cfg.topk_two_stage,
            dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32,
        )

        key = self._key(seed)

        # ---- fresh constant-shape runs: the whole chain as ONE program ----
        # At small populations each set's launch and fetch, not compute,
        # dominate; run_scan collapses them into a single launch. Only for fresh runs (no resume state),
        # uniform (n, keep) across sets, and a bounded full-history HBM
        # bill (the stacked [G, N, P+M+1] population copy). NRMSE-tolerance
        # runs stay fused: the mirror phase applies the convergence cut
        # post-hoc (see the mirror section below).
        n_sets = cfg.num_smc_sets
        sizes_list = [cfg.smc_size_at(t) for t in range(n_sets)]
        keeps_list = [cfg.pred_prior_size_at(t) for t in range(n_sets)]
        sizes, keeps = set(sizes_list), set(keeps_list)
        hist_bytes = sum(
            gen._padded(n_t)
            * (self.par_set.npar + len(self.metrics) + 1)
            * jnp.dtype(gen.dtype).itemsize
            for n_t in sizes_list
        )
        any_split = any(
            gen.split_propose_active(
                sizes_list[t],
                sizes_list[t + 1] if t + 1 < n_sets else 0,
            )
            for t in range(n_sets)
        )
        # NRMSE-tolerance runs stay fused: every set is computed, and the
        # mirror below truncates at the first converged set - the exact rows
        # the sequential loop (which stops dispatching there) would store.
        # The over-computed tail sets are the price of one dispatch; in the
        # dispatch-latency-bound regime (small populations) that trade is the
        # whole point of the fused paths.
        fused_ok = (
            pending is None and t0 == 0
            and cfg.device_dispatch != "sequential"
            and (
                cfg.device_dispatch == "fused"
                or hist_bytes <= 256 * 2**20
            )
            # HBM-bound (or force-split) runs need the sequential loop's
            # rank -> mirror -> free -> propose ordering
            and not any_split
        )
        use_scan = fused_ok and len(sizes) == 1 and len(keeps) == 1
        # varying set sizes (the reference quick-start's [300, 500, 500,
        # 750, 1000...] schedule, examples/reference.json:2-4): bucketed
        # sub-scans collapse same-shape runs into single dispatches
        # (ShardedGeneration.run_chain) - the per-set launch cost falls from
        # one launch per set to one per size transition
        use_chain = fused_ok and not use_scan

        pending_mets = None
        if pending is not None:
            # resume the pending population from params + stored per-particle
            # seeds. Rows already 'D' are ranked from their STORED metrics:
            # they may have been produced by a different backend/dtype (host
            # f64 store resumed on an f32 device), and the posterior ranks
            # written must agree with what --process would compute from the
            # durable data (the reference ranking always reads the DB,
            # src/AbcSmc.cpp:596-661). Only the not-yet-done rows are
            # (re)simulated, on device, from their stored seeds.
            params = jnp.asarray(pending.params, gen.dtype)
            seeds = jnp.asarray(pending.seeds.astype(np.uint32))
            pending_serials = pending.serials
            if np.any(pending.statuses == "D"):
                from abcsmc_tpu.parallel.generation import sharded_simulate

                # simulate ONLY the not-yet-done rows (their indices are
                # host-side concrete, so compaction is a plain gather): a
                # 99%-complete set resumes with 1% of the simulation work
                todo = np.nonzero(pending.statuses != "D")[0]
                merged = np.array(pending.metrics, np.float64)
                if todo.size:
                    upars = self.transform.to_model_space(params).astype(
                        gen.dtype
                    )
                    merged[todo] = sharded_simulate(
                        self.simulator, mesh, upars[todo], seeds[todo],
                        todo.size,
                    )
                pending_mets = jnp.asarray(merged, gen.dtype)
        else:
            if not (use_scan or use_chain):
                # run_scan / run_chain perform this exact split + init
                # themselves, so the fast paths must leave the key
                # unconsumed (chain parity)
                key, k0 = jax.random.split(key)
                params, seeds = gen.init_population(k0, cfg.smc_size_at(0))
            pending_serials = None
        if t0 > 0:
            # proposal state from the last ingested set
            surv = self._predictive_prior[t0 - 1]
            state = (
                jnp.asarray(
                    self._particle_parameters[t0 - 1][surv], gen.dtype
                ),
                jnp.asarray(self._weights[t0 - 1], gen.dtype),
                jnp.asarray(self._doubled_variance[t0 - 1], gen.dtype),
            )
        else:
            state = None

        results = []
        pops = []
        hist = None
        chain_hist = None

        def _fetch_mirror_tuple(tup):
            # multi-process fetch of one set's mirror tuple (pars [N,P],
            # seeds [N], mets [N,M], sidx, w, dv, ncomp): the O(N) leaves
            # go through the chunked row-psum path so an HBM-bound sharded
            # population is never replicated ndev-fold whole
            # (parallel/mesh.py::fetch_rows_global); the small leaves
            # replicate in one all-gather
            return tuple(
                fetch_rows_global(a, mesh) for a in tup[:3]
            ) + tuple(self._fetch_global(tuple(tup[3:]), mesh))

        t_dispatch0 = time.perf_counter()
        if use_scan:
            n0, keep0 = next(iter(sizes)), next(iter(keeps))
            _last, hist = gen.run_scan(
                key, n0, keep0, cfg.num_smc_sets, full_history=True
            )
        elif use_chain:
            _state, chain_hist = gen.run_chain(
                key, sizes_list, keeps_list, full_history=True,
                bucketed_history=True,
            )
        else:
            for t in range(t0, cfg.num_smc_sets):
                key, kt = jax.random.split(key)
                n_t = cfg.smc_size_at(t)
                last = t + 1 >= cfg.num_smc_sets
                n_next = 0 if last else cfg.smc_size_at(t + 1)
                # HBM-bound shapes sequence rank -> fetch -> FREE -> propose
                # at the engine level: inside a single step() the caller's
                # [N, P]/[N, M] buffers stay live through the proposal, which
                # overflows one chip at ~100M rows (the generation-level
                # split alone cannot free what the engine still references)
                split_t = gen.split_propose_active(n_t, n_next)
                eff_next = 0 if split_t else n_next
                if t == t0 and pending_mets is not None:
                    # resumed set: metrics are the stored-'D'/re-simulated
                    # merge
                    res = gen.step_precomputed(
                        kt, params, pending_mets, cfg.pred_prior_size_at(t),
                        eff_next, state, n_valid=n_t,
                    )
                    pending_mets = None
                else:
                    res = gen.step(
                        kt, params, seeds, cfg.pred_prior_size_at(t),
                        eff_next, state, n_valid=n_t,
                    )
                state = (
                    res.survivor_params, res.weights, res.doubled_variance
                )
                converged = self._nrmse_converged(res.survivor_metrics, t)
                if split_t:
                    # eager per-generation fetch: the O(N) device buffers of
                    # THIS generation must die before the [N2, P] proposal
                    # program runs (and before the next generation exists) -
                    # retaining every generation like the fast path does
                    # would also accumulate O(G * N) HBM at these shapes
                    if jax.process_count() == 1:
                        # one batched device_get: one round trip for all
                        # seven buffers
                        host = jax.device_get((
                            params, seeds, res.metrics, res.survivor_idx,
                            res.weights, res.doubled_variance,
                            res.ncomp_used,
                        ))
                    else:
                        # multi-process: the O(N) population buffers fetch
                        # through the chunked row-psum path - a whole-array
                        # replicate would materialize an ndev-fold copy of
                        # exactly the buffers that are HBM-bound enough to
                        # have triggered the split (parallel/mesh.py)
                        host = _fetch_mirror_tuple((
                            params, seeds, res.metrics, res.survivor_idx,
                            res.weights, res.doubled_variance,
                            res.ncomp_used,
                        ))
                    pops.append(host[:3])
                    results.append(_SlimResult(*host[3:]))
                    del params, seeds, res
                    # (the final set never reaches this branch: n_next == 0
                    # there and split_propose_active is False for it)
                    if converged:
                        break
                    params, seeds = gen.propose(kt, *state, n_next)
                else:
                    # keep device references; the host fetch happens in the
                    # mirror phase below so generation t+1 dispatches without
                    # waiting on an O(N) device->host transfer
                    # of generation t
                    pops.append((params, seeds, res.metrics))
                    results.append(res)
                    params, seeds = res.next_params, res.next_seeds
                    if converged:
                        break

        t_dispatch = time.perf_counter() - t_dispatch0

        # ---- mirror into the run store (schema parity) ----
        # one batched device_get for every buffer of every set: transfers are
        # issued together (copy_to_host_async under the hood), so the link
        # pays its round-trip latency once, not once per array per set.
        # Both paths fetch here, so dispatch_s below is launch-only and
        # mirror_s is fetch + store writes + reports on either path.
        t_mirror0 = time.perf_counter()
        multi = jax.process_count() > 1
        # NRMSE-tolerance fused runs: every set was computed in-program; the
        # convergence rule applies post-hoc by CUTTING the mirror at the
        # first converged set - exactly the rows the sequential loop (which
        # stops dispatching there) would store; the per-set chains are
        # identical (key-split parity), so this is row-for-row equivalent.
        # The cut is computed from the SMALL survivor-metrics leaves alone,
        # fetched first, so the truncated tail sets' O(N) population leaves
        # never cross the device->host link - at small populations the fetch,
        # not the dispatch, is the larger cost. Replicated survivor leaves make every
        # process of a multi-process mesh compute the same cut.
        cut = None
        if cfg.nrmse_tolerance and (hist is not None or chain_hist is not None):
            if hist is not None:
                smet_h = (
                    self._fetch_global(hist[2], mesh) if multi
                    else jax.device_get(hist[2])
                )
                smets = list(smet_h)
            else:
                leaves = [
                    e[1][2] if e[0] == "set" else e[2][2]
                    for e in chain_hist
                ]
                host_leaves = (
                    self._fetch_global(tuple(leaves), mesh) if multi
                    else jax.device_get(leaves)
                )
                smets = []
                for e, hl in zip(chain_hist, host_leaves):
                    if e[0] == "set":
                        smets.append(hl)
                    else:
                        smets.extend(hl[i] for i in range(e[1]))
            cut = len(smets)
            for i, sm in enumerate(smets):
                if self._nrmse_converged(sm, t0 + i):
                    cut = i + 1
                    break
        if hist is not None:
            n_keep = cfg.num_smc_sets if cut is None else cut
            # scan history leaves are [G, ...]: slice the kept prefix on
            # device (one tiny program per O(N) leaf) before fetching
            big = (
                hist[6:9] if n_keep == cfg.num_smc_sets
                else tuple(h[:n_keep] for h in hist[6:9])
            )
            if multi:
                # the population axis is axis 1 on the O(N) leaves
                # (params/seeds/metrics)
                sidx, w_a, dv_a, ncomp_a = self._fetch_global(
                    (hist[0], hist[3], hist[4], hist[5]), mesh
                )
                pars_a, seeds_a, mets_a = (
                    fetch_rows_global(h, mesh, axis=1) for h in big
                )
            else:
                (sidx, w_a, dv_a, ncomp_a, pars_a, seeds_a, mets_a) = (
                    jax.device_get(
                        (hist[0], hist[3], hist[4], hist[5]) + tuple(big)
                    )
                )
            fetched = [
                (pars_a[g], seeds_a[g], mets_a[g], sidx[g], w_a[g],
                 dv_a[g], ncomp_a[g])
                for g in range(n_keep)
            ]
        elif chain_hist is not None:
            # run_chain's BUCKETED history: singles carry one set's leaves
            # (sidx, spar, smet, w, dv, ncomp, params, seeds, metrics),
            # buckets the scan's stacked [L, ...] versions. Fetch the
            # stacked leaves whole and slice per set in host numpy: the
            # per-set device slicing this replaces cost L x 7 tiny slice
            # programs + as many per-leaf fetches, whose round trips
            # dominated this phase of the 30-set quick-start.
            entries = []
            s0 = 0
            for entry in chain_hist:
                if entry[0] == "set":
                    blen, h = 1, entry[1]
                    tup = (h[6], h[7], h[8], h[0], h[3], h[4], h[5])
                else:
                    _, blen, ys = entry
                    tup = (ys[6], ys[7], ys[8], ys[0], ys[3], ys[4], ys[5])
                if cut is not None:
                    if s0 >= cut:
                        break
                    if blen > cut - s0:
                        # the bucket straddling the convergence cut: slice
                        # its stacked leaves on device ONCE (7 tiny slice
                        # programs total, not per set) so the truncated
                        # tail never crosses the device->host link
                        blen = cut - s0
                        tup = tuple(a[:blen] for a in tup)
                s0 += blen
                entries.append(
                    ("set", 1, tup) if entry[0] == "set"
                    else ("bucket", blen, tup)
                )
            if multi:
                host_entries = []
                for kind, blen, tup in entries:
                    if kind == "set":
                        host_entries.append(
                            (kind, blen, _fetch_mirror_tuple(tup))
                        )
                    else:
                        # stacked population leaves are [L, N, ...]: the
                        # sharded particle axis is axis 1
                        big = tuple(
                            fetch_rows_global(a, mesh, axis=1)
                            for a in tup[:3]
                        )
                        small = self._fetch_global(tuple(tup[3:]), mesh)
                        host_entries.append((kind, blen, big + small))
            else:
                host = jax.device_get([t for _, _, t in entries])
                host_entries = [
                    (kind, blen, t)
                    for (kind, blen, _), t in zip(entries, host)
                ]
            fetched = []
            for kind, blen, t in host_entries:
                if kind == "set":
                    fetched.append(t)
                else:
                    fetched.extend(
                        tuple(leaf[g] for leaf in t) for g in range(blen)
                    )
        else:
            tuples = [
                (
                    pars_d, seeds_d, mets_d, res.survivor_idx, res.weights,
                    res.doubled_variance, res.ncomp_used,
                )
                for res, (pars_d, seeds_d, mets_d) in zip(results, pops)
            ]
            fetched = (
                [_fetch_mirror_tuple(tup) for tup in tuples] if multi
                else jax.device_get(tuples)
            )
        # the mirror loop is collective-free (fetches done above), so a
        # store error on the writer must not strand the peers in the final
        # _mesh_sync below - the guard turns it into an every-process raise
        with self._writer_guard("the store mirror"):
            self._mirror_fetched_sets(
                fetched, t0, pending_serials, mirror_store
            )
        # phase observability: at small populations the
        # dispatch loop (per-set program launches) and the mirror loop
        # (device->host fetch + store writes + reports) dominate over compute;
        # surface the split so perf regressions are attributable
        self.timings.append({
            "op": "run_device_phases", "sets": len(fetched),
            "dispatch_s": round(t_dispatch, 4),
            "mirror_s": round(time.perf_counter() - t_mirror0, 4),
            # compiled-program launches this ShardedGeneration issued: on
            # the fused paths this is per size TRANSITION (init + a handful
            # of programs), not per set - the regression test for the
            # dispatch-latency contract (tests/test_device_dispatch.py)
            "programs": gen.dispatches,
        })
        if self._proc0():
            reports.report_convergence_data(self, t0 + len(fetched) - 1)
        # every process may read the store after run_device returns; the
        # barrier publishes the writer's mirror first
        self._mesh_sync()
        return self

    def _mirror_fetched_sets(
        self, fetched, t0: int, pending_serials, mirror_store: bool
    ) -> None:
        """Mirror the fetched per-set host tuples into the durable store
        (writer only) and the in-memory posterior state (every process);
        runs inside :meth:`_writer_guard` - no collectives in here."""
        cfg = self.config
        mirror_here = mirror_store and self._store_writer()
        if mirror_here and not self.storage.exists():
            self.storage.create(
                self.par_set.short_names(),
                [m.short_name for m in self.metrics],
                self.transform.has_any,
            )
        for i, host in enumerate(fetched):
            t = t0 + i
            n_t = cfg.smc_size_at(t)
            (pars_h, seeds_h, mets_h, surv_h, w_h, dv_h, ncomp_h) = host
            # selection observability (ncomp collapsing to 1 on structured
            # data is a silent statistical failure). This
            # check must run BEFORE any store write for the set: a negative
            # count means the fused step's in-program U0 self-check fired
            # (parallel/generation.py "RUNTIME SELF-CHECK") - the van der
            # Voet moment matmul read corrupted operand data, the signature
            # of an XLA fusion miscompile (docs/DESIGN.md). Mirroring first would durably
            # record the poisoned set as complete-and-ranked (the store has
            # no ncomp column), so a resume would ingest it as valid - the
            # exact silent degradation this raise exists to prevent.
            ncomp_val = int(np.asarray(ncomp_h))
            if ncomp_val < 0:
                raise AbcError(
                    f"set {t}: PLS component selection self-check failed "
                    f"(ncomp_used={ncomp_val}): the van der Voet moment "
                    "matmul produced a negative sum-of-squares, the XLA "
                    "fusion-miscompile signature (docs/DESIGN.md 'The vdv "
                    "fusion miscompile'). Re-run with "
                    "pls_optimal_method='tolerance' or on the CPU backend, "
                    "and report the XLA version.",
                )
            pars_np = np.asarray(pars_h, np.float64)[:n_t]
            seeds_np = np.asarray(seeds_h, np.uint64)[:n_t]
            mets_np = np.asarray(mets_h, np.float64)[:n_t]
            surv = np.asarray(surv_h, np.int64)
            ranks = np.full(len(pars_np), -1, np.int64)
            ranks[surv] = np.arange(len(surv))
            if mirror_here and n_t >= (1 << 24):
                # size the durable-store bill up front instead of looking
                # hung: the streamed insert is linear at ~10 us/row with a
                # ~15 B/value database footprint (docs/SCALING.md "The
                # durable-store bill"); users who only need the posterior
                # surfaces can skip it
                vals_per_row = self.npar * (2 if self.transform.has_any
                                            else 1) + self.nmet + 3
                sys.stderr.write(
                    f"mirroring set {t}: {n_t:,} rows into the durable "
                    f"store (~{n_t * 10e-6:.0f} s, "
                    f"~{n_t * vals_per_row * 15 / 2**30:.1f} GB on disk; "
                    "pass mirror_store=False to run without durability)\n"
                )
            if mirror_here and t == t0 and pending_serials is not None:
                # resumed set: rows already exist - guarded writeback (rows
                # already 'D' keep their stored metrics: first-write-wins)
                # then rank updates
                n_rows = len(pending_serials)
                self.storage.write_results(
                    pending_serials, mets_np,
                    np.full(n_rows, int(time.time())), np.zeros(n_rows),
                )
                self.storage.write_posterior_ranks(pending_serials, ranks)
            elif mirror_here:
                upars = (
                    np.asarray(
                        self.transform.to_model_space(pars_np), np.float64
                    )
                    if self.transform.has_any else None
                )
                self.storage.insert_generation_complete(
                    t, pars_np, seeds_np, mets_np, upars, ranks
                )
            self._particle_parameters.append(pars_np)
            self._particle_metrics.append(mets_np)
            self._predictive_prior.append(surv)
            self._weights.append(np.asarray(w_h, np.float64))
            self._doubled_variance.append(np.asarray(dv_h, np.float64))
            self.timings.append({
                "op": "device_generation", "set": t,
                "ncomp_used": ncomp_val,
            })
            if self._proc0():
                reports.filtering_report(
                    self, t, pars_np[surv], mets_np[surv]
                )

    @contextmanager
    def _writer_guard(self, what: str):
        """Failure-propagating scope for the collective-free regions of the
        device path where ONE process (usually the store writer) performs
        fallible work the others don't: without this, a store error raised
        on the writer alone leaves every peer blocked in the NEXT collective
        (``_mesh_sync``/broadcast) until the distributed runtime's timeout —
        a hang, not a failure. Every process enters the scope; local
        exceptions are held, a process-allgather agrees on whether anyone
        failed, and then the failing process re-raises its own error while
        the peers raise a coded :class:`AbcError` naming the phase. The
        scope must contain NO collectives (a raise before a collective
        inside it would re-create the hang); single-process scopes add no
        collective and just re-raise."""
        err: Exception | None = None
        try:
            yield
        except Exception as e:  # noqa: BLE001 - re-raised below, post-agree
            err = e
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            flags = multihost_utils.process_allgather(
                np.asarray(err is not None)
            )
            if err is not None:
                raise err
            if bool(np.any(flags)):
                raise AbcError(
                    f"a peer process failed during {what}; aborting this "
                    "process instead of hanging in the next collective "
                    "(see the failing process's traceback)",
                )
        elif err is not None:
            raise err

    @staticmethod
    def _broadcast_flag(value: bool) -> bool:
        """Process-0's boolean on every process of a multi-process mesh
        (loop-control lockstep: an early stop decided by the brain must
        break every process's loop, or the others deadlock waiting for the
        next collective). No-op single-process."""
        if jax.process_count() == 1:
            return value
        from jax.experimental import multihost_utils

        return bool(multihost_utils.broadcast_one_to_all(np.asarray(value)))

    def _run_device_projection(self, seed: int, mesh, verbose: bool):
        """Projection sweeps (PSEUDO/POSTERIOR grids, src/AbcSmc.cpp:54-137,
        341-396) on the device path: the population is built by the host
        odometer exactly as --process would (order parity with ParRNG.h:17-36),
        then each set is simulated as ONE mesh-sharded XLA program instead of
        claim-sized host batches.

        Multi-process meshes: the store writer runs the brain (enqueue /
        read); a barrier publishes each enqueue before the lockstep SPMD
        simulate, in which EVERY process participates with the identical
        serial-ordered batch (claim by the writer, read-only view by the
        rest - see _device_simulate_all). Non-writers ingest the finished
        store at the end so posterior surfaces agree everywhere."""
        cfg = self.config
        for t in range(cfg.num_smc_sets):
            with self._writer_guard("the projection brain pass"):
                if self._store_writer():
                    self.process_database(seed + t, verbose)
            stop = self._broadcast_flag(
                bool(getattr(self, "_stopped_early", False))
            )
            self._mesh_sync()
            if stop:
                if not self._store_writer():
                    # early stop decided by the writer's brain: non-writers
                    # still ingest the finished store (read-only; all writes
                    # are gated off) so posterior surfaces agree everywhere -
                    # same contract as the post-loop ingest below
                    self.process_database(seed + t, verbose)
                return self
            self._device_simulate_all(mesh)
            self._mesh_sync()
        with self._writer_guard("the final projection brain pass"):
            if self._store_writer():
                self.process_database(seed + cfg.num_smc_sets, verbose)
        self._mesh_sync()
        if not self._store_writer():
            # read-only final ingest: fills the in-memory posterior state
            # from the (now complete) shared store; all writes are gated off
            self.process_database(seed + cfg.num_smc_sets, verbose)
        return self

    def _device_simulate_all(self, mesh):
        """Claim every runnable job and simulate the batch as one sharded
        program over the mesh (the device-side analog of
        simulate_next_particles(n=-1)).

        Multi-process meshes (shared store): the simulate is a collective
        program, so every process must participate with IDENTICAL global
        arrays - process 0 claims (EXCLUSIVE transaction, reference
        semantics) and the rest take the read-only view of the same rows
        after a barrier, both serial-ordered; only the writer writes back
        (guarded, first-write-wins as ever)."""
        from abcsmc_tpu.parallel.generation import sharded_simulate

        multiproc = jax.process_count() > 1 and getattr(
            self.storage, "shared", True
        )
        t0 = time.perf_counter()
        if not multiproc:
            # process-private stores on a multi-process mesh still need the
            # guard: a claim failure on one process would strand the others
            # in the collective simulate below (no-op single-process)
            with self._writer_guard("the job claim"):
                claimed = self.storage.claim_jobs(-1)
        else:
            with self._writer_guard("the job claim"):
                if self._proc0():
                    claimed = self.storage.claim_jobs(-1)
                    # align with read_runnable's serial order
                    order = np.argsort(claimed.serials)
                    claimed = type(claimed)(
                        serials=claimed.serials[order],
                        seeds=claimed.seeds[order],
                        params=claimed.params[order],
                    )
            self._mesh_sync()  # the writer's claim happens-before this read
            with self._writer_guard("the runnable-row read"):
                if not self._proc0():
                    claimed = self.storage.read_runnable()
        t_claim = time.perf_counter() - t0
        if claimed.serials.size == 0:
            return
        start = time.time()
        t0 = time.perf_counter()
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        mets = sharded_simulate(
            self.simulator, mesh,
            jnp.asarray(claimed.params, dtype),
            jnp.asarray(claimed.seeds.astype(np.uint32)),
            len(claimed.serials),
        )
        t_sim = time.perf_counter() - t0
        mets = np.asarray(mets, np.float64)
        if not np.isfinite(mets).all():
            bad = ~np.isfinite(mets).all(axis=1)
            sys.stderr.write(
                f"WARNING: {int(bad.sum())} particle(s) returned non-finite "
                "metrics; overwriting with DBL_MIN\n"
            )
            mets[bad] = np.finfo(np.float64).tiny
        nrun = len(claimed.serials)
        t0 = time.perf_counter()
        with self._writer_guard("the simulate writeback"):
            if self._store_writer():
                self.storage.write_results(
                    claimed.serials, mets,
                    np.full(nrun, int(start)),
                    np.full(nrun, t_sim / max(nrun, 1)),
                )
        self.timings.append({
            "op": "simulate_device", "n": nrun, "claim_s": round(t_claim, 4),
            "sim_s": round(t_sim, 4),
            "writeback_s": round(time.perf_counter() - t0, 4),
        })

    # -- results ------------------------------------------------------------------
    @property
    def particle_parameters(self) -> list[np.ndarray]:
        """Per-set parameter matrices (AbcSmc::get_particle_parameters)."""
        return self._particle_parameters

    @property
    def particle_metrics(self) -> list[np.ndarray]:
        """Per-set metric matrices (AbcSmc::get_particle_metrics)."""
        return self._particle_metrics

    def checkpoint(self, path: str, stamp: bool = True) -> dict:
        """Write the run store to a reference-schema SQLite file and stamp it.

        MemoryStorage runs are snapshotted; SQLite-backed runs are copied via
        the sqlite3 online-backup API (safe against concurrent writers), or —
        when ``path`` is the live database itself — left in place (the DB
        already *is* the checkpoint, §5.4 of the reference's design:
        /root/reference/src/AbcSmc.cpp:452-479). With ``stamp`` (default), a
        CRC-32 integrity stamp (``crc32.database_crc``) is written beside the
        file as ``<path>.crc.json`` so a copy shipped between cluster
        filesystems can be verified on arrival (``verify_checkpoint``).
        Returns the stamp dict (empty when ``stamp=False``)."""
        path = os.fspath(path)  # accept PathLike everywhere, incl. the stamp
        if isinstance(self.storage, MemoryStorage):
            target = SQLiteStorage(path)
            self.storage.snapshot_to(target)
            target.close()
        elif isinstance(self.storage, SQLiteStorage) and (
            os.path.abspath(path) != os.path.abspath(self.storage.path)
        ):
            import contextlib
            import sqlite3 as _sq

            # contextlib.closing: sqlite3's own context manager only commits,
            # it does not close - leaked handles hold the file lock on NFS
            with contextlib.closing(
                _sq.connect(self.storage.path)
            ) as src, contextlib.closing(_sq.connect(path)) as dst:
                src.backup(dst)
        if not stamp:
            return {}
        from abcsmc_tpu import crc32 as _crc32

        info = _crc32.database_crc(path)
        with open(path + ".crc.json", "w") as fh:
            json.dump(info, fh)
        return info

    def ess(self, set_num: int = -1) -> float:
        """Effective sample size of a generation's importance weights,
        (sum w)^2 / sum w^2 - a degeneracy diagnostic the reference lacks."""
        if set_num == -1:
            set_num = len(self._weights) - 1
        w = self._weights[set_num]
        return float(w.sum() ** 2 / (w**2).sum())

    def posterior_predictive(
        self, n: int = 100, seed: int = 0, set_num: int = -1
    ) -> np.ndarray:
        """Posterior-predictive metric draws: resample ``n`` posterior
        particles (weighted), rerun the simulator with fresh seeds, return the
        metrics [n, M]. Compare to ``self.obs`` for model criticism."""
        if self.simulator is None:
            raise SimulatorError("simulator not set", code=-211)
        pars, w = self.posterior(set_num)
        key = self._key(seed)
        k_pick, k_seed = jax.random.split(key)
        idx = np.asarray(
            resample.resample_indices(
                k_pick, jnp.asarray(w), n, self.config.resample_method
            )
        )
        chosen = pars[idx]
        upars = np.asarray(
            self.transform.to_model_space(jnp.asarray(chosen)), np.float64
        )
        seeds = self._draw_seeds(k_seed, n)
        return self.simulator.run_batch(upars, seeds, np.arange(n))

    def posterior(self, set_num: int = -1) -> tuple[np.ndarray, np.ndarray]:
        """(params, weights) of the predictive prior of a set (default last)."""
        if set_num == -1:
            set_num = len(self._predictive_prior) - 1
        surv = self._predictive_prior[set_num]
        return (
            self._particle_parameters[set_num][surv],
            self._weights[set_num],
        )

    def posterior_summary(
        self, set_num: int = -1,
        quantiles: tuple[float, ...] = (0.025, 0.25, 0.5, 0.75, 0.975),
    ) -> dict:
        """Weighted posterior summary per parameter: mean, sd, and weighted
        quantiles (inverse-CDF over the weight distribution)."""
        pars, w = self.posterior(set_num)
        w = np.asarray(w, np.float64)
        w = w / w.sum()
        ess = self.ess(set_num)
        out = {}
        for j, p in enumerate(self.par_set.params):
            x = pars[:, j]
            mean = float((x * w).sum())
            var = float(((x - mean) ** 2 * w).sum())
            order = np.argsort(x)
            cw = np.cumsum(w[order])
            qs = {
                q: float(x[order][np.searchsorted(cw, q, side="left").clip(
                    0, len(x) - 1)])
                for q in quantiles
            }
            out[p.short_name] = {
                "mean": mean, "sd": float(np.sqrt(var)), "quantiles": qs,
                "ess": ess,
            }
        return out
