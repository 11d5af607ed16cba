"""Fully-fused, mesh-sharded SMC generation step.

One jitted SPMD program per generation, sharded over the particle axis
(shard_map over a 1-D mesh): simulate -> z-score (psum moments) -> PLS fit
(psum Gram matrices) -> component CV (psum PRESS) -> score projection ->
distance -> global top-K (local top-k + all_gather + re-top-k) -> doubled
variance + kernel-mixture weights -> weighted resample + truncated perturbation
of the next generation, each shard emitting its local chunk.

This replaces the reference's per-generation sequence of SQLite scans +
Eigen/GSL loops (src/AbcSmc.cpp:452-559 with the numerics of src/AbcUtil.cpp):
a handful of small collectives per generation cross the device interconnect -
psums of Gram/moment tensors, plus either one all_gather of K-candidate rows
(small meshes/keeps) or the two-stage top-K's distance gather + mesh-size-
independent survivor-row psum (docs/SCALING.md); everything else is local and
fuses into large batched XLA ops.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from abcsmc_tpu.config import FilterType, NoiseType
from abcsmc_tpu.models.parameters import ParameterSet
from abcsmc_tpu.models.simulators import DeviceSimulator
from abcsmc_tpu.models.transforms import ParameterTransform
from abcsmc_tpu.ops import pls as pls_mod
from abcsmc_tpu.ops import stats as stats_mod
from abcsmc_tpu.ops import weights as weights_mod
from abcsmc_tpu.ops.resample import _stratum_points
from abcsmc_tpu.parallel.mesh import PARTICLE_AXIS

AXIS = PARTICLE_AXIS

# Accuracy-critical dots (covariances, Grams, score projections) are pinned
# to full-f32 explicitly, so the documented ABCSMC_MATMUL_PRECISION opt-out
# (meant for heavy neural device-simulators) can only downgrade the USER'S
# simulator matmuls, never the inference math - mirroring the host path's
# explicit guards (ops/resample.py, ops/weights.py). On a GPU a lower
# precision means TF32 inputs (10 mantissa bits), which inject ~1e-3
# relative error into covariance/Gram products.
_HI = jax.lax.Precision.HIGHEST


def _hdot(a, b):
    """matmul at explicit HIGHEST precision (see _HI note above)."""
    return jnp.matmul(a, b, precision=_HI)


def _vdv_moment_dot(W, rhs):
    """The van der Voet moment matmul behind its hardware-validated fusion
    barrier (see the MISCOMPILE GUARD note at the call site). Module-level so
    the in-program U0 self-check can be exercised by tests injecting a
    corrupted product (tests/test_sharded.py::test_vdv_miscompile_flag)."""
    W, rhs = jax.lax.optimization_barrier((W, rhs))
    return jax.lax.dot(W, rhs, precision=_HI)


def _detect_device_bytes(mesh) -> int | None:
    """Memory the runtime lets a program use on this process's first device
    of the mesh (``bytes_limit``; a device another process owns cannot be
    queried), or None when the backend reports none (the CPU).
    Module-level so tests can monkeypatch the detection
    (tests/test_scaling_structure.py)."""
    stats = mesh.local_devices[0].memory_stats()
    v = stats.get("bytes_limit") if stats else None
    return int(v) if v else None


def _dual_moment_stats(s1c, s2c, s1r, s2r, c, n: int):
    """Mean/sd from DUAL one-pass moment accumulators: shifted
    (``sum(x-c)``, ``sum((x-c)^2)``) and raw (``sum(x)``, ``sum(x*x)``),
    choosing PER COLUMN the formula that lost fewer bits.

    Either one-pass variance formula cancels catastrophically at f32 when
    the subtracted ``n*mu^2`` term dwarfs the true variance: the raw form
    fails at ``|mean| >> sd`` (epi-count metrics at 1e5 scale), the
    shifted form fails in the mirrored regime ``|mean - c| >> sd`` (a
    misfit model simulating far from the observed center). Both are exact
    in infinite precision; the one whose ``n*mu^2 / sum-of-squares`` ratio
    is smaller retained more mantissa, so the selection keeps whichever
    frame the data actually sits near - covering both regimes with one
    data pass, one fused psum round, and no extra collective. (Only data
    concentrated far from BOTH centers - e.g. mean 1e9 with obs 0 - still
    cancels; that needs a true second pass no one-pass scheme can avoid.)

    Returns ``(mean, sd_unguarded, obs_delta)`` where ``obs_delta`` is
    ``c - mean`` computed WITHOUT re-rounding the large ``c + dmean`` sum
    (exact for shifted columns: it is ``-dmean``)."""
    dmean = s1c / n
    mean_r = s1r / n
    num_c = n * dmean * dmean
    num_r = n * mean_r * mean_r
    tiny = jnp.asarray(jnp.finfo(s2c.dtype).tiny, s2c.dtype)
    # default to the SHIFTED frame unless the raw ratio is finite and
    # strictly smaller: at data scales where sum(x*x) overflows f32 to inf
    # (x ~ 2e15 at n ~ 1e8 rows), ratio_r is inf/inf = NaN and any <=
    # comparison would come out False - silently selecting the overflowed
    # raw frame exactly where the shifted one is accurate
    ratio_c = num_c / jnp.maximum(s2c, tiny)
    ratio_r = num_r / jnp.maximum(s2r, tiny)
    # ...and the mirror case: if the SHIFTED sums overflow (data near 0,
    # |obs| ~ 2e19), ratio_c is NaN and the raw frame must win
    use_c = jnp.isfinite(ratio_c) & ~(ratio_r < ratio_c)
    var = jnp.where(
        use_c,
        jnp.maximum(s2c - num_c, 0.0),
        jnp.maximum(s2r - num_r, 0.0),
    ) / max(n - 1, 1)
    mean = jnp.where(use_c, c + dmean, mean_r)
    obs_delta = jnp.where(use_c, -dmean, c - mean_r)
    return mean, jnp.sqrt(var), obs_delta


def _sorted_searchsorted(cdf, q_sorted, n: int):
    """``searchsorted(cdf, q)`` (side='left') for an ASCENDING query vector,
    without sorting the queries: the K-1 bucket boundaries are found by
    binary-searching the (small) cdf INTO the sorted queries, then expanded
    to per-row picks by a scatter + cumsum. Zero-width buckets (zero-weight
    survivors, duplicate cdf entries) produce +2 scatter hits at one index,
    i.e. the pick correctly skips the weightless survivor. Output is in
    [0, K-1] by construction (only the first K-1 edges are scattered)."""
    bounds = jnp.searchsorted(q_sorted, cdf[:-1], side="right")  # [K-1]
    z = jnp.zeros((n,), jnp.int32).at[bounds].add(1, mode="drop")
    return jnp.cumsum(z)


@jax.tree_util.register_dataclass
@dataclass
class GenerationResult:
    """Outputs of one sharded generation step. Arrays tagged [sharded] are laid
    out over the particle axis of the mesh; the rest are replicated.
    Registered as a pytree, so it flows through jit/tree utilities."""

    metrics: jax.Array          # [N, M]  [sharded] simulated metrics
    distances: jax.Array        # [N]     [sharded] ranking distances
    survivor_idx: jax.Array     # [K]     global indices of survivors, by rank
    survivor_params: jax.Array  # [K, P]
    survivor_metrics: jax.Array  # [K, M]
    weights: jax.Array          # [K]
    doubled_variance: jax.Array  # [P]
    next_params: jax.Array      # [N2, P] [sharded] proposed next generation
    next_seeds: jax.Array       # [N2]    [sharded]
    ncomp_used: jax.Array       # ()      PLS components used (0 for SIMPLE;
    #                                     NEGATIVE = the in-program vdv
    #                                     miscompile self-check fired - treat
    #                                     the generation as invalid)


class ShardedGeneration:
    """Factory of jitted, mesh-sharded SMC generation programs.

    Parameters are static configuration; per-call shapes (population size N,
    survivor count K, next size N2) are static arguments of the compiled step
    (a handful of distinct shapes per run -> a handful of compilations).

    Memory note for very large N: above the ``row_block`` auto-threshold
    (``row_chunk_threshold`` rows per shard, derived from the device's
    memory) the O(N)-row passes (moments, PLS Grams, distances) stream
    through lax.scan blocks, so no [ln, M] z-score buffer or [ln, A] score
    matrix is ever resident - only the raw metric matrix and the [ln]
    distance vector. ``row_block``: None =
    auto, int > 0 forces that block size (any N), 0 disables. Box-Cox,
    when enabled, is applied per block on the fly (blocked lambda-grid
    moment passes; no transformed buffer is resident either).
    """

    def __init__(
        self,
        par_set: ParameterSet,
        transform: ParameterTransform,
        simulator: DeviceSimulator,
        obs: np.ndarray,
        *,
        mesh: Mesh,
        filter_type: FilterType = FilterType.PLS,
        noise_type: NoiseType = NoiseType.INDEPENDENT,
        training_fraction: float = 0.5,
        max_pls_components: int | None = None,
        max_retries: int = 1000,
        dtype=jnp.float32,
        pls_optimal_method: str = "vdv",
        vdv_permutations: int = 199,
        vdv_max_rows: int = 131_072,
        resample_method: str = "multinomial",
        box_cox: bool = False,
        row_block: int | None = None,
        propose_split: bool | None = None,
        topk_two_stage: bool | None = None,
    ):
        if par_set.pseudo_idx or par_set.posterior_idx:
            raise ValueError(
                "sharded generation supports fitting mode (prior parameters) "
                "only; projection-mode grids run through the host engine"
            )
        self.par_set = par_set
        self.transform = transform
        self.simulator = simulator
        self.obs = np.asarray(obs)
        self.mesh = mesh
        self.ndev = mesh.devices.size
        self.filter_type = filter_type
        self.noise_type = noise_type
        self.training_fraction = float(training_fraction)
        self.max_pls_components = max_pls_components
        self.max_retries = int(max_retries)
        self.dtype = dtype
        self.pls_optimal_method = pls_optimal_method
        self.vdv_permutations = int(vdv_permutations)
        self.vdv_max_rows = int(vdv_max_rows)
        self.box_cox = bool(box_cox)
        if resample_method not in ("multinomial", "systematic"):
            # mirror ops.resample.resample_indices: a typo must not silently
            # fall through to the multinomial branch
            raise ValueError(f"unknown resample method {resample_method!r}")
        self.resample_method = resample_method
        if row_block is not None and int(row_block) < 0:
            raise ValueError(f"row_block must be >= 0, got {row_block!r}")
        # None = auto (chunk the O(N)-row passes when a shard's slice is big
        # enough that the [ln, M] / [ln, A] intermediates threaten memory);
        # an int > 0 forces that block size; 0 disables chunking
        self.row_block = None if row_block is None else int(row_block)
        # None = auto (split the proposal phase into its own program when a
        # shard's population or proposal slice reaches split_threshold rows -
        # lowering peak memory by never overlapping rank-phase and
        # propose-phase buffers); True/False force
        self.propose_split = propose_split
        # global top-K strategy: None = auto (two-stage when the candidate
        # gather would exceed _TOPK_TWO_STAGE_BYTES per device on a >1-dev
        # mesh), True/False force. See _topk_two_stage_active.
        self.topk_two_stage = topk_two_stage
        # resample-pick strategy switch: above this many proposal rows per
        # shard, picks come from pre-sorted uniforms (exponential spacings)
        # + _sorted_searchsorted instead of searchsorted(method="sort"),
        # which sorts the whole query vector. Below it the small sort is
        # cheaper and the draw streams stay byte-stable. The crossover is a
        # default not yet measured on a GPU (ROADMAP.md).
        self.sorted_pick_min = 1 << 19
        # memory auto-thresholds, a rule in bytes: the per-row bytes of the
        # buffers each threshold guards, against half the memory the device
        # reports (the rest holds inputs, outputs and XLA's own workspace).
        # chip_smoke.py's step phase prints the compiled program's
        # memory_analysis() beside these estimates. A backend that reports
        # no limit (the CPU) runs resident and fused unless row_block /
        # propose_split force otherwise; explicit config always wins.
        it = jnp.dtype(dtype).itemsize
        npar, nmet = par_set.npar, len(self.obs)
        # resident row passes: z-scores and their masked copies per metric,
        # PLS scores per component (at most one per metric), parameter
        # z-scores, row masks
        self.resident_row_bytes = it * (7 * nmet + 3 * npar + 4)
        # a fused step holds its inputs (params, metrics, seed, distance)
        # while the proposal builds picks, uniforms, parents, noise draws
        # and the next params/seeds
        self.propose_row_bytes = it * (npar + nmet + 2) + it * (4 * npar + 6)
        self.device_bytes = _detect_device_bytes(mesh)
        budget = self.device_bytes // 2 if self.device_bytes else None
        self.row_chunk_threshold = (
            budget // self.resident_row_bytes if budget else None
        )
        self.split_threshold = (
            budget // self.propose_row_bytes if budget else None
        )
        self._step_cache: dict[Any, Any] = {}
        self._init_cache: dict[Any, Any] = {}
        #: compiled-program launches issued through this object (init /
        #: step / propose / scan / chain bucket) - the dispatch-latency
        #: observable; run_device surfaces it in
        #: ``AbcSmc.timings`` and tests pin the chain path's count to the
        #: number of size transitions, not the number of SMC sets
        self.dispatches = 0

    # ------------------------------------------------------------------ helpers
    def _sharded(self):
        return NamedSharding(self.mesh, P(AXIS))

    def _replicated(self):
        return NamedSharding(self.mesh, P())

    def _padded(self, n: int) -> int:
        """Population buffer size: n rounded up to a multiple of the mesh.
        Rows >= n are padding - real draws, but masked out of every moment,
        Gram, PRESS, and top-K (distance forced to +inf). This keeps
        reference-shaped configs (300/1000 samples, examples/reference.json:2-4)
        on the device path with any device count."""
        d = self.ndev
        return -(-n // d) * d

    # ------------------------------------------------------------------ gen 0
    def init_population(self, key, n: int):
        """Sample generation 0 from the priors, shard-local draws. Returns
        buffers of ``self._padded(n)`` rows; rows >= n are padding (valid prior
        draws a later ``step(..., n_valid=n)`` masks out)."""
        n = self._padded(n)
        fn = self._init_cache.get(n)
        if fn is None:
            local_n = n // self.ndev

            def local_init(key):
                idx = jax.lax.axis_index(AXIS)
                k = jax.random.fold_in(key, idx)
                k_par, k_seed = jax.random.split(k)
                params, _ = self.par_set.sample_priors(k_par, local_n)
                seeds = jax.random.randint(
                    k_seed, (local_n,), 0, np.iinfo(np.int32).max
                ).astype(jnp.uint32)
                return params.astype(self.dtype), seeds

            fn = jax.jit(
                jax.shard_map(
                    local_init, mesh=self.mesh, in_specs=P(), out_specs=P(AXIS)
                )
            )
            self._init_cache[n] = fn
        self.dispatches += 1
        return fn(key)

    # ------------------------------------------------------------------ the step
    def step(
        self, key, params, seeds, keep: int, n_next: int,
        prev_state: tuple | None = None, n_valid: int | None = None,
    ) -> GenerationResult:
        """Run one full generation. ``prev_state`` is (survivor_params, weights,
        doubled_variance) from the previous generation, or None for the first.

        ``n_valid``: true population size when the input buffers carry padding
        rows at the tail (as produced by :meth:`init_population` or a previous
        step whose ``n_next`` didn't divide the mesh). ``n_next = 0`` skips the
        proposal of the next generation entirely (the final set - the reference
        also stops proposing there, src/AbcSmc.cpp:526-529).
        """
        return self._step_dispatch(
            key, params, seeds, keep, n_next, prev_state, include_sim=True,
            n_valid=n_valid,
        )

    def step_precomputed(
        self, key, params, metrics, keep: int, n_next: int,
        prev_state: tuple | None = None, n_valid: int | None = None,
    ) -> GenerationResult:
        """The generation step with the simulator excluded - metrics are inputs.
        This is the BASELINE.md north-star unit (filter + weight + resample,
        simulator excluded)."""
        return self._step_dispatch(
            key, params, metrics, keep, n_next, prev_state, include_sim=False,
            n_valid=n_valid,
        )

    def _step_dispatch(
        self, key, params, second, keep, n_next, prev_state, include_sim: bool,
        n_valid: int | None = None,
    ) -> GenerationResult:
        n_true = params.shape[0] if n_valid is None else int(n_valid)
        n_pad = self._padded(n_true)
        assert keep <= n_true, (keep, n_true)
        if params.shape[0] != n_pad:
            # host-side tail padding (edge rows: valid values for the
            # simulator; masked out of all statistics inside the step)
            extra = n_pad - params.shape[0]
            assert extra > 0, (params.shape[0], n_pad, n_true)
            params = jnp.concatenate(
                [params, jnp.repeat(params[-1:], extra, axis=0)]
            )
            second = jnp.concatenate(
                [second, jnp.repeat(second[-1:], extra, axis=0)]
            )
        first = prev_state is None
        split = self.split_propose_active(n_true, n_next)
        run_next = 0 if split else n_next
        # sorted_pick_min participates: it branches the traced pick path,
        # so mutating it (tests / A-B measurements) must not silently
        # reuse a program compiled under the old threshold
        cache_key = (n_pad, n_true, keep, run_next, first, include_sim,
                     self.sorted_pick_min, self.topk_two_stage)
        fn = self._step_cache.get(cache_key)
        if fn is None:
            fn = self._build_step(
                n_pad, keep, run_next, first, include_sim, n_true=n_true
            )
            self._step_cache[cache_key] = fn
        if first:
            # dummy replicated state keeps the jitted signature uniform
            p = self.par_set.npar
            prev_state = (
                jnp.zeros((1, p), self.dtype),
                jnp.ones((1,), self.dtype),
                jnp.ones((p,), self.dtype),
            )
        self.dispatches += 1
        res = fn(key, params, second, *prev_state)
        if split and n_next > 0:
            # split-propose phase: its own program, same step key -> same
            # draws as the fused proposal (see propose())
            nxt, nxt_seeds = self.propose(
                key, res.survivor_params, res.weights,
                res.doubled_variance, n_next,
            )
            res = dataclasses.replace(
                res, next_params=nxt, next_seeds=nxt_seeds
            )
        return res

    def _propose_local(
        self, key, shard, surv_par, w, dv, *, local_next, n_next, keep,
    ):
        """Shard-local proposal of the next generation: weighted resample +
        truncated perturbation + fresh per-particle seeds
        (src/AbcSmc.cpp:479-553). Shared by the fused step and the
        standalone :meth:`propose` program so both produce IDENTICAL draws
        for the same step key at any given shape."""
        k_shard = jax.random.fold_in(key, shard)
        k_pick, k_noise, k_seed = jax.random.split(k_shard, 3)
        cdf = jnp.cumsum(w)
        if self.resample_method == "systematic":
            # one GLOBAL offset (derived from the replicated key, not the
            # shard-folded one) so the strata tile the whole population:
            # shard s covers points (s*local_next + i + u) / n_next.
            # Strata count is the TRUE next size - padding rows clamp into
            # the last stratum (they're masked downstream); dividing by
            # the padded size instead would leave the top pad/n_pad slice
            # of cumulative weight reachable only by masked rows, biasing
            # survivors late in CDF order low.
            # double fold-in: a disjoint derivation path from the
            # per-shard keys fold_in(key, shard), so no shard index can
            # alias the offset stream
            u_g = jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(key, 131071), 0),
                (), self.dtype,
            )
            g2 = jnp.minimum(
                shard * local_next + jnp.arange(local_next), n_next - 1
            )
            # split-index arithmetic: adding u_g to a large f32 index
            # would quantize the offset away above ~2^22 rows
            pts = _stratum_points(g2, u_g, cdf[-1] / n_next, self.dtype)
            if local_next >= self.sorted_pick_min:
                # the strata ascend mathematically, but f32 rounding in
                # _stratum_points' block arithmetic can invert neighbors by
                # a few ulps across its 4096-index boundaries at >= ~2^23
                # rows; _sorted_searchsorted requires ascending queries, so
                # project onto monotone first (a <= few-ulp correction on
                # the handful of inverted points - statistically invisible,
                # and a no-op wherever pts is already sorted)
                pts = jax.lax.cummax(pts)
                pick = _sorted_searchsorted(cdf, pts, local_next)
            else:
                pick = jnp.minimum(
                    jnp.searchsorted(cdf, pts, method="sort"), keep - 1
                )
        else:
            if local_next >= self.sorted_pick_min:
                # big-N multinomial: draw the uniforms ALREADY SORTED via
                # exponential spacings (u_(i) = S_i / S_{n+1}, S = cumsum of
                # iid Exp(1) - the exact joint law of sorted iid uniforms),
                # then resolve picks with K-1 binary searches + a
                # scatter/cumsum expansion instead of sorting the queries:
                # searchsorted(method="sort") sorts the [ln2] query vector,
                # an O(N log N) pass this avoids (identical picks up to
                # exact f32 ties, ~4e-5 of rows, each off by one adjacent
                # survivor). The next population lands ordered by parent
                # CDF position - a pure permutation of the multinomial
                # multiset (the same ordering systematic resampling always
                # produced); every downstream statistic is
                # permutation-invariant.
                e = jax.random.exponential(
                    k_pick, (local_next + 1,), self.dtype
                )
                s = jnp.cumsum(e)
                u = (s[:-1] / s[-1]) * cdf[-1]
                pick = _sorted_searchsorted(cdf, u, local_next)
            else:
                # inverse-CDF categorical: 9x faster than Gumbel-max at
                # 1M x 50k
                u = jax.random.uniform(
                    k_pick, (local_next,), self.dtype
                ) * cdf[-1]
                pick = jnp.minimum(
                    jnp.searchsorted(cdf, u, method="sort"), keep - 1
                )
        mu = surv_par[pick]
        if self.noise_type == NoiseType.MULTIVARIATE:
            smean = jnp.mean(surv_par, axis=0)
            centered = surv_par - smean[None, :]
            # explicit full-f32 dot + n-1 divisor: mirrors
            # ops.resample.setup_mvn_sampler exactly (GSL's
            # gsl_ran_multivariate_gaussian_vcov divides by M-1 despite the
            # reference's "maximum likelihood" comment, src/AbcUtil.cpp:471-473;
            # bf16 input rounding injects ~1e-2 into the covariance, so the
            # ABCSMC_MATMUL_PRECISION opt-out must not touch this dot)
            sigma = jnp.matmul(
                centered.T, centered, precision=jax.lax.Precision.HIGHEST
            ) / max(keep - 1, 1)
            sigma = sigma + jnp.diag(jnp.diag(sigma))
            L = jnp.linalg.cholesky(sigma)
            nxt = self.par_set.noise_multivariate(
                k_noise, mu, L, self.max_retries
            )
        else:
            nxt = self.par_set.noise_independent(
                k_noise, mu, dv, self.max_retries
            )
        nxt_seeds = jax.random.randint(
            k_seed, (local_next,), 0, np.iinfo(np.int32).max
        ).astype(jnp.uint32)
        return nxt.astype(self.dtype), nxt_seeds

    # candidate-gather payload (bytes/device) above which the two-stage
    # top-K pays for itself: the distance-only gather is (P+M)/2-fold
    # lighter and the row psum is mesh-size-independent, but at small
    # payloads the single gather is one fused collective and strictly
    # simpler. 16 MiB ~ the 8-device x 50k-keep dengue shape's 33 MiB
    # gather (docs/SCALING.md) comfortably above, 1-device runs always
    # below (they take the single-stage path by the ndev > 1 condition).
    _TOPK_TWO_STAGE_BYTES = 16 * 2**20

    def _topk_two_stage_active(self, keep: int, local_n: int) -> bool:
        """True when the global top-K runs as two stages (docs/SCALING.md
        'What rides the interconnect'): all_gather the candidate DISTANCES
        (+ local row indices) only, replicate the global top-K decision,
        then assemble the K survivor rows with one mesh-size-independent
        psum (each shard contributes exactly its own winners, zeros
        elsewhere). Per-device traffic drops from O(ndev*K*(P+M)) gather
        bytes to O(ndev*K*8) + O(K*(P+M)) - the 22x lever the round-3
        review asked for at pod-scale keeps. Bit-identical to the
        single-stage path: the same top_k runs on the same gathered
        distance vector, so ties break identically, and the psum adds
        exact zeros to exact row values."""
        if self.topk_two_stage is not None:
            return bool(self.topk_two_stage)
        if self.ndev <= 1:
            return False
        k_local = min(keep, local_n)
        itemsize = jnp.dtype(self.dtype).itemsize
        payload = (
            self.ndev * k_local
            * (self.par_set.npar + len(self.obs)) * itemsize
        )
        return payload >= self._TOPK_TWO_STAGE_BYTES

    def split_propose_active(self, n: int, n_next: int) -> bool:
        """True when a step at (n, n_next) runs its proposal as a separate
        program (``propose_split``; auto: either per-shard slice >=
        ``split_threshold`` rows, where the rank-phase inputs plus the
        proposal's buffers would fill half the device's memory if they
        coexisted). The engine checks this to sequence rank -> mirror ->
        free -> propose itself at memory-bound shapes."""
        if n_next <= 0:
            return False
        if self.propose_split is not None:
            return bool(self.propose_split)
        if self.split_threshold is None:
            return False
        ln2 = self._padded(n_next) // self.ndev
        return max(self._padded(n) // self.ndev, ln2) >= self.split_threshold

    def propose(self, key, surv_par, weights, doubled_variance, n_next: int):
        """Propose the next generation as its OWN sharded program (the
        split-propose phase): inputs are the replicated survivor state, the
        outputs are the sharded ``(next_params, next_seeds)`` buffers.

        With the same step ``key``, this produces draws IDENTICAL to the
        fused step's proposal (both run :meth:`_propose_local` with the same
        replicated key and survivor state). Splitting lowers peak memory at
        very large shapes: the rank-phase temporaries and the [ln2, P]
        proposal buffers never coexist."""
        n_next_pad = self._padded(n_next)
        local_next = n_next_pad // self.ndev
        keep = int(surv_par.shape[0])
        cache_key = ("propose", keep, n_next, self.sorted_pick_min)
        fn = self._step_cache.get(cache_key)
        if fn is None:
            def local_prop(key, surv_par, w, dv):
                shard = jax.lax.axis_index(AXIS)
                # n_next stays the TRUE size (systematic strata parity with
                # the fused step); only local_next uses the padded buffer
                return self._propose_local(
                    key, shard, surv_par, w, dv,
                    local_next=local_next, n_next=n_next, keep=keep,
                )

            rep = P()
            fn = jax.jit(jax.shard_map(
                local_prop, mesh=self.mesh,
                in_specs=(rep, rep, rep, rep),
                out_specs=(P(AXIS), P(AXIS)),
                check_vma=False,
            ))
            self._step_cache[cache_key] = fn
        self.dispatches += 1
        return fn(key, surv_par, weights, doubled_variance)

    def _build_step(
        self, n: int, keep: int, n_next: int, first: bool,
        include_sim: bool = True, n_true: int | None = None,
    ):
        ndev = self.ndev
        local_n = n // ndev
        n_true = n if n_true is None else n_true
        n_next_pad = self._padded(n_next)
        local_next = n_next_pad // ndev
        n_train = min(
            max(int(n_true * self.training_fraction + 0.5), 1), n_true - 1
        )
        npar = self.par_set.npar
        nmet = len(self.obs)
        max_comp = min(n_train - 1, nmet)
        if self.max_pls_components:
            max_comp = min(max_comp, self.max_pls_components)
        max_comp = max(max_comp, 1)
        k_local = min(keep, local_n)
        two_stage = self._topk_two_stage_active(keep, local_n)
        # NB: closure constants stay as host numpy arrays - embedding a device
        # array in a later trace forces a device fetch at compile time
        obs = np.asarray(self.obs, jax.dtypes.canonicalize_dtype(self.dtype))
        use_pls = self.filter_type == FilterType.PLS
        # Box-Cox is a ranking-side transform only (host parity: the engine
        # applies it inside ranking_pls, never for SIMPLE filtering, and
        # stored/survivor metrics stay raw)
        use_box_cox = self.box_cox and use_pls
        bc_lambdas = stats_mod.box_cox_lambda_grid()
        eps = float(1e-30)
        # ---- big-N row chunking ----
        # Above a few tens of millions of rows per shard the [ln, M] z-score
        # buffer and the [ln, A] score matrix dominate device memory.
        # Chunked mode streams every O(N)-row pass (moments, Grams,
        # distances) through lax.scan blocks with O(row_bs) temporaries:
        # only the raw metric matrix and the [ln] distance vector stay
        # resident (Box-Cox, when enabled, is applied per block on the
        # fly). The algebra is identical, so results match to
        # reduction-order rounding.
        if self.row_block is None:
            # auto: chunk once the resident row passes would fill their
            # share of device memory (row_chunk_threshold, a bytes rule)
            use_chunked = (
                self.row_chunk_threshold is not None
                and local_n >= self.row_chunk_threshold
            )
            row_bs = 1 << 21
        elif self.row_block > 0:
            use_chunked = True
            row_bs = self.row_block
        else:
            use_chunked = False
        if use_chunked:
            row_bs = min(row_bs, local_n)
            n_blocks = -(-local_n // row_bs)

        def local_step(key, params_l, second_l, prev_par, prev_w, prev_dv):
            shard = jax.lax.axis_index(AXIS)

            if include_sim:
                # ---- simulate (model space) ----
                seeds_l = second_l
                upars_l = self.transform.to_model_space(params_l).astype(
                    self.dtype
                )
                mets_l = self.simulator.batch_fn(upars_l, seeds_l).astype(
                    self.dtype
                )
            else:
                mets_l = second_l.astype(self.dtype)

            gidx = shard * local_n + jnp.arange(local_n)
            # padding rows (global index >= n_true) are excluded from every
            # statistic; they only exist to square the buffer over the mesh
            vmask = (gidx < n_true).astype(self.dtype)[:, None]   # [ln, 1]

            if use_chunked:
                # block starts: the last block is shifted back when row_bs
                # does not divide local_n, so blocks can overlap; `fresh`
                # (local idx >= i*row_bs) de-counts overlap rows, which the
                # previous block already accumulated
                starts = jnp.asarray(
                    np.minimum(
                        np.arange(n_blocks) * row_bs, local_n - row_bs
                    ),
                    jnp.int32,
                )
                fresh_lo = jnp.asarray(
                    np.arange(n_blocks) * row_bs, jnp.int32
                )

                def raw_rows(start, flo):
                    lidx = start + jnp.arange(row_bs, dtype=jnp.int32)
                    g = shard * local_n + lidx
                    fresh = lidx >= flo
                    mb = jax.lax.dynamic_slice_in_dim(
                        mets_l, start, row_bs, 0
                    )
                    pb = jax.lax.dynamic_slice_in_dim(
                        params_l, start, row_bs, 0
                    )
                    return g, fresh, mb, pb

            if use_box_cox:
                # ---- Box-Cox each metric column + observed row, on device
                # (host rule: ranking.apply_box_cox / stats.optimize_box_cox;
                # the reference left this as a TODO, src/AbcUtil.cpp:430).
                # Shift to positivity by the GLOBAL column min (incl. obs),
                # then pick each column's lambda by |skewness| over the fixed
                # grid. Moments are two-pass central psums - raw third
                # moments cancel catastrophically at f32.
                lam_grid = jnp.asarray(bc_lambdas, self.dtype)     # [L]

                def bc(v, lam):
                    lam_safe = jnp.where(lam == 0, 1.0, lam)
                    return jnp.where(
                        lam == 0, jnp.log(v),
                        (jnp.power(v, lam) - 1.0) / lam_safe,
                    )

                if use_chunked:
                    # blocked variants of the same three passes; overlap rows
                    # are harmless in a min and `fresh`-masked in the sums
                    def pass_min(carry, xs):
                        g, _, mb, _ = raw_rows(*xs)
                        vinf_b = jnp.where(
                            (g < n_true)[:, None], mb,
                            jnp.asarray(jnp.inf, self.dtype),
                        )
                        return jnp.minimum(
                            carry, jnp.min(vinf_b, axis=0)
                        ), None

                    cmin, _ = jax.lax.scan(
                        pass_min,
                        jnp.full((nmet,), jnp.inf, self.dtype),
                        (starts, fresh_lo),
                    )
                    col_min = jax.lax.pmin(cmin, AXIS)
                else:
                    vinf = jnp.where(
                        vmask > 0, mets_l, jnp.asarray(jnp.inf, self.dtype)
                    )
                    col_min = jax.lax.pmin(jnp.min(vinf, axis=0), AXIS)
                col_min = jnp.minimum(col_min, obs)
                shift = jnp.where(col_min <= 0, 1e-6 - col_min, 0.0)

                if use_chunked:
                    # padding rows are real draws NOT bounded by the
                    # valid-row min; left unclamped, log/pow of their
                    # (possibly <= 0) shifted values would produce NaN, and
                    # 0 * NaN = NaN would poison the masked moment sums
                    def shifted(g, mb):
                        return jnp.where(
                            (g < n_true)[:, None], mb + shift[None, :], 1.0
                        )

                    nlam = len(bc_lambdas)
                    zl = jnp.zeros((nlam, nmet), self.dtype)

                    def pass_bc1(carry, xs):
                        g, fresh, mb, _ = raw_rows(*xs)
                        vmf = (
                            (g < n_true) & fresh
                        ).astype(self.dtype)[:, None]
                        v_b = shifted(g, mb)

                        def inner(_, lam):
                            return None, jnp.sum(bc(v_b, lam) * vmf, axis=0)

                        _, sums = jax.lax.scan(inner, None, lam_grid)
                        return carry + sums, None

                    bs1, _ = jax.lax.scan(pass_bc1, zl, (starts, fresh_lo))
                    bc_mean = jax.lax.psum(bs1, AXIS) / n_true

                    def pass_bc2(carry, xs):
                        g, fresh, mb, _ = raw_rows(*xs)
                        vmf = (
                            (g < n_true) & fresh
                        ).astype(self.dtype)[:, None]
                        v_b = shifted(g, mb)

                        def inner(_, lm):
                            lam, mu = lm
                            d = (bc(v_b, lam) - mu[None, :]) * vmf
                            return None, (
                                jnp.sum(d * d, axis=0),
                                jnp.sum(d * d * d, axis=0),
                            )

                        _, (i2, i3) = jax.lax.scan(
                            inner, None, (lam_grid, bc_mean)
                        )
                        return (carry[0] + i2, carry[1] + i3), None

                    (bs2, bs3), _ = jax.lax.scan(
                        pass_bc2, (zl, zl), (starts, fresh_lo)
                    )
                else:
                    v_l = jnp.where(vmask > 0, mets_l + shift[None, :], 1.0)

                    def bc_pass1(_, lam):
                        return None, jnp.sum(bc(v_l, lam) * vmask, axis=0)

                    _, bs1 = jax.lax.scan(bc_pass1, None, lam_grid)  # [L, M]
                    bc_mean = jax.lax.psum(bs1, AXIS) / n_true

                    def bc_pass2(_, xs):
                        lam, mu = xs
                        d = (bc(v_l, lam) - mu[None, :]) * vmask
                        return None, (
                            jnp.sum(d * d, axis=0),
                            jnp.sum(d * d * d, axis=0),
                        )

                    _, (bs2, bs3) = jax.lax.scan(
                        bc_pass2, None, (lam_grid, bc_mean)
                    )
                bvar = jax.lax.psum(bs2, AXIS) / (n_true - 1)
                bthird = jax.lax.psum(bs3, AXIS) / n_true
                skew = jnp.where(
                    bvar == 0, 0.0, bthird / jnp.power(bvar, 1.5)
                )
                # extreme lambdas can overflow the f32 moments to inf/NaN;
                # argmin treats NaN as minimal, so disqualify them explicitly
                askew = jnp.where(
                    jnp.isfinite(skew), jnp.abs(skew), jnp.inf
                )
                lam_c = lam_grid[jnp.argmin(askew, axis=0)]          # [M]
                if not use_chunked:
                    rank_mets_l = bc(v_l, lam_c[None, :])
                obs_eff = bc(obs + shift, lam_c)
            else:
                rank_mets_l = mets_l
                obs_eff = obs

            # z-scoring moments accumulate in TWO frames at once - shifted
            # around a replicated pre-center c (observed vector for metrics;
            # prior / previous-survivor means for parameters) AND raw - with
            # the per-column frame whose n*mu^2 term lost fewer f32 bits
            # selected post-psum (_dual_moment_stats). A single one-pass
            # formula cancels catastrophically in one regime or the other:
            # raw fails at |mean| >> sd (epi-count metrics at 1e5 scale
            # zero the sd), shifted fails at |mean - c| >> sd (a misfit
            # model simulating far from obs). The host rule
            # (stats.colwise_stdev) is two-pass; device-vs-host agreement
            # in BOTH hostile regimes is pinned by tests/test_sharded.py::
            # test_large_mean_metric_moments_f32 / test_far_obs_moments_f32.
            c_met = obs_eff
            if use_pls:
                c_par = (
                    jnp.asarray(
                        np.nan_to_num(
                            self.par_set.means(), posinf=0.0, neginf=0.0
                        ),
                        self.dtype,
                    )
                    if first
                    else jnp.mean(prev_par, axis=0)
                )

            if use_chunked:
                def rank_rows(g, mb):
                    """Ranking-space metric block: Box-Cox applied on the
                    fly (no [ln, M] transformed buffer is ever resident)."""
                    if use_box_cox:
                        return bc(shifted(g, mb), lam_c[None, :])
                    return mb

                def block_rows(start, flo):
                    g, fresh, mb, pb = raw_rows(start, flo)
                    return g, fresh, rank_rows(g, mb), pb

                def pass_moments(carry, xs):
                    g, fresh, mb, pb = block_rows(*xs)
                    vm = ((g < n_true) & fresh).astype(self.dtype)[:, None]
                    md_b = (mb - c_met[None, :]) * vm
                    mr_b = mb * vm
                    a = (
                        carry[0] + jnp.sum(md_b, axis=0),
                        carry[1] + jnp.sum(md_b * md_b, axis=0),
                        carry[2] + jnp.sum(mr_b, axis=0),
                        carry[3] + jnp.sum(mr_b * mb, axis=0),
                    )
                    if not use_pls:
                        # SIMPLE filter never consumes parameter moments -
                        # keep the dead reads structurally absent
                        return a, None
                    pd_b = (pb - c_par[None, :]) * vm
                    pr_b = pb * vm
                    return a + (
                        carry[4] + jnp.sum(pd_b, axis=0),
                        carry[5] + jnp.sum(pd_b * pd_b, axis=0),
                        carry[6] + jnp.sum(pr_b, axis=0),
                        carry[7] + jnp.sum(pr_b * pb, axis=0),
                    ), None

                zm = jnp.zeros((nmet,), self.dtype)
                zp0 = jnp.zeros((npar,), self.dtype)
                carry0 = (
                    (zm,) * 4 + (zp0,) * 4 if use_pls else (zm,) * 4
                )
                acc, _ = jax.lax.scan(
                    pass_moments, carry0, (starts, fresh_lo)
                )
                s1, s2, s1r, s2r = (
                    jax.lax.psum(a, AXIS) for a in acc[:4]
                )
                if use_pls:
                    p1, p2, p1r, p2r = acc[4:8]
            else:
                # ---- global metric moments (one fused psum round, DUAL
                # shifted/raw accumulators - see _dual_moment_stats) ----
                md = (rank_mets_l - c_met[None, :]) * vmask
                mr = rank_mets_l * vmask
                s1 = jax.lax.psum(jnp.sum(md, axis=0), AXIS)
                s2 = jax.lax.psum(jnp.sum(md * md, axis=0), AXIS)
                s1r = jax.lax.psum(jnp.sum(mr, axis=0), AXIS)
                s2r = jax.lax.psum(jnp.sum(mr * rank_mets_l, axis=0), AXIS)
            mean, sd, obs_delta = _dual_moment_stats(
                s1, s2, s1r, s2r, c_met, n_true
            )
            # constant column -> unit scale (same conscious fix as
            # ranking._guard_sd; a tiny-eps floor would blow obs_z up to ~1e30
            # and swamp every informative column)
            # (written as ~(sd > eps) so a NaN sd maps to unit scale too
            # instead of poisoning every z-score)
            sd = jnp.where(~(sd > eps), 1.0, sd)
            if not use_chunked:
                zmet_l = (rank_mets_l - mean) / sd
            # obs_delta is obs_eff - mean without re-rounding the large
            # c + dmean sum (c_met == obs_eff)
            obs_z = obs_delta / sd

            if use_pls:
                # ---- global parameter moments (same dual scheme) ----
                if use_chunked:
                    p1, p2, p1r, p2r = (
                        jax.lax.psum(a, AXIS) for a in (p1, p2, p1r, p2r)
                    )
                else:
                    pd = (params_l - c_par[None, :]) * vmask
                    pr = params_l * vmask
                    p1 = jax.lax.psum(jnp.sum(pd, axis=0), AXIS)
                    p2 = jax.lax.psum(jnp.sum(pd * pd, axis=0), AXIS)
                    p1r = jax.lax.psum(jnp.sum(pr, axis=0), AXIS)
                    p2r = jax.lax.psum(jnp.sum(pr * params_l, axis=0), AXIS)
                pmean, psd, _ = _dual_moment_stats(
                    p1, p2, p1r, p2r, c_par, n_true
                )
                psd = jnp.where(~(psd > eps), 1.0, psd)

                if use_chunked:
                    # ---- train + held-out z-Grams in one blocked pass ----
                    # T-space test Grams factor through R: Tt'Tt = R'(X_te'
                    # X_te)R and Tt'Y_te = R'(X_te'Y_te), so the CV needs no
                    # [ln, A] score matrix either
                    def pass_grams(carry, xs):
                        g, fresh, mb, pb = block_rows(*xs)
                        zb = (mb - mean) / sd
                        zpb = (pb - pmean) / psd
                        tr = ((g < n_train) & fresh).astype(
                            self.dtype
                        )[:, None]
                        te = (
                            (g >= n_train) & (g < n_true) & fresh
                        ).astype(self.dtype)[:, None]
                        xm_b = zb * tr
                        xt_b = zb * te
                        xtx_a, xty_a, xtx_t, xty_t, yty_a = carry
                        return (
                            xtx_a + _hdot(xm_b.T, xm_b),
                            xty_a + _hdot(xm_b.T, zpb * tr),
                            xtx_t + _hdot(xt_b.T, xt_b),
                            xty_t + _hdot(xt_b.T, zpb * te),
                            yty_a + jnp.sum(zpb * zpb * te, axis=0),
                        ), None

                    zmm = jnp.zeros((nmet, nmet), self.dtype)
                    zmp = jnp.zeros((nmet, npar), self.dtype)
                    (xtx, xty, xtx_te, xty_te, yty), _ = jax.lax.scan(
                        pass_grams,
                        (zmm, zmp, zmm, zmp, jnp.zeros((npar,), self.dtype)),
                        (starts, fresh_lo),
                    )
                    xtx = jax.lax.psum(xtx, AXIS)
                    xty = jax.lax.psum(xty, AXIS)
                    xtx_te = jax.lax.psum(xtx_te, AXIS)
                    xty_te = jax.lax.psum(xty_te, AXIS)
                    yty = jax.lax.psum(yty, AXIS)
                    R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)
                    G = _hdot(R.T, xty_te)                        # [A, p]
                    H = _hdot(_hdot(R.T, xtx_te), R)              # [A, A]
                else:
                    zpar_l = (params_l - pmean) / psd

                    # ---- PLS fit on the training rows (Gram psums) ----
                    train = (gidx < n_train).astype(self.dtype)[:, None]
                    xm = zmet_l * train
                    xtx = jax.lax.psum(_hdot(xm.T, xm), AXIS)
                    xty = jax.lax.psum(_hdot(xm.T, zpar_l * train), AXIS)
                    R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)

                    # ---- NEW_DATA CV on the test rows, via Grams ----
                    # PRESS[a,j] = sum_i test_i (y_ij - sum_{c<=a} T_ic Q_jc)^2
                    # expands to diag(Y'Y) - 2 prefix_c(Q.T * T'Y)
                    #           + prefix2d_cc'(T'T * Q_jc Q_jc'), all on the
                    # tiny test-set Grams - no [N, A, p] residual tensors ever
                    # touch HBM (they dominated this step's bandwidth at 1M
                    # particles).
                    T_l = _hdot(zmet_l, R)                        # [ln, A]
                    test = vmask - train  # held-out rows, padding excluded
                    Tt = T_l * test
                    G = jax.lax.psum(_hdot(Tt.T, zpar_l * test), AXIS)  # [A, p]
                    H = jax.lax.psum(_hdot(Tt.T, Tt), AXIS)             # [A, A]
                    yty = jax.lax.psum(
                        jnp.sum(zpar_l * zpar_l * test, axis=0), AXIS
                    )                                               # [p]
                QT = Q.T                                          # [A, p]
                term2 = 2.0 * jnp.cumsum(G * QT, axis=0)
                Z = H[:, :, None] * QT[:, None, :] * QT[None, :, :]
                S = jnp.diagonal(
                    jnp.cumsum(jnp.cumsum(Z, axis=0), axis=1),
                    axis1=0, axis2=1,
                ).T                                               # [A, p]
                press = yty[None, :] - term2 + S

                if self.pls_optimal_method == "vdv":
                    # van der Voet randomization test, distributed: the
                    # T-statistics are row sums, so per-shard partials psum.
                    # Per-row squared errors are only needed here, and only on
                    # HELD-OUT rows; the capped window is taken from the TAIL
                    # of each shard's slice, where its held-out rows live
                    # (training rows are the first n_train GLOBAL indices).
                    # When the cap is not binding the window covers every
                    # held-out row of the shard and the statistic is exact;
                    # at least one held-out row is always in some shard's
                    # window (n_train <= n_true - 1 by construction).
                    # Round-2 regression: subsampling the *head* of each
                    # shard selected ZERO held-out rows whenever
                    # (ndev-1)*local_n + cap <= n_train - e.g. any
                    # single-chip population with n_train > vdv_max_rows -
                    # silently collapsing selection to 1 component.
                    cap = max(-(-int(self.vdv_max_rows) // ndev), 1)
                    nsub = min(local_n, cap)
                    # window [start, start+nsub) ends at the last valid row
                    # of the shard; rows below n_train (training) or >= hi
                    # (padding) inside it carry test == 0, so they contribute
                    # exact zeros to every sum
                    hi = jnp.clip(n_true - shard * local_n, 0, local_n)
                    start = jnp.maximum(hi - nsub, 0)
                    g_s = shard * local_n + start + jnp.arange(nsub)
                    if use_chunked:
                        # z-score + project just the window rows (no [ln, A]
                        # or [ln, p] z-buffers exist in chunked mode)
                        mb_s = rank_rows(
                            g_s,
                            jax.lax.dynamic_slice_in_dim(
                                mets_l, start, nsub, axis=0
                            ),
                        )
                        t_s = _hdot((mb_s - mean) / sd, R)        # [ns, A]
                        zp_s = (
                            jax.lax.dynamic_slice_in_dim(
                                params_l, start, nsub, axis=0
                            ) - pmean
                        ) / psd
                        test_s = (
                            (g_s >= n_train) & (g_s < n_true)
                        ).astype(self.dtype)[:, None]             # [ns, 1]
                    else:
                        t_s = jax.lax.dynamic_slice_in_dim(
                            T_l, start, nsub, axis=0
                        )                                         # [ns, A]
                        zp_s = jax.lax.dynamic_slice_in_dim(
                            zpar_l, start, nsub, axis=0
                        )
                        test_s = jax.lax.dynamic_slice_in_dim(
                            test, start, nsub, axis=0
                        )                                         # [ns, 1]
                    # signs are a pure function of (key, permutation, GLOBAL
                    # row index): the selection is layout-invariant and, when
                    # the cap is not binding, EQUALS the host rule
                    # ops.pls.optimal_num_components_vdv on the same data
                    sgn = pls_mod.vdv_signs(
                        pls_mod.vdv_seed(key), self.vdv_permutations, g_s,
                        self.dtype,
                    )
                    # moment expansion: every statistic here has the form
                    #   S_w[a,j] = sum_n w_n test_n (zp_nj - sum_{b<=a} t_nb QT_bj)^2
                    # for w = 1 (observed) and w = each sign row; expanding
                    # the square turns the whole permutation test into ONE
                    # [K+1, ns] @ [ns, p + A*p + A*A] matmul plus a tiny
                    # [K+1, A, p] prefix-sum recombination, in place of a
                    # direct [ns, A, p] cumsum/residual/gather chain with p
                    # as its narrow minor dimension.
                    tm = t_s * test_s                             # [ns, A]
                    zpm = zp_s * test_s                           # [ns, p]
                    rhs = jnp.concatenate([
                        zpm * zp_s,                               # [ns, p]
                        (t_s[:, :, None] * zpm[:, None, :]
                         ).reshape(nsub, max_comp * npar),        # [ns, A*p]
                        (t_s[:, :, None] * tm[:, None, :]
                         ).reshape(nsub, max_comp * max_comp),    # [ns, A*A]
                    ], axis=1)
                    W = jnp.concatenate(
                        [jnp.ones((1, nsub), self.dtype), sgn], axis=0
                    )                                             # [K1, ns]
                    # MISCOMPILE GUARD: on XLA:TPU, fusing the production of
                    # these operands (the 3-way-product reshapes above) into
                    # the HIGHEST-precision dot made the dot read wrong
                    # operand data - the observed row of U came back
                    # NEGATIVE in its sum-of-squares section (U0 = sum
                    # test*zp^2 >= 0 by construction), collapsing ncomp to
                    # 1 at the 1M shape (ns = 131072). This barrier pins
                    # W/rhs as materialized buffers so the dot cannot fuse
                    # with their producers; it is an identity on every
                    # backend. Whether XLA:GPU has the same fault is checked
                    # by chip_smoke.py's step phase (ncomp_used > 1 and
                    # chunked == resident selection at 1M rows).
                    U = jax.lax.psum(
                        _vdv_moment_dot(W, rhs), AXIS
                    )                                             # [K1, p+Ap+AA]
                    U0 = U[:, :npar]                              # [K1, p]
                    # RUNTIME SELF-CHECK (every run, every backend): the
                    # observed row of U0 is sum_n test_n * zp_n^2 - a sum of
                    # non-negative f32 terms, which NO rounding order can
                    # drive negative. A negative entry is exactly the
                    # fingerprint of the fusion miscompile the barrier above
                    # works around (wrong operand data fed
                    # into the dot; docs/DESIGN.md "The vdv fusion
                    # miscompile"). If a future XLA upgrade re-fuses past the
                    # barrier, this flag fires in-program: the generation's
                    # reported ncomp_used is NEGATED, which the engine
                    # (run_device) and chip_smoke.py turn into a hard error
                    # instead of silently degraded selection.
                    u0_bad = jnp.min(U0[0]) < 0
                    U1 = U[:, npar:npar + max_comp * npar].reshape(
                        -1, max_comp, npar
                    )                                             # [K1, A, p]
                    U2 = U[:, npar + max_comp * npar:].reshape(
                        -1, max_comp, max_comp
                    )                                             # [K1, A, A]
                    term1 = jnp.cumsum(QT[None] * U1, axis=1)     # [K1, A, p]
                    Z2 = (U2[:, :, :, None] * QT[None, :, None, :]
                          * QT[None, None, :, :])                 # [K1,A,A,p]
                    S2 = jnp.moveaxis(
                        jnp.diagonal(
                            jnp.cumsum(jnp.cumsum(Z2, axis=1), axis=2),
                            axis1=1, axis2=2,
                        ), -1, 1,
                    )                                             # [K1, A, p]
                    S = U0[:, None, :] - 2.0 * term1 + S2         # [K1, A, p]
                    best = jnp.argmin(press, axis=0)              # [p]
                    Sb = jnp.take_along_axis(
                        S, jnp.broadcast_to(
                            best[None, None, :], (S.shape[0], 1, npar)
                        ), axis=1,
                    )                                             # [K1, 1, p]
                    tstat = S - Sb                                # [K1, A, p]
                    pvals = jnp.mean(
                        jnp.abs(tstat[1:]) >= jnp.abs(tstat[0])[None],
                        axis=0,
                    )
                    ok = pvals > 0.25
                else:
                    u0_bad = None
                    min_press = jnp.min(press, axis=0)
                    ok = press <= 1.1 * min_press[None, :]
                ncomp_resp = jnp.argmax(ok, axis=0) + 1
                ncomp_used = jnp.max(ncomp_resp)
                # the REPORTED count carries the miscompile flag as a sign
                # bit (ncomp_used >= 1 always, so < 0 is unambiguous);
                # ranking still uses the computed count - on a corrupted U
                # the selection is garbage either way, and the negative
                # report is what makes the run fail loudly downstream
                ncomp_report = (
                    ncomp_used if u0_bad is None
                    else jnp.where(u0_bad, -ncomp_used, ncomp_used)
                )
                col_mask = (
                    jnp.arange(max_comp) < ncomp_used
                ).astype(self.dtype)[None, :]

                obs_scores = _hdot(obs_z, R) * col_mask[0]
                if use_chunked:
                    def pass_dist(d_acc, xs):
                        _, _, mb, _ = block_rows(*xs)
                        tb = _hdot((mb - mean) / sd, R) * col_mask
                        db = jnp.sqrt(jnp.sum(
                            (tb - obs_scores[None, :]) ** 2, axis=1
                        ))
                        # overlap rows recompute identical values, so the
                        # double write is idempotent
                        return jax.lax.dynamic_update_slice(
                            d_acc, db, (xs[0],)
                        ), None

                    d_l, _ = jax.lax.scan(
                        pass_dist, jnp.zeros((local_n,), self.dtype),
                        (starts, fresh_lo),
                    )
                else:
                    scores_l = T_l * col_mask  # reuse: T_l == zmet_l @ R
                    diff = scores_l - obs_scores[None, :]
                    d_l = jnp.sqrt(jnp.sum(diff * diff, axis=1))
            else:
                if use_chunked:
                    def pass_dist_simple(d_acc, xs):
                        _, _, mb, _ = block_rows(*xs)
                        zb = (mb - mean) / sd
                        db = jnp.sqrt(jnp.sum(
                            (zb - obs_z[None, :]) ** 2, axis=1
                        ))
                        return jax.lax.dynamic_update_slice(
                            d_acc, db, (xs[0],)
                        ), None

                    d_l, _ = jax.lax.scan(
                        pass_dist_simple, jnp.zeros((local_n,), self.dtype),
                        (starts, fresh_lo),
                    )
                else:
                    diff = zmet_l - obs_z[None, :]
                    d_l = jnp.sqrt(jnp.sum(diff * diff, axis=1))
                ncomp_report = jnp.int32(0)
            # padding rows rank last, so they can never enter the top-K
            d_l = jnp.where(gidx < n_true, d_l, jnp.asarray(jnp.inf, self.dtype))

            # ---- global top-K ----
            neg_loc, loc_idx = jax.lax.top_k(-d_l, k_local)
            cand_d = jax.lax.all_gather(-neg_loc, AXIS).reshape(-1)
            if two_stage:
                # two-stage (docs/SCALING.md): gather DISTANCES + local row
                # indices only (8 B/candidate), replicate the global top-K
                # decision, then assemble the K survivor rows with one
                # psum whose payload is mesh-size-INDEPENDENT: each shard
                # contributes exactly the rows it owns, zeros elsewhere.
                # Bit-identical to the single-stage path (same top_k on the
                # same cand_d; psum adds exact zeros), pinned by
                # tests/test_sharded.py::test_topk_two_stage_equivalence.
                cand_lidx = jax.lax.all_gather(loc_idx, AXIS).reshape(-1)
                _, pos = jax.lax.top_k(-cand_d, keep)
                owner = pos // k_local                  # [K] owning shard
                slot = cand_lidx[pos]                   # [K] local row there
                # gidx[loc_idx] == shard * local_n + loc_idx, so the global
                # index reconstructs exactly without gathering it
                surv_gidx = (owner * local_n + slot).astype(gidx.dtype)
                mine = (owner == shard)[:, None]
                zero = jnp.zeros((), self.dtype)
                surv_par = jax.lax.psum(
                    jnp.where(mine, params_l[slot], zero), AXIS
                )                                       # [K, P] replicated
                surv_met = jax.lax.psum(
                    jnp.where(mine, mets_l[slot], zero), AXIS
                )
            else:
                # single-stage: gather full candidate rows, re-top-k
                # (payload O(ndev * K * (P+M)) - the right choice at small
                # meshes/keeps where one fused gather beats two collectives)
                cand_par = jax.lax.all_gather(
                    params_l[loc_idx], AXIS
                ).reshape(-1, npar)
                cand_met = jax.lax.all_gather(
                    mets_l[loc_idx], AXIS
                ).reshape(-1, nmet)
                cand_gidx = jax.lax.all_gather(gidx[loc_idx], AXIS).reshape(-1)
                _, pos = jax.lax.top_k(-cand_d, keep)
                surv_par = cand_par[pos]                # [K, P] replicated
                surv_met = cand_met[pos]
                surv_gidx = cand_gidx[pos]

            # ---- doubled variance + weights (replicated small math) ----
            smean = jnp.mean(surv_par, axis=0)
            dv = 2.0 * jnp.sum(
                (surv_par - smean[None, :]) ** 2, axis=0
            ) / max(keep - 1, 1)

            if first:
                w = jnp.full((keep,), 1.0 / keep, self.dtype)
            else:
                # shard the survivor (query) axis of the O(K*M) weight kernel:
                # each device computes weights for its slice of survivors,
                # then an all_gather reassembles the replicated vector
                k_per = -(-keep // ndev)
                pad = k_per * ndev - keep
                surv_pad = jnp.pad(surv_par, ((0, pad), (0, 0)), mode="edge")
                my_rows = jax.lax.dynamic_slice(
                    surv_pad,
                    (shard.astype(jnp.int32) * k_per, jnp.int32(0)),
                    (k_per, npar),
                )
                log_num = self.par_set.prior_log_pdf(my_rows).astype(
                    self.dtype
                )
                log_den = weights_mod.log_kernel_mixture_density(
                    my_rows, prev_par, jnp.log(prev_w), prev_dv,
                    block=min(2048, max(prev_par.shape[0], 1)),
                )
                log_w = jax.lax.all_gather(
                    log_num - log_den, AXIS
                ).reshape(-1)[:keep]
                log_w = log_w - jnp.max(log_w)
                w = jnp.exp(log_w)
                w = w / jnp.sqrt(jnp.sum(w * w))  # L2-normalize (parity quirk)

            if local_next == 0:
                # final generation: no next set is proposed (the reference
                # likewise only proposes while sets remain,
                # src/AbcSmc.cpp:520-529); skipping it removes an O(N2)
                # resample+perturb from the last step
                outs = (
                    d_l, surv_gidx, surv_par, surv_met, w, dv, ncomp_report,
                )
                # metrics-precomputed steps do NOT return mets_l: it is a
                # verbatim passthrough of an input, which XLA materializes
                # as a full [ln, M] output copy (observed 640 MB of HBM +
                # bandwidth at 10M rows). The wrapper reattaches the
                # caller's own buffer instead.
                return ((mets_l,) + outs) if include_sim else outs

            # ---- propose next generation, shard-locally ----
            nxt, nxt_seeds = self._propose_local(
                key, shard, surv_par, w, dv,
                local_next=local_next, n_next=n_next, keep=keep,
            )

            outs = (
                d_l, surv_gidx, surv_par, surv_met, w, dv,
                nxt, nxt_seeds, ncomp_report,
            )
            return ((mets_l,) + outs) if include_sim else outs

        sharded = P(AXIS)
        rep = P()
        if local_next == 0:
            out_specs = (
                sharded, sharded, rep, rep, rep, rep, rep, rep
            )
        else:
            out_specs = (
                sharded, sharded, rep, rep, rep, rep, rep, sharded, sharded, rep
            )
        if not include_sim:
            out_specs = out_specs[1:]   # mets_l is not a program output
        mapped = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(rep, sharded, sharded, rep, rep, rep),
            out_specs=out_specs,
            check_vma=False,
        )

        jitted = jax.jit(mapped)

        if local_next == 0:
            empty_par = jnp.zeros((0, npar), self.dtype)
            empty_seeds = jnp.zeros((0,), jnp.uint32)

            def step_fn(key, params, seeds, prev_par, prev_w, prev_dv):
                outs = jitted(key, params, seeds, prev_par, prev_w, prev_dv)
                if not include_sim:
                    # reattach the caller's metric buffer (identical values;
                    # the program does not return the [ln, M] passthrough)
                    outs = (seeds.astype(self.dtype),) + tuple(outs)
                return GenerationResult(
                    *outs[:7], empty_par, empty_seeds, outs[7]
                )
        else:
            def step_fn(key, params, seeds, prev_par, prev_w, prev_dv):
                outs = jitted(key, params, seeds, prev_par, prev_w, prev_dv)
                if not include_sim:
                    outs = (seeds.astype(self.dtype),) + tuple(outs)
                return GenerationResult(*outs)

        return step_fn

    # ------------------------------------------------------------------ fused run
    def run_scan(
        self, key, n: int, keep: int, gens: int, full_history: bool = False,
    ):
        """ALL generations as ONE jitted program: generation 0 inline, the
        remaining ``gens - 1`` generations as a ``lax.scan`` over the fused
        step.

        Back-to-back async dispatches of the sequential :meth:`run` loop
        already pipeline, so the point is not wall-clock; use run_scan when
        the whole chain must be a single XLA program (embedding SMC inside a larger jitted computation,
        serializing one executable, or backends that serialize dispatches).

        Constant shapes only (one ``n``, one ``keep`` - the scan carry must
        be uniform); the reference's quick-start runs 30 such generations
        (examples/reference.json). The key-split chain replicates
        :meth:`run`, so results match the sequential path exactly.

        Returns ``(result, history)``: ``result`` is the last generation's
        :class:`GenerationResult` (its ``next_*`` buffers are the unused
        proposal), ``history`` is a pytree of per-generation stacked
        survivor data ``(survivor_idx [G,K], survivor_params [G,K,P],
        survivor_metrics [G,K,M], weights [G,K], doubled_variance [G,P],
        ncomp_used [G])``. With ``full_history=True`` three more leaves are
        appended — the FULL per-generation populations ``(params [G,Npad,P],
        seeds [G,Npad], metrics [G,Npad,M])`` (rows past ``n`` are padding) —
        enough to mirror every generation into the run store without any
        other device round trip. That costs ``gens * n_pad * (P + M + 1)``
        extra HBM words; callers gate it by size (engine.run_device does).
        """
        assert gens >= 1
        n_pad = self._padded(n)
        cache_key = ("scan", n_pad, n, keep, gens, full_history,
                     self.sorted_pick_min, self.topk_two_stage)
        fn = self._step_cache.get(cache_key)
        if fn is None:
            # traced-through step programs (jit-of-jit inlines)
            first_fn = self._build_step(
                n_pad, keep, n, first=True, include_sim=True, n_true=n
            )
            later_fn = self._build_step(
                n_pad, keep, n, first=False, include_sim=True, n_true=n
            )
            p = self.par_set.npar

            def whole(key):
                # replicate run()'s split chain exactly
                key, k0 = jax.random.split(key)
                kts = []
                for _ in range(gens):
                    key, kt = jax.random.split(key)
                    kts.append(kt)
                params, seeds = self.init_population(k0, n)
                dummy = (
                    jnp.zeros((1, p), self.dtype),
                    jnp.ones((1,), self.dtype),
                    jnp.ones((p,), self.dtype),
                )
                res0 = first_fn(kts[0], params, seeds, *dummy)

                def ys_of(res, pop_params, pop_seeds):
                    base = (
                        res.survivor_idx, res.survivor_params,
                        res.survivor_metrics, res.weights,
                        res.doubled_variance, res.ncomp_used,
                    )
                    if full_history:
                        base += (pop_params, pop_seeds, res.metrics)
                    return base

                def body(carry, kt):
                    params, seeds, prev = carry
                    res = later_fn(kt, params, seeds, *prev)
                    prev2 = (
                        res.survivor_params, res.weights,
                        res.doubled_variance,
                    )
                    # default ys are K-sized (full_history opts in to the
                    # gens * N * M HBM cost of stacking whole populations)
                    return (res.next_params, res.next_seeds, prev2), ys_of(
                        res, params, seeds
                    )

                if gens == 1:
                    history = jax.tree_util.tree_map(
                        lambda x: x[None], ys_of(res0, params, seeds)
                    )
                    return res0, history
                carry0 = (
                    res0.next_params, res0.next_seeds,
                    (res0.survivor_params, res0.weights,
                     res0.doubled_variance),
                )
                parts = [
                    jax.tree_util.tree_map(
                        lambda x: x[None], ys_of(res0, params, seeds)
                    )
                ]
                if gens > 2:
                    carry0, ys_mid = jax.lax.scan(
                        body, carry0, jnp.stack(kts[1:-1])
                    )
                    parts.append(ys_mid)
                params_l, seeds_l, prev_l = carry0
                last = later_fn(kts[-1], params_l, seeds_l, *prev_l)
                parts.append(
                    jax.tree_util.tree_map(
                        lambda x: x[None], ys_of(last, params_l, seeds_l)
                    )
                )
                history = jax.tree_util.tree_map(
                    lambda *xs: jnp.concatenate(xs, axis=0), *parts
                )
                return last, history

            fn = jax.jit(whole)
            self._step_cache[cache_key] = fn
        self.dispatches += 1
        return fn(key)

    # ------------------------------------------------------------- chained run
    def run_chain(
        self, key, set_sizes: list[int], keep_sizes: list[int],
        full_history: bool = False, bucketed_history: bool = False,
    ):
        """A varying-size schedule as FEW jitted programs: maximal runs of
        consecutive sets with constant (n, keep) whose successor size equals
        n collapse into ONE ``lax.scan`` dispatch; size-transition sets
        dispatch singly. The reference quick-start schedule
        ``[300, 500, 500, 750, 1000]`` extended to 30 sets
        (examples/reference.json:2-4) runs as 5 programs instead of 30 -
        the dispatch-latency fix that ``run_scan`` (uniform sizes only)
        could not give it.

        The key-split chain replicates the sequential loop exactly
        (``key, k0 = split(key)`` then one split per set), so results match
        ``engine.run_device``'s per-set path bit-for-bit on CPU.

        Returns ``(state, history)``: ``state`` is the final
        (survivor_params, weights, doubled_variance); ``history`` is a LIST
        (one entry per set) of tuples ``(survivor_idx, survivor_params,
        survivor_metrics, weights, doubled_variance, ncomp_used[, params,
        seeds, metrics])`` - run_scan's per-generation layout, with device
        arrays (scanned buckets yield stacked slices).

        ``bucketed_history=True`` returns the history UNSLICED instead: a
        list of ``("set", tuple)`` / ``("bucket", L, ys)`` entries, ``ys``
        carrying the scan's stacked ``[L, ...]`` leaves. Per-set device
        slicing of a scanned bucket costs L x leaves tiny slice programs
        plus as many per-leaf fetches, whose round trips dominated the
        engine's mirror phase of a 30-set quick-start; the bucketed form lets the caller fetch each bucket's stacked leaves
        in ONE transfer and slice in host numpy (engine.run_device)."""
        G = len(set_sizes)
        assert G >= 1 and len(keep_sizes) == G
        key, k0 = jax.random.split(key)
        kts = []
        for _ in range(G):
            key, kt = jax.random.split(key)
            kts.append(kt)
        params, seeds = self.init_population(k0, set_sizes[0])

        def ys_of(res, pop_params, pop_seeds):
            base = (
                res.survivor_idx, res.survivor_params, res.survivor_metrics,
                res.weights, res.doubled_variance, res.ncomp_used,
            )
            if full_history:
                base += (pop_params, pop_seeds, res.metrics)
            return base

        def scannable(u: int, n_t: int, keep_t: int) -> bool:
            # a set joins an n_t-bucket when its own shape matches AND its
            # successor (= the scan body's static proposal size) is n_t too;
            # the final set joins with a wasted n_t-sized proposal, which
            # costs less than one extra dispatch at these small sizes
            return (
                set_sizes[u] == n_t and keep_sizes[u] == keep_t
                and (u + 1 >= G or set_sizes[u + 1] == n_t)
            )

        state = None
        history = []
        t = 0
        while t < G:
            n_t, keep_t = set_sizes[t], keep_sizes[t]
            n_next = set_sizes[t + 1] if t + 1 < G else 0
            L = 1
            if state is not None and scannable(t, n_t, keep_t):
                while t + L < G and scannable(t + L, n_t, keep_t):
                    L += 1
            if L > 1 and int(state[0].shape[0]) != keep_t:
                # the incoming survivor state is sized by the PREVIOUS set's
                # keep; a lax.scan carry must be shape-uniform, so peel the
                # bucket's first set as a single dispatch (after it the
                # state is [keep_t]-shaped and the rest of the bucket scans)
                L = 1
            if L == 1:
                res = self.step(
                    kts[t], params, seeds, keep_t, n_next, state,
                    n_valid=n_t,
                )
                entry = ys_of(res, params, seeds)
                history.append(("set", entry) if bucketed_history else entry)
                state = (
                    res.survivor_params, res.weights, res.doubled_variance
                )
                params, seeds = res.next_params, res.next_seeds
            else:
                n_pad = self._padded(n_t)
                ck = ("chain", n_pad, n_t, keep_t, L, full_history,
                      self.sorted_pick_min, self.topk_two_stage)
                fn = self._step_cache.get(ck)
                if fn is None:
                    later_fn = self._build_step(
                        n_pad, keep_t, n_t, first=False, include_sim=True,
                        n_true=n_t,
                    )

                    def bucket(kt_stack, params, seeds, s0, s1, s2):
                        def body(carry, kt):
                            params, seeds, prev = carry
                            res = later_fn(kt, params, seeds, *prev)
                            prev2 = (
                                res.survivor_params, res.weights,
                                res.doubled_variance,
                            )
                            return (
                                res.next_params, res.next_seeds, prev2
                            ), ys_of(res, params, seeds)

                        return jax.lax.scan(
                            body, (params, seeds, (s0, s1, s2)), kt_stack
                        )

                    fn = jax.jit(bucket)
                    self._step_cache[ck] = fn
                self.dispatches += 1
                carry, ys = fn(
                    jnp.stack(kts[t:t + L]), params, seeds, *state
                )
                params, seeds, state = carry
                if bucketed_history:
                    history.append(("bucket", L, ys))
                else:
                    for i in range(L):
                        history.append(
                            jax.tree_util.tree_map(lambda x, i=i: x[i], ys)
                        )
            t += L
        return state, history

    # ------------------------------------------------------------------ full run
    def run(self, key, set_sizes: list[int], keep_sizes: list[int]):
        """Convenience: run all generations on-device; returns the final
        GenerationResult plus per-generation survivor tuples."""
        key, k0 = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
        params, seeds = self.init_population(k0, set_sizes[0])
        state = None
        history = []
        result = None
        for t in range(len(set_sizes)):
            key, kt = jax.random.split(key)
            n_next = set_sizes[t + 1] if t + 1 < len(set_sizes) else 0
            result = self.step(
                kt, params, seeds, keep_sizes[t], n_next, state,
                n_valid=set_sizes[t],
            )
            state = (
                result.survivor_params, result.weights, result.doubled_variance
            )
            history.append(state)
            params, seeds = result.next_params, result.next_seeds
        return result, history


def sharded_simulate(simulator, mesh: Mesh, upars, seeds, n_valid: int):
    """Run a DeviceSimulator over the particle mesh as one SPMD program:
    model-space parameter rows are tail-padded to a mesh multiple, each shard
    simulates its slice, and the result is trimmed back to ``n_valid`` rows.

    This shards the reference's claim-and-run worker unit (the --simulate
    batch, src/AbcSmc.cpp:967-1039) and the projection sweep's simulation
    (src/AbcSmc.cpp:54-137) without any SMC math attached."""
    ndev = mesh.devices.size
    n_pad = -(-n_valid // ndev) * ndev
    upars = jnp.asarray(upars)
    seeds = jnp.asarray(seeds)
    if upars.shape[0] != n_pad:
        extra = n_pad - upars.shape[0]
        upars = jnp.concatenate([upars, jnp.repeat(upars[-1:], extra, axis=0)])
        seeds = jnp.concatenate([seeds, jnp.repeat(seeds[-1:], extra)])

    # cached per (simulator, mesh) ON the simulator: a fresh jit(shard_map(
    # lambda)) each call would defeat jit's function-identity cache and
    # re-trace/re-compile once per set on the projection sweep
    cache = getattr(simulator, "_sharded_sim_cache", None)
    if cache is None:
        cache = {}
        try:
            simulator._sharded_sim_cache = cache
        except AttributeError:  # slots/frozen simulator: uncached fallback
            cache = None
    fn = cache.get(mesh) if cache is not None else None
    if fn is None:
        fn = jax.jit(
            jax.shard_map(
                lambda u, s: simulator.batch_fn(u, s),
                mesh=mesh, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS),
                check_vma=False,
            )
        )
        if cache is not None:
            cache[mesh] = fn
    out = fn(upars, seeds)
    if jax.process_count() > 1:
        # a sharded output over a multi-process mesh is not fully
        # addressable per process; replicate (one all-gather on the mesh
        # interconnect, via the CACHED per-mesh identity - a fresh
        # jax.jit(lambda) here would re-trace/re-compile once per set) so
        # every process fetches the full matrix
        from abcsmc_tpu.parallel.mesh import replicate_ident

        out = replicate_ident(mesh)(out)
    return np.asarray(out)[:n_valid]
