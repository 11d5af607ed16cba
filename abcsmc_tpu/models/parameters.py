"""Vectorized parameter distributions.

The reference models parameters as a C++ class hierarchy sampled one scalar draw at
a time through a GSL RNG plus a stateful "odometer" (``include/AbcSmc/Parameter.h``,
``Priors.h``, ``IndexedPars.h``, ``ParRNG.h``). Here each parameter is a stateless
description whose sampling/pdf/recast operations are *vectorized pure functions* over
the whole particle axis, driven by counter-based ``jax.random`` keys; the
PSEUDO/POSTERIOR odometer state machine (``ParRNG.h:17-36``) collapses into
mixed-radix index arithmetic (see :meth:`ParameterSet.indexed_grid_values`).

Semantics preserved from the reference:

- ``recast``: INT parameters round to the nearest integer (``Priors.h:79``,
  ``Parameter.h:49-56``); FLOAT parameters pass through.
- ``valid(x) == (pdf(x) != 0)`` (``Parameter.h:74``).
- Truncated-noise draws retry up to ``max_retries`` (default 1000) and fall back to
  the *prior mean* (``Priors.h:19-33``).
- Prior means/sds: uniform mean=(a+b)/2, sd=(b-a)/sqrt(12); discrete uniform the
  same formulas (``Priors.h:63-69, 92-98`` — NB the reference uses the continuous
  sd formula for the discrete prior too; preserved here as a parity quirk).
- PSEUDO/POSTERIOR parameters abort on likelihood/recast in the reference
  (``IndexedPars.h:20-28``); here those raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from abcsmc_tpu.config import DistType, NumType, ParameterSpec
from abcsmc_tpu.errors import ConfigError

_LOG_2PI = math.log(2.0 * math.pi)


def default_float():
    """float64 when jax x64 is enabled (CPU parity runs), else float32 (GPU)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# --------------------------------------------------------------------------- #
# Individual parameter types
# --------------------------------------------------------------------------- #

class Parameter:
    """Base parameter. Concrete types implement vectorized sample/log_pdf/recast."""

    is_posterior: bool = False
    state_size: int = 0  # 0 == not an indexed (PSEUDO/POSTERIOR) parameter

    def __init__(self, name: str, short_name: str | None = None):
        self.name = name
        self.short_name = short_name if short_name else name

    # -- interface -----------------------------------------------------------
    def sample(self, key, n: int):
        raise NotImplementedError

    def log_pdf(self, x):
        raise NotImplementedError

    def pdf(self, x):
        return jnp.exp(self.log_pdf(x))

    def recast(self, x):
        return x

    def valid(self, x):
        return jnp.isfinite(self.log_pdf(x))

    def get_mean(self) -> float:
        return math.nan

    def get_sd(self) -> float:
        return math.nan

    def noise_support(self) -> tuple[float, float]:
        """The x-interval on which ``recast(x)`` is valid — i.e. the acceptance
        region of the reference's rejection loop (Priors.h:19-33). Truncating a
        normal to this interval (inverse-CDF) draws from exactly the
        distribution the rejection loop accepts."""
        raise NotImplementedError

    def value_bounds(self) -> tuple[float, float]:
        """Closed interval of valid *post-recast* values (used to clip away
        float overshoot of the inverse-CDF back-transform; a few ulps past
        the bound would otherwise produce a particle outside prior support,
        which the rejection loop could never emit)."""
        return self.noise_support()


class _IntRecastMixin:
    """INT parameters flatten to the nearest integer (Parameter.h:49-56)."""

    def recast(self, x):
        return jnp.round(x)


class GaussianPrior(Parameter):
    """Priors.h:46-60."""

    def __init__(self, name, mean, sd, short_name=None):
        super().__init__(name, short_name)
        self.mean = float(mean)
        self.sd = float(sd)

    def sample(self, key, n: int):
        return self.mean + self.sd * jax.random.normal(key, (n,), default_float())

    def log_pdf(self, x):
        z = (x - self.mean) / self.sd
        return -0.5 * z * z - math.log(self.sd) - 0.5 * _LOG_2PI

    def get_mean(self):
        return self.mean

    def get_sd(self):
        return self.sd

    def noise_support(self):
        return (-math.inf, math.inf)


class ContinuousUniformPrior(Parameter):
    """Priors.h:85-110."""

    def __init__(self, name, min_val, max_val, short_name=None):
        super().__init__(name, short_name)
        if not min_val < max_val:
            # a coded error, not an assert: the reference's Priors.h:95
            # assert vanishes under NDEBUG and a reversed interval then
            # yields NaN importance weights silently
            raise ConfigError(
                f"UNIFORM parameter '{name}': par1 ({min_val}) must be < "
                f"par2 ({max_val}).",
                code=1,
            )
        self.min_val = float(min_val)
        self.max_val = float(max_val)

    def sample(self, key, n: int):
        return jax.random.uniform(
            key, (n,), default_float(), self.min_val, self.max_val
        )

    def log_pdf(self, x):
        in_range = (self.min_val <= x) & (x <= self.max_val)
        return jnp.where(
            in_range, -math.log(self.max_val - self.min_val), -jnp.inf
        )

    def get_mean(self):
        return (self.max_val + self.min_val) / 2.0

    def get_sd(self):
        return (self.max_val - self.min_val) / math.sqrt(12.0)

    def noise_support(self):
        return (self.min_val, self.max_val)


class DiscreteUniformPrior(_IntRecastMixin, Parameter):
    """Priors.h:62-83. Integer uniform on [min, max] inclusive.

    NB (parity quirk): the reference computes sd with the *continuous* uniform
    formula (max-min)/sqrt(12) rather than sqrt(((max-min+1)^2 - 1)/12).
    """

    def __init__(self, name, min_val, max_val, short_name=None):
        super().__init__(name, short_name)
        if not min_val < max_val:
            # same coded error as ContinuousUniformPrior (Priors.h:69)
            raise ConfigError(
                f"UNIFORM INT parameter '{name}': par1 ({min_val}) must be "
                f"< par2 ({max_val}).",
                code=1,
            )
        self.min_val = int(min_val)
        self.max_val = int(max_val)

    def sample(self, key, n: int):
        draws = jax.random.randint(key, (n,), self.min_val, self.max_val + 1)
        return draws.astype(default_float())

    def log_pdf(self, x):
        is_integral = x == jnp.round(x)
        in_range = (self.min_val <= x) & (x <= self.max_val)
        return jnp.where(
            is_integral & in_range,
            -math.log(self.max_val - self.min_val + 1),
            -jnp.inf,
        )

    def get_mean(self):
        return (self.max_val + self.min_val) / 2.0

    def get_sd(self):
        return (self.max_val - self.min_val) / math.sqrt(12.0)

    def noise_support(self):
        # rounding maps (min-0.5, max+0.5) onto the valid integers, so this is
        # the rejection loop's acceptance region in pre-recast space
        return (self.min_val - 0.5, self.max_val + 0.5)

    def value_bounds(self):
        # post-recast values are the integers themselves; clipping to them
        # also covers the exact-boundary case where jnp.round's half-to-even
        # would give max+1 (odd max) from x == max+0.5
        return (float(self.min_val), float(self.max_val))


class PseudoParameter(Parameter):
    """Enumerated grid parameter (IndexedPars.h:32-43). Sequentially swept, never
    randomly sampled; asking for a pdf is an error (IndexedPars.h:20-28)."""

    def __init__(self, name, values: Sequence[float], short_name=None):
        super().__init__(name, short_name)
        assert len(values) > 0
        self.values = tuple(float(v) for v in values)
        self.state_size = len(self.values)

    def sample(self, key, n: int):
        raise ConfigError(
            f"it is an error to randomly sample an indexed parameter: {self.name}"
        )

    def log_pdf(self, x):
        raise ConfigError(
            f"it is an error to ask for likelihood from an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )

    def recast(self, x):
        raise ConfigError(
            f"it is an error to attempt to recast an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )


class PosteriorParameter(Parameter):
    """Rank-indexed parameter whose values come from a previous run's posterior
    (IndexedPars.h:45-55). ``sample`` yields the *rank index*; values are filled
    from the posterior matrix by the sampler (src/AbcUtil.cpp:510-523)."""

    is_posterior = True

    def __init__(self, name, size: int, short_name=None):
        super().__init__(name, short_name)
        assert size > 0
        self.state_size = int(size)

    def sample(self, key, n: int):
        raise ConfigError(
            f"it is an error to randomly sample an indexed parameter: {self.name}"
        )

    def log_pdf(self, x):
        raise ConfigError(
            f"it is an error to ask for likelihood from an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )

    def recast(self, x):
        raise ConfigError(
            f"it is an error to attempt to recast an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )


def parameter_from_spec(spec: ParameterSpec) -> Parameter:
    if spec.dist_type == DistType.UNIFORM:
        if spec.num_type == NumType.INT:
            return DiscreteUniformPrior(
                spec.name, spec.par1, spec.par2, spec.short_name
            )
        return ContinuousUniformPrior(
            spec.name, spec.par1, spec.par2, spec.short_name
        )
    if spec.dist_type == DistType.NORMAL:
        return GaussianPrior(spec.name, spec.par1, spec.par2, spec.short_name)
    if spec.dist_type == DistType.PSEUDO:
        return PseudoParameter(spec.name, spec.values, spec.short_name)
    if spec.dist_type == DistType.POSTERIOR:
        return PosteriorParameter(spec.name, spec.posterior_size, spec.short_name)
    raise ConfigError(f"unknown dist_type {spec.dist_type}", code=-205)


# --------------------------------------------------------------------------- #
# ParameterSet: the vectorized, whole-population view
# --------------------------------------------------------------------------- #

@dataclass(eq=False)  # identity hash: instances are jit static args
class ParameterSet:
    """Operations over the full parameter vector, vectorized on the particle axis.

    Column conventions follow the reference: a particle is a row; parameter columns
    are in config order. Values live in *fitting space* (the space priors, kernels,
    weights, and ranking operate in); model-space transforms are applied separately
    (:mod:`abcsmc_tpu.models.transforms`).
    """

    params: list[Parameter]

    def __post_init__(self):
        self.npar = len(self.params)
        self.prior_idx = [
            i for i, p in enumerate(self.params)
            if p.state_size == 0
        ]
        self.pseudo_idx = [
            i for i, p in enumerate(self.params)
            if p.state_size > 0 and not p.is_posterior
        ]
        self.posterior_idx = [
            i for i, p in enumerate(self.params) if p.is_posterior
        ]
        self.posterior_size = (
            self.params[self.posterior_idx[0]].state_size
            if self.posterior_idx else 0
        )
        # static per-column INT mask for recast
        self._int_cols = np.array(
            [isinstance(p, _IntRecastMixin) for p in self.params], dtype=bool
        )

    @classmethod
    def from_specs(cls, specs: Sequence[ParameterSpec]) -> "ParameterSet":
        return cls([parameter_from_spec(s) for s in specs])

    # -- summary vectors -------------------------------------------------------
    def means(self) -> np.ndarray:
        return np.array([p.get_mean() for p in self.params])

    def sds(self) -> np.ndarray:
        return np.array([p.get_sd() for p in self.params])

    def names(self) -> list[str]:
        return [p.name for p in self.params]

    def short_names(self) -> list[str]:
        return [p.short_name for p in self.params]

    # -- gen-0 sampling ---------------------------------------------------------
    def indexed_grid_values(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Enumerate PSEUDO grids + POSTERIOR rank indices for samples 0..n-1.

        Replaces the ParRNG odometer (ParRNG.h:17-36, semantics exercised at
        src/AbcUtil.cpp:515-521) with mixed-radix index arithmetic: per sample
        exactly one unlock happens, so the *first* pseudo parameter (in config
        order) is the fastest-varying digit, subsequent pseudo parameters roll
        over odometer-style, and the posterior index advances only when every
        pseudo grid rolls over (i.e. it is the most significant digit).

        Returns (pseudo_vals[n, n_pseudo], post_ranks[n] or empty).
        """
        i = np.arange(n, dtype=np.int64)
        pseudo_vals = np.zeros((n, len(self.pseudo_idx)))
        radix = 1
        for col, pidx in enumerate(self.pseudo_idx):
            par = self.params[pidx]
            size = par.state_size
            digits = (i // radix) % size
            pseudo_vals[:, col] = np.asarray(par.values)[digits]
            radix *= size
        if self.posterior_idx:
            post_ranks = (i // radix) % self.posterior_size
        else:
            post_ranks = np.zeros((0,), dtype=np.int64)
        return pseudo_vals, post_ranks

    def sample_priors(
        self, key, n: int, posterior_matrix: np.ndarray | None = None
    ) -> tuple[jnp.ndarray, np.ndarray]:
        """Generation-0 / projection sampling (src/AbcUtil.cpp:490-526).

        Random draws for prior parameters, mixed-radix enumeration for
        PSEUDO/POSTERIOR ones. Returns (samples[n, npar], post_ranks[n] or empty).
        """
        cols = [None] * self.npar
        if self.prior_idx:
            keys = jax.random.split(key, len(self.prior_idx))
            for k, idx in zip(keys, self.prior_idx):
                cols[idx] = self.params[idx].sample(k, n)
        pseudo_vals, post_ranks = self.indexed_grid_values(n)
        for col, idx in enumerate(self.pseudo_idx):
            cols[idx] = jnp.asarray(pseudo_vals[:, col], default_float())
        if self.posterior_idx:
            if posterior_matrix is None:
                raise ConfigError(
                    "POSTERIOR parameters require a posterior matrix "
                    "(posterior_database_filename)",
                    code=-204,
                )
            pm = jnp.asarray(posterior_matrix, default_float())
            assert pm.shape[1] == len(self.posterior_idx)
            for col, idx in enumerate(self.posterior_idx):
                cols[idx] = pm[post_ranks, col]
        samples = jnp.stack(cols, axis=1)
        return samples, post_ranks

    # -- densities / recast / validity -------------------------------------------
    def _require_all_priors(self, what: str):
        if self.pseudo_idx or self.posterior_idx:
            bad = self.params[(self.pseudo_idx + self.posterior_idx)[0]]
            raise ConfigError(
                f"it is an error to ask for {what} with indexed (PSEUDO/POSTERIOR) "
                f"parameters present; attempted on {bad.name}",
                code=-1,
            )

    def prior_log_pdf(self, theta) -> jnp.ndarray:
        """Sum over columns of prior log density: the numerator of the SMC weight
        (src/AbcUtil.cpp:556-561)."""
        self._require_all_priors("likelihood")
        theta = jnp.asarray(theta)
        lps = [self.params[i].log_pdf(theta[:, i]) for i in range(self.npar)]
        return jnp.sum(jnp.stack(lps, axis=1), axis=1)

    def recast(self, theta) -> jnp.ndarray:
        """Round INT columns to integers (vectorized Parameter::recast)."""
        theta = jnp.asarray(theta)
        if not self._int_cols.any():
            return theta
        mask = jnp.asarray(self._int_cols)
        return jnp.where(mask[None, :], jnp.round(theta), theta)

    def valid_mask(self, theta) -> jnp.ndarray:
        """Per-cell validity: prior support membership (Parameter.h:74)."""
        self._require_all_priors("validity")
        theta = jnp.asarray(theta)
        cols = [self.params[i].valid(theta[:, i]) for i in range(self.npar)]
        return jnp.stack(cols, axis=1)

    # -- perturbation (truncated noise) -------------------------------------------
    @partial(jax.jit, static_argnums=(0, 4, 5))
    def noise_independent(
        self, key, mu, doubled_variance, max_retries: int = 1000,
        method: str = "inverse_cdf",
    ):
        """Vectorized truncated-normal perturbation.

        The reference draws x ~ N(mu, sqrt(dv)) per particle and parameter,
        recasts, and retries while invalid, falling back to the prior mean
        after ``max_retries`` (src/AbcUtil.cpp:145-158 + Priors.h:19-33).

        ``method="inverse_cdf"`` (default) samples the identical distribution
        directly: a truncated standard normal on the acceptance region
        (``Parameter.noise_support``) in ONE fused pass - no data-dependent
        retry loop, ~5x fewer RNG draws at 1M particles, and no mean-fallback
        edge case (the exact conditional is sampled even where the rejection
        loop would give up). ``method="rejection"`` keeps the reference's loop
        semantics, including the fallback quirk, as a masked
        ``lax.while_loop``.
        """
        self._require_all_priors("noise")
        mu = jnp.asarray(mu)
        sigma = jnp.sqrt(jnp.asarray(doubled_variance, mu.dtype))

        if method == "inverse_cdf":
            # per-column (pre-recast lo, hi) and (post-recast vlo, vhi)
            bounds = [p.noise_support() + p.value_bounds()
                      for p in self.params]
            lo, hi, vlo, vhi = (
                jnp.asarray(col, mu.dtype) for col in zip(*bounds)
            )
            live = sigma > 0
            safe_sigma = jnp.where(live, sigma, 1.0)
            a = (lo[None, :] - mu) / safe_sigma[None, :]
            b = (hi[None, :] - mu) / safe_sigma[None, :]
            z = jax.random.truncated_normal(key, a, b, mu.shape, mu.dtype)
            x = self.recast(mu + z * safe_sigma[None, :])
            # clip away float overshoot of the back-transform: truncated_normal
            # keeps z inside (a, b), but a/b and mu + z*sigma are each rounded,
            # so x can land a few ulps outside support when mu hugs a bound
            # with small sigma - a particle the rejection loop could never emit
            x = jnp.clip(x, vlo[None, :], vhi[None, :])
            # converged columns (dv == 0): zero noise, keep mu (the reference
            # adds N(0, 0) there)
            return jnp.where(live[None, :], x, mu)

        def draw(k):
            eps = jax.random.normal(k, mu.shape, mu.dtype)
            return self.recast(mu + eps * sigma[None, :])

        def cond(state):
            _, accepted, _, attempts = state
            return (~jnp.all(accepted)) & (attempts < max_retries)

        def body(state):
            vals, accepted, k, attempts = state
            k, sub = jax.random.split(k)
            prop = draw(sub)
            ok = self.valid_mask(prop)
            vals = jnp.where(~accepted & ok, prop, vals)
            accepted = accepted | ok
            return vals, accepted, k, attempts + 1

        key, sub = jax.random.split(key)
        init_vals = draw(sub)
        init_acc = self.valid_mask(init_vals)
        vals, accepted, _, _ = jax.lax.while_loop(
            cond, body, (init_vals, init_acc, key, jnp.int32(1))
        )
        prior_means = jnp.asarray(self.means(), mu.dtype)
        return jnp.where(accepted, vals, prior_means[None, :])

    @partial(jax.jit, static_argnums=(0, 4))
    def noise_multivariate(self, key, mu, chol_lower, max_retries: int = 1000):
        """Vectorized truncated multivariate-normal perturbation.

        Draw x ~ MVN(mu_i, L L^T), recast each column, accept the whole row only if
        every column is valid; retry rejected rows (src/AbcUtil.cpp:122-143).
        The reference loops forever; we bound at ``max_retries`` and fall back to
        the sampled particle mean (documented deviation — the unbounded loop is
        not expressible under jit and risks hanging in the reference too).
        """
        self._require_all_priors("noise")
        mu = jnp.asarray(mu)
        L = jnp.asarray(chol_lower, mu.dtype)

        def draw(k):
            eps = jax.random.normal(k, mu.shape, mu.dtype)
            # explicit full-f32: the ABCSMC_MATMUL_PRECISION opt-out must
            # not round the proposal covariance's Cholesky application
            return self.recast(mu + jnp.matmul(
                eps, L.T, precision=jax.lax.Precision.HIGHEST
            ))

        def cond(state):
            _, accepted, _, attempts = state
            return (~jnp.all(accepted)) & (attempts < max_retries)

        def body(state):
            vals, accepted, k, attempts = state
            k, sub = jax.random.split(k)
            prop = draw(sub)
            ok = jnp.all(self.valid_mask(prop), axis=1)
            vals = jnp.where((~accepted & ok)[:, None], prop, vals)
            accepted = accepted | ok
            return vals, accepted, k, attempts + 1

        key, sub = jax.random.split(key)
        init_vals = draw(sub)
        init_acc = jnp.all(self.valid_mask(init_vals), axis=1)
        vals, accepted, _, _ = jax.lax.while_loop(
            cond, body, (init_vals, init_acc, key, jnp.int32(1))
        )
        return jnp.where(accepted[:, None], vals, mu)
