"""Simulator adapters.

The reference supports three ways to bind a simulator (include/AbcSmc/AbcSim.h):
a function compiled in (AbcFPtrBase, :61-114), a dlopen'd shared object exporting
``simulator`` (:96-114), and an external executable exec'd per particle with
parameters as argv and metrics parsed from stdout (AbcExec, :120-157). All three
run one particle at a time on the host.

Here the primary path is a fourth kind the reference cannot express: a
**device simulator** - a pure JAX function ``f(params[P], key) -> metrics[M]``
that is vmapped/jitted (and mesh-sharded) over the entire particle population on
the accelerator. Host-bound simulators (executable / shared library / python callable) are
retained for black-box legacy models, with the reference's per-particle seed
replay semantics.
"""

from __future__ import annotations

import ctypes
import shlex
import subprocess
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from abcsmc_tpu.errors import SimulatorError


class Simulator:
    """Base adapter: maps (model-space params, per-particle seeds, serials) to a
    metrics matrix."""

    #: True when run_batch is a traced JAX computation usable inside jit/shard_map
    is_device = False

    def run_batch(
        self, params: np.ndarray, seeds: np.ndarray, serials: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError


class DeviceSimulator(Simulator):
    """Vectorized on-device simulator.

    ``fn(params[P], key) -> metrics[M]`` is a pure JAX function; per-particle
    randomness derives from a counter-based key folded from the stored particle
    seed, preserving the reference's per-particle replayability
    (src/AbcSmc.cpp:535-537, 859-860: the seed blob in the par table).
    """

    is_device = True

    def __init__(self, fn: Callable, nmet: int | None = None):
        self.fn = fn
        self.nmet = nmet
        self._batch = jax.jit(jax.vmap(self._one))

    def _one(self, params, seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        return self.fn(params, key)

    def batch_fn(self, params, seeds):
        """Traceable batched form for use inside jitted generation steps."""
        return jax.vmap(self._one)(params, seeds)

    def run_batch(self, params, seeds, serials):
        mets = self._batch(
            jnp.asarray(params), jnp.asarray(np.asarray(seeds, np.uint32))
        )
        return np.asarray(mets, np.float64)


class PySimulator(Simulator):
    """Host python callable, one particle at a time:
    ``f(params: list[float], seed: int, serial: int) -> list[float]``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def run_batch(self, params, seeds, serials):
        rows = []
        for row, seed, serial in zip(params, seeds, serials):
            met = self.fn([float(v) for v in row], int(seed), int(serial))
            rows.append(np.asarray(met, np.float64))
        return _stack_checked(rows)


class ExecSimulator(Simulator):
    """External executable: ``cmd p1 p2 ... pP`` per particle; metrics are
    whitespace-separated doubles on stdout (AbcSim.h:120-157).

    The reference appends parameters to the command line and slurps stdout; the
    RNG seed is *not* passed (the child is expected to self-seed) - we preserve
    that, but also export ABC_RNG_SEED / ABC_SERIAL in the environment so
    deterministic children can opt in."""

    def __init__(self, command: str):
        self.command = command

    def run_one(self, row: Sequence[float], seed: int, serial: int) -> np.ndarray:
        args = shlex.split(self.command) + [repr(float(v)) for v in row]
        import os
        env = dict(os.environ)
        env["ABC_RNG_SEED"] = str(int(seed))
        env["ABC_SERIAL"] = str(int(serial))
        try:
            out = subprocess.run(
                args, capture_output=True, text=True, env=env, check=True
            ).stdout
        except (subprocess.CalledProcessError, OSError) as e:
            raise SimulatorError(f"executable simulator failed: {e}", code=-211)
        try:
            return np.array([float(tok) for tok in out.split()], np.float64)
        except ValueError:
            raise SimulatorError(
                f"could not parse metrics from simulator stdout: {out!r}",
                code=-211,
            )

    def run_batch(self, params, seeds, serials):
        rows = [
            self.run_one(row, seed, serial)
            for row, seed, serial in zip(params, seeds, serials)
        ]
        return _stack_checked(rows)


class SharedLibSimulator(Simulator):
    """Shared-object simulator loaded with ctypes.

    Two ABIs are accepted:

    - the framework's portable C ABI:

          int abc_simulator(const double* pars, size_t npar,
                            unsigned long seed, unsigned long serial,
                            double* mets, size_t nmet);

      returning 0 on success;
    - the REFERENCE ABI: an unmangled ``simulator`` symbol of C++ type
      ``vector<double>(vector<double>, unsigned long, unsigned long)``
      (AbcSim.h:55-114). ctypes cannot call it directly, so a small C++
      adapter is compiled on demand (models/ref_shim.py) - existing
      reference simulator binaries run unmodified.

    ``nmet`` must be known up front (it is: the config's metric count)."""

    def __init__(self, soname: str, nmet: int):
        self.nmet = nmet
        self._shim = None
        self.lib = ctypes.CDLL(soname)
        try:
            self._fn = self.lib.abc_simulator
        except AttributeError:
            from abcsmc_tpu.models.ref_shim import (
                ReferenceShim, has_reference_abi,
            )

            if not has_reference_abi(soname):
                raise SimulatorError(
                    f"{soname} exports neither C symbol 'abc_simulator' nor "
                    "the reference-ABI 'simulator'", code=-211
                )
            self._shim = ReferenceShim(soname)
            self._fn = None
            return
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
            ctypes.c_ulong, ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ]

    def run_batch(self, params, seeds, serials):
        rows = []
        for row, seed, serial in zip(params, seeds, serials):
            if self._shim is not None:
                rows.append(np.asarray(
                    self._shim(row, int(seed), int(serial), self.nmet),
                    np.float64,
                ))
                continue
            pars = (ctypes.c_double * len(row))(*[float(v) for v in row])
            mets = (ctypes.c_double * self.nmet)()
            rc = self._fn(pars, len(row), int(seed), int(serial), mets, self.nmet)
            if rc != 0:
                raise SimulatorError(
                    f"shared-lib simulator returned {rc} for serial {serial}",
                    code=-211,
                )
            rows.append(np.array(list(mets), np.float64))
        return _stack_checked(rows)


def _stack_checked(rows: list[np.ndarray]) -> np.ndarray:
    if not rows:
        return np.zeros((0, 0))
    width = len(rows[0])
    for r in rows:
        if len(r) != width:
            raise SimulatorError(
                "simulator returned inconsistent metric counts", code=-211
            )
    return np.stack(rows)


# --------------------------------------------------------------------------- #
# Built-in device simulators (the reference's example models, in JAX)
# --------------------------------------------------------------------------- #

def make_dice_simulator(max_dice: int = 1000) -> DeviceSimulator:
    """The dice game (examples/include/dice.h:14-45): roll ``ndice`` dice with
    ``nsides`` faces; metrics are the sum and the per-roll sample sd (ddof=1,
    matching gsl_stats_sd). Vectorized with a static max_dice bound + masking
    (static shapes for XLA)."""

    def fn(params, key):
        n = jnp.clip(params[0], 1, max_dice).astype(jnp.int32)
        faces = jnp.maximum(params[1], 1).astype(jnp.int32)
        rolls = jax.random.randint(key, (max_dice,), 1, faces + 1).astype(
            params.dtype
        )
        mask = (jnp.arange(max_dice) < n).astype(params.dtype)
        total = jnp.sum(rolls * mask)
        mean = total / n
        ss = jnp.sum(mask * (rolls - mean) ** 2)
        sd = jnp.where(n > 1, jnp.sqrt(ss / jnp.maximum(n - 1, 1)), 0.0)
        return jnp.stack([total, sd])

    return DeviceSimulator(fn, nmet=2)


def make_gaussian_simulator(n_obs: int = 100) -> DeviceSimulator:
    """Conjugate-Gaussian toy: params = (mu, sigma); draw ``n_obs`` iid
    N(mu, sigma) samples, return (sample mean, sample sd). Used for analytic
    posterior validation (BASELINE.json configs[1])."""

    def fn(params, key):
        mu, sigma = params[0], jnp.abs(params[1])
        x = mu + sigma * jax.random.normal(key, (n_obs,), params.dtype)
        m = jnp.mean(x)
        sd = jnp.sqrt(jnp.sum((x - m) ** 2) / (n_obs - 1))
        return jnp.stack([m, sd])

    return DeviceSimulator(fn, nmet=2)


def make_sir_simulator(
    population: int = 10_000, t_steps: int = 160, i0: int = 10
) -> DeviceSimulator:
    """Stochastic discrete-time SIR (chain-binomial / Reed-Frost style), a
    One fused lax.scan over time steps.

    params = (beta, gamma) per-step rates; metrics = (final size, peak
    prevalence, peak time, epidemic duration, mean infectious duration proxy,
    half-time)."""

    def fn(params, key):
        beta = jnp.abs(params[0])
        gamma = jnp.clip(jnp.abs(params[1]), 1e-6, 1.0)
        dtype = params.dtype

        def step(carry, k):
            s, i, r = carry
            p_inf = 1.0 - jnp.exp(-beta * i / population)
            k1, k2 = jax.random.split(k)
            # gaussian approximation to the binomial keeps everything on VPU
            def binom(kk, n, p):
                mean = n * p
                sd = jnp.sqrt(jnp.maximum(n * p * (1 - p), 0.0))
                draw = mean + sd * jax.random.normal(kk, (), dtype)
                return jnp.clip(jnp.round(draw), 0.0, n)

            new_inf = binom(k1, s, p_inf)
            new_rec = binom(k2, i, 1.0 - jnp.exp(-gamma))
            s2 = s - new_inf
            i2 = i + new_inf - new_rec
            r2 = r + new_rec
            return (s2, i2, r2), (i2, new_inf)

        keys = jax.random.split(key, t_steps)
        init = (
            jnp.asarray(population - i0, dtype),
            jnp.asarray(i0, dtype),
            jnp.asarray(0, dtype),
        )
        (s, i, r), (prevalence, incidence) = jax.lax.scan(step, init, keys)
        t = jnp.arange(t_steps, dtype=dtype)
        final_size = r + i
        peak = jnp.max(prevalence)
        peak_time = t[jnp.argmax(prevalence)]
        active = (prevalence > 0).astype(dtype)
        duration = jnp.sum(active)
        total_inc = jnp.sum(incidence)
        mean_time = jnp.sum(t * incidence) / jnp.maximum(total_inc, 1.0)
        half = jnp.argmax(jnp.cumsum(incidence) >= total_inc / 2).astype(dtype)
        return jnp.stack([final_size, peak, peak_time, duration, mean_time, half])

    return DeviceSimulator(fn, nmet=6)


class HostBridgeSimulator(DeviceSimulator):
    """Bridges a host-side *batched* python simulator into jitted/sharded
    device programs via ``io_callback`` (SURVEY build plan layer 6b): the
    fused generation step pauses, ships the shard-local parameter block to the
    host, runs the black-box function, and resumes with its metrics.

    ``fn(params[n, P] np.ndarray, seeds[n] np.ndarray) -> metrics[n, M]``.
    Use for legacy simulators that can't be expressed in JAX but are cheap
    enough that host round-trips don't dominate; otherwise use the queue path
    (storage + native pool)."""

    def __init__(self, fn: Callable, nmet: int):
        self.host_fn = fn
        self.nmet = nmet

    def batch_fn(self, params, seeds):
        from jax.experimental import io_callback

        out = jax.ShapeDtypeStruct((params.shape[0], self.nmet), params.dtype)

        def cb(p, s):
            p = np.asarray(p)
            mets = np.asarray(self.host_fn(p, np.asarray(s)))
            return mets.astype(p.dtype)

        return io_callback(cb, out, params, seeds, ordered=False)

    def run_batch(self, params, seeds, serials):
        return np.asarray(
            self.host_fn(np.asarray(params, np.float64), np.asarray(seeds)),
            np.float64,
        )


def make_linear_gaussian_simulator(
    npar: int, nmet: int, noise_sd: float = 0.3, mix_seed: int = 7
) -> DeviceSimulator:
    """Linear-Gaussian surrogate: metrics = A @ params + noise, with a fixed
    random mixing matrix A. Stands in for expensive transmission models in
    scale tests (BASELINE.json configs[3], dengue-class shapes)."""
    mix = np.asarray(
        jax.random.normal(jax.random.PRNGKey(mix_seed), (npar, nmet))
    )

    def fn(params, key):
        a = jnp.asarray(mix, params.dtype)
        eps = noise_sd * jax.random.normal(key, (nmet,), params.dtype)
        return params @ a + eps

    return DeviceSimulator(fn, nmet=nmet)


def make_lotka_volterra_simulator(
    t_steps: int = 320, dt: float = 0.1, x0: float = 10.0, y0: float = 5.0,
    n_obs: int = 8, noise_sd: float = 0.5,
) -> DeviceSimulator:
    """Stochastic Lotka-Volterra predator-prey dynamics - the canonical
    ABC-SMC benchmark (Toni et al. 2009). Euler-Maruyama integration of

        dx = ( a x - x y) dt + sigma sqrt(dt) x dW1   (prey)
        dy = ( b x y - y) dt + sigma sqrt(dt) y dW2   (predator)

    params = (a, b); metrics = prey and predator abundances at ``n_obs``
    evenly spaced observation times with observation noise, i.e. 2*n_obs
    summary statistics. lax.scan over time keeps it one fused program."""

    obs_every = t_steps // n_obs

    def fn(params, key):
        a, b = params[0], params[1]
        dtype = params.dtype
        sigma = jnp.asarray(0.05, dtype)

        def step(carry, k):
            x, y = carry
            e = jax.random.normal(k, (2,), dtype)
            dx = (a * x - x * y) * dt + sigma * jnp.sqrt(dt) * x * e[0]
            dy = (b * x * y - y) * dt + sigma * jnp.sqrt(dt) * y * e[1]
            x2 = jnp.clip(x + dx, 1e-3, 1e4)
            y2 = jnp.clip(y + dy, 1e-3, 1e4)
            return (x2, y2), (x2, y2)

        k_traj, k_noise = jax.random.split(key)
        keys = jax.random.split(k_traj, t_steps)
        init = (jnp.asarray(x0, dtype), jnp.asarray(y0, dtype))
        _, (xs, ys) = jax.lax.scan(step, init, keys)
        idx = jnp.arange(1, n_obs + 1) * obs_every - 1
        obs = jnp.concatenate([xs[idx], ys[idx]])
        obs = obs + noise_sd * jax.random.normal(k_noise, obs.shape, dtype)
        return obs

    return DeviceSimulator(fn, nmet=2 * n_obs)


def make_seir_campaign_simulator(
    population: int = 100_000, t_steps: int = 365, e0: int = 20,
) -> DeviceSimulator:
    """SEIR epidemic with a vaccination campaign - a dengue-campaign-style
    model family (the reference's production use case class). params =
    (beta, sigma_incubation, gamma, vax_day_frac, vax_rate); 8 metrics:
    final size, peak prevalence, peak time, cases before/after campaign
    start, attack rate among unvaccinated, duration, half time."""

    def fn(params, key):
        dtype = params.dtype
        beta = jnp.abs(params[0])
        inc = jnp.clip(jnp.abs(params[1]), 1e-3, 1.0)     # E -> I rate
        gamma = jnp.clip(jnp.abs(params[2]), 1e-3, 1.0)   # I -> R rate
        vax_day = jnp.clip(params[3], 0.0, 1.0) * t_steps
        vax_rate = jnp.clip(jnp.abs(params[4]), 0.0, 0.05)

        def binom(kk, n, p):
            mean = n * p
            sd = jnp.sqrt(jnp.maximum(n * p * (1 - p), 0.0))
            draw = mean + sd * jax.random.normal(kk, (), dtype)
            return jnp.clip(jnp.round(draw), 0.0, n)

        def step(carry, inp):
            s, e, i, r, v = carry
            t, k = inp
            k1, k2, k3, k4 = jax.random.split(k, 4)
            p_inf = 1.0 - jnp.exp(-beta * i / population)
            new_e = binom(k1, s, p_inf)
            new_i = binom(k2, e, 1.0 - jnp.exp(-inc))
            new_r = binom(k3, i, 1.0 - jnp.exp(-gamma))
            campaign = (t >= vax_day).astype(dtype)
            new_v = binom(k4, s - new_e, campaign * vax_rate)
            s2 = s - new_e - new_v
            return (s2, e + new_e - new_i, i + new_i - new_r, r + new_r,
                    v + new_v), (i + new_i - new_r, new_i)

        keys = jax.random.split(key, t_steps)
        ts = jnp.arange(t_steps, dtype=dtype)
        init = (
            jnp.asarray(population - e0, dtype), jnp.asarray(e0, dtype),
            jnp.asarray(0, dtype), jnp.asarray(0, dtype),
            jnp.asarray(0, dtype),
        )
        (s, e, i, r, v), (prev, inc_series) = jax.lax.scan(
            step, init, (ts, keys)
        )
        total = jnp.sum(inc_series)
        before = jnp.sum(jnp.where(ts < vax_day, inc_series, 0.0))
        peak = jnp.max(prev)
        peak_t = ts[jnp.argmax(prev)]
        duration = jnp.sum((prev > 0).astype(dtype))
        half = jnp.argmax(
            jnp.cumsum(inc_series) >= total / 2
        ).astype(dtype)
        unvax = population - v
        attack_unvax = total / jnp.maximum(unvax, 1.0)
        return jnp.stack([
            r + i + e, peak, peak_t, before, total - before,
            attack_unvax, duration, half,
        ])

    return DeviceSimulator(fn, nmet=8)


def make_ricker_simulator(
    t_steps: int = 100, n0: float = 1.0, burn_in: int = 50,
) -> DeviceSimulator:
    """Ricker chaotic population map with Poisson observations - the
    canonical intractable-likelihood ABC benchmark (Wood 2010, Nature 466).

        N_{t+1} = r * N_t * exp(-N_t + sigma * e_t),  y_t ~ Poisson(phi N_t)

    params = (log_r, sigma, phi); metrics = 6 summary statistics of the
    observed series (mean, sd, autocorrelations at lags 1 and 2, #zeros,
    max). lax.scan over time; the Poisson draw uses the normal
    approximation above 10 and inverse-CDF below (static shapes, VPU)."""

    def fn(params, key):
        dtype = params.dtype
        log_r = jnp.clip(params[0], 0.0, 6.0)
        sigma = jnp.clip(jnp.abs(params[1]), 1e-3, 2.0)
        phi = jnp.clip(jnp.abs(params[2]), 1e-2, 50.0)

        def poisson(k, lam):
            # normal approx above 10, tabulated inverse-CDF below - both
            # static-shaped; the crossover error is irrelevant to summary
            # statistics at ABC tolerance
            u = jax.random.uniform(k, (), dtype)
            grid = jnp.arange(24, dtype=dtype)
            lam_s = jnp.minimum(lam, 20.0)
            logpmf = grid * jnp.log(jnp.maximum(lam_s, 1e-9)) - lam_s - (
                jax.lax.lgamma(grid + 1.0)
            )
            cdf = jnp.cumsum(jnp.exp(logpmf))
            # right tail beyond the 24-point grid: argmax over all-False
            # would return 0, turning the LARGEST draws into exact zeros
            # and biasing the '#zeros' summary statistic; clamp to grid max
            idx = jnp.argmax(cdf >= u).astype(dtype)
            small = jnp.where(u > cdf[-1], jnp.asarray(23.0, dtype), idx)
            g = jax.random.normal(jax.random.fold_in(k, 1), (), dtype)
            large = jnp.round(lam + jnp.sqrt(lam) * g)
            return jnp.where(lam > 10.0, jnp.maximum(large, 0.0), small)

        def step(n, k):
            k_e, k_y = jax.random.split(k)
            e = jax.random.normal(k_e, (), dtype)
            n2 = jnp.exp(log_r) * n * jnp.exp(-n + sigma * e)
            n2 = jnp.clip(n2, 1e-9, 1e6)
            y = poisson(k_y, phi * n2)
            return n2, y

        keys = jax.random.split(key, t_steps + burn_in)
        _, ys = jax.lax.scan(step, jnp.asarray(n0, dtype), keys)
        y = ys[burn_in:]
        m = jnp.mean(y)
        sd = jnp.sqrt(jnp.maximum(jnp.var(y, ddof=1), 0.0))
        yc = y - m
        denom = jnp.maximum(jnp.sum(yc * yc), 1e-9)
        ac1 = jnp.sum(yc[1:] * yc[:-1]) / denom
        ac2 = jnp.sum(yc[2:] * yc[:-2]) / denom
        zeros = jnp.sum((y == 0).astype(dtype))
        return jnp.stack([m, sd, ac1, ac2, zeros, jnp.max(y)])

    return DeviceSimulator(fn, nmet=6)


def make_gk_simulator(n_obs: int = 500) -> DeviceSimulator:
    """g-and-k quantile distribution - the other canonical ABC benchmark
    (Rayner & MacGillivray 2002; Fearnhead & Prangle 2012): defined by its
    quantile function, so the likelihood is intractable but sampling is an
    inverse-CDF transform of normals (perfect for the VPU).

        Q(z) = A + B (1 + 0.8 tanh(g z / 2)) (1 + z^2)^k z

    params = (A, B, g, k); metrics = 8 octile-based summary statistics
    (the standard robust choice: octiles 1..7 plus the interquartile
    range)."""

    def fn(params, key):
        dtype = params.dtype
        A, B = params[0], jnp.maximum(params[1], 1e-3)
        g, k = params[2], jnp.maximum(params[3], -0.4)
        z = jax.random.normal(key, (n_obs,), dtype)
        x = A + B * (1.0 + 0.8 * jnp.tanh(g * z / 2.0)) * jnp.power(
            1.0 + z * z, k
        ) * z
        qs = jnp.quantile(x, jnp.arange(1, 8, dtype=dtype) / 8.0)
        iqr = qs[5] - qs[1]
        return jnp.concatenate([qs, iqr[None]])

    return DeviceSimulator(fn, nmet=8)


def make_mg1_simulator(n_customers: int = 50) -> DeviceSimulator:
    """M/G/1 queue - the canonical queueing ABC benchmark (Fearnhead &
    Prangle 2012, JRSS-B): customers arrive with Exp(theta3) inter-arrival
    times and receive U(theta1, theta2) service; only inter-departure times
    are observed, making the likelihood intractable.

    The textbook departure recursion ``d_i = s_i + max(a_i, d_{i-1})`` is
    sequential, but it has a closed scan-free form: with ``S_i = s_1+..+s_i``
    (and ``S_0 = 0``),

        d_i = S_i + cummax_j<=i (a_j - S_{j-1})

    so the whole trajectory is two cumsums and a cummax - fully vectorized
    on the VPU, no ``lax.scan``. params = (theta1, theta2, theta3); metrics =
    octiles 1..7 of the inter-departure times plus their mean (8 total, the
    standard robust summary choice)."""

    def fn(params, key):
        dtype = params.dtype
        lo = jnp.minimum(params[0], params[1])
        hi = jnp.maximum(params[0], params[1]) + 1e-6
        rate = jnp.clip(jnp.abs(params[2]), 1e-4, 1e3)
        k_a, k_s = jax.random.split(key)
        inter = jax.random.exponential(k_a, (n_customers,), dtype) / rate
        a = jnp.cumsum(inter)
        s = jax.random.uniform(
            k_s, (n_customers,), dtype, minval=lo, maxval=hi
        )
        y = jnp.diff(mg1_departure_times(a, s), prepend=jnp.zeros((1,), dtype))
        qs = jnp.quantile(y, jnp.arange(1, 8, dtype=dtype) / 8.0)
        return jnp.concatenate([qs, jnp.mean(y)[None]])

    return DeviceSimulator(fn, nmet=8)


def mg1_departure_times(a, s):
    """Scan-free M/G/1 departure times from arrival times ``a`` and service
    times ``s``: ``d_i = S_i + cummax_j<=i (a_j - S_{j-1})`` where
    ``S_i = s_1 + .. + s_i`` - algebraically identical to the sequential
    ``d_i = s_i + max(a_i, d_{i-1})`` recursion (pinned by test)."""
    S = jnp.cumsum(s)
    S_prev = S - s  # S_{i-1} with S_0 = 0
    return S + jax.lax.cummax(a - S_prev, axis=0)


def make_ma2_simulator(n_obs: int = 200) -> DeviceSimulator:
    """MA(2) moving-average process - the standard ABC toy model (Marin,
    Pudlo, Robert & Ryder 2012, "Approximate Bayesian computational
    methods"):

        y_t = e_t + theta1 e_{t-1} + theta2 e_{t-2},  e_t ~ N(0, 1)

    identifiable on the invertibility triangle (-2 < theta1 < 2,
    theta1 + theta2 > -1, theta1 - theta2 < 1). params = (theta1, theta2);
    metrics = autocovariances at lags 0..2 (the sufficient summary choice
    in the literature). Pure vectorized shifts - no scan."""

    def fn(params, key):
        dtype = params.dtype
        t1, t2 = params[0], params[1]
        e = jax.random.normal(key, (n_obs + 2,), dtype)
        y = e[2:] + t1 * e[1:-1] + t2 * e[:-2]
        n = jnp.asarray(n_obs, dtype)
        g0 = jnp.sum(y * y) / n
        g1 = jnp.sum(y[1:] * y[:-1]) / n
        g2 = jnp.sum(y[2:] * y[:-2]) / n
        return jnp.stack([g0, g1, g2])

    return DeviceSimulator(fn, nmet=3)


#: Registry for the config-file "simulator" key (an extension over the
#: reference, which only binds executables / shared objects from config).
#: Factories receive (npar, nmet) from the parsed config.
BUILTIN_SIMULATORS: dict[str, Callable[[int, int], DeviceSimulator]] = {
    "dice": lambda npar, nmet: make_dice_simulator(),
    "gaussian": lambda npar, nmet: make_gaussian_simulator(),
    "sir": lambda npar, nmet: make_sir_simulator(),
    "linear_gaussian": make_linear_gaussian_simulator,
    "lotka_volterra": lambda npar, nmet: make_lotka_volterra_simulator(),
    "seir_campaign": lambda npar, nmet: make_seir_campaign_simulator(),
    "ricker": lambda npar, nmet: make_ricker_simulator(),
    "gk": lambda npar, nmet: make_gk_simulator(),
    "mg1": lambda npar, nmet: make_mg1_simulator(),
    "ma2": lambda npar, nmet: make_ma2_simulator(),
}


def resolve_simulator(config, explicit: Simulator | None = None) -> Simulator | None:
    """Binding order: explicit > config 'simulator' (builtin) > 'shared' >
    'executable' (src/AbcSmc.cpp:402-406)."""
    if explicit is not None:
        return explicit
    if config.simulator_name:
        if config.simulator_name not in BUILTIN_SIMULATORS:
            raise SimulatorError(
                f"unknown builtin simulator {config.simulator_name!r}"
            )
        return BUILTIN_SIMULATORS[config.simulator_name](
            config.npar, config.nmet
        )
    if config.shared:
        return SharedLibSimulator(config.shared, config.nmet)
    if config.executable:
        return ExecSimulator(config.executable)
    return None
