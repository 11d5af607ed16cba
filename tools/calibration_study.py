"""Simulation-based calibration (SBC) study of the ABC-SMC-PLS posterior.

Truth-recovery tests (tests/test_engine_e2e.py, chip_smoke.py's fit phase)
show the posterior concentrates near the generating parameters; this tool
measures the sharper property: ACROSS replicates with truths drawn from the
prior, is the posterior *calibrated*?  For each replicate r:

    theta*_r ~ prior;  y_r = simulator(theta*_r);  fit -> posterior_r

then (Talts et al. 2018, "Validating Bayesian inference algorithms with
simulation-based calibration") the posterior CDF evaluated at the truth,
u_rp = P_posterior_r(theta_p <= theta*_rp), is U(0,1) for exact Bayesian
inference. ABC-SMC posteriors are intentionally broadened (the accepted set
is a kernel-smoothed neighborhood of the data, and the perturbation kernel
doubles the survivor variance), so the honest expectation is mild
OVER-dispersion: central-interval coverage at or above nominal, u-values
pulled toward 0.5. This tool quantifies exactly how far, which is the
number a practitioner needs when reading credible intervals from a fit
(the reference ships no such diagnostic).

Round-4 scope: a CONFIGURATION MATRIX, not one model -
five model families (6x13 linear-Gaussian dengue surrogate, stochastic
SIR, conjugate Gaussian, the Ricker chaotic map of Wood 2010, the g-and-k
quantile distribution) crossed with the statistical machinery under test:
INDEPENDENT vs MULTIVARIATE perturbation noise, multinomial vs systematic
resampling, van der Voet vs PRESS-tolerance component selection. Replicates
run through the engine's host loop (AbcSmc.run), whose jitted kernels take
the observed vector as an ARGUMENT - one trace per family, so 100+
replicates are tractable on CPU and on the chip (the fused device path
bakes obs as a compile-time constant; its agreement with the host path is
pinned separately, tests/test_run_device.py::test_run_device_converges*).

Reported per parameter: empirical central 50%/90% interval coverage (with
binomial sampling sd), the Kolmogorov-Smirnov distance of {u_rp} from
U(0,1), and the mean |posterior mean - truth|. Appends a section to
docs/CALIBRATION.md.

Run:
    python tools/calibration_study.py [replicates] [n_particles] \
        [--configs lg,lg-mvn-sys,sir,gauss-tol]

The backend is whatever JAX selects (JAX_PLATFORMS=cpu for the CPU); the
appended section names it.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LOG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "CALIBRATION.md",
)

GENS = 5


def study_configs():
    """The family x machinery matrix. Each entry: name, simulator factory,
    parameter specs (uniform priors the truths are drawn from), engine
    config overrides."""
    from abcsmc_tpu.models.simulators import (
        make_gaussian_simulator,
        make_gk_simulator,
        make_ma2_simulator,
        make_linear_gaussian_simulator,
        make_ricker_simulator,
        make_sir_simulator,
    )

    def unif(name, lo, hi):
        return {"name": name, "dist_type": "UNIFORM", "num_type": "FLOAT",
                "par1": lo, "par2": hi}

    return {
        # flagship dengue-surrogate shape; baseline machinery
        "lg": dict(
            sim=lambda: make_linear_gaussian_simulator(6, 13, noise_sd=0.1),
            pars=[unif(f"p{i}", 0.0, 1.0) for i in range(6)],
            nmet=13,
            overrides={"noise": "INDEPENDENT"},
        ),
        # same family, MULTIVARIATE kernel + systematic resampling (the
        # round-3 gap: neither had any calibration evidence)
        "lg-mvn-sys": dict(
            sim=lambda: make_linear_gaussian_simulator(6, 13, noise_sd=0.1),
            pars=[unif(f"p{i}", 0.0, 1.0) for i in range(6)],
            nmet=13,
            overrides={"noise": "MULTIVARIATE",
                       "resample_method": "systematic"},
        ),
        # mechanistic stochastic epidemic model (2 pars, 6 summary stats)
        "sir": dict(
            sim=lambda: make_sir_simulator(population=5000, t_steps=120),
            pars=[unif("beta", 0.1, 0.6), unif("gamma", 0.05, 0.4)],
            nmet=6,
            overrides={"noise": "INDEPENDENT"},
        ),
        # conjugate-Gaussian family with the PRESS-tolerance selection rule
        "gauss-tol": dict(
            sim=lambda: make_gaussian_simulator(n_obs=100),
            pars=[unif("mu", -2.0, 2.0), unif("sigma", 0.2, 2.0)],
            nmet=2,
            overrides={"noise": "INDEPENDENT",
                       "pls_optimal_method": "tolerance"},
        ),
        # chaotic state-space benchmark (Wood 2010): Poisson-observed Ricker
        # map, 3 pars x 6 time-series summaries; priors sit inside the
        # simulator's clip ranges so the SBC premise (truths ~ exact prior)
        # holds. Baseline machinery on a 4th, hardest family.
        "ricker": dict(
            sim=lambda: make_ricker_simulator(),
            pars=[unif("log_r", 2.0, 5.0), unif("sigma", 0.1, 0.8),
                  unif("phi", 4.0, 15.0)],
            nmet=6,
            overrides={"noise": "INDEPENDENT"},
        ),
        # Ricker with the Box-Cox metric transform: the one piece of
        # statistical machinery without SBC evidence through round 4.
        # Poisson-count summaries are right-skewed - exactly the regime the
        # skewness-minimizing transform (ops/ranking.py::apply_box_cox,
        # reference AbcUtil's Box-Cox helpers) exists for, so this both
        # calibrates the machinery and exercises it where it matters.
        "ricker-bc": dict(
            sim=lambda: make_ricker_simulator(),
            pars=[unif("log_r", 2.0, 5.0), unif("sigma", 0.1, 0.8),
                  unif("phi", 4.0, 15.0)],
            nmet=6,
            overrides={"noise": "INDEPENDENT", "box_cox": True},
        ),
        # MA(2) moving-average process (Marin, Pudlo, Robert & Ryder 2012) -
        # the standard ABC time-series toy, autocovariance summaries at
        # lags 0..2. Priors cover the invertibility box (examples/ma2.json);
        # MULTIVARIATE kernel + multinomial resampling is the one machinery
        # cell no other row exercises (lg-mvn-sys/gk-mvn pair MVN with
        # systematic).
        "ma2": dict(
            sim=lambda: make_ma2_simulator(),
            pars=[unif("theta1", -2.0, 2.0), unif("theta2", -1.0, 1.0)],
            nmet=3,
            overrides={"noise": "MULTIVARIATE"},
        ),
        # g-and-k quantile distribution (Rayner & MacGillivray 2002;
        # Fearnhead & Prangle 2012), 4 pars x 8 octile summaries - gives the
        # round-4 machinery (MULTIVARIATE kernel + systematic resampling) a
        # second, non-Gaussian family
        "gk-mvn": dict(
            sim=lambda: make_gk_simulator(),
            pars=[unif("A", 0.0, 4.0), unif("B", 0.5, 3.0),
                  unif("g", -1.0, 2.0), unif("k", -0.3, 1.0)],
            nmet=8,
            overrides={"noise": "MULTIVARIATE",
                       "resample_method": "systematic"},
        ),
    }


def one_fit(spec, obs, n, seed):
    """Fit via the host engine loop (jitted kernels, obs as argument)."""
    from abcsmc_tpu.engine import AbcSmc
    from abcsmc_tpu.storage import MemoryStorage

    cfg = {
        "smc_iterations": GENS, "num_samples": n,
        "predictive_prior_fraction": 0.1,
        "parameters": spec["pars"],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(spec["nmet"])
        ],
        **spec["overrides"],
    }
    abc = AbcSmc(cfg, simulator=spec["_sim"], storage=MemoryStorage())
    abc.run(seed=seed)
    return abc


def run_config(name, spec, reps, n, rng):
    spec = dict(spec)
    spec["_sim"] = spec["sim"]()
    npar = len(spec["pars"])
    lo = np.array([p["par1"] for p in spec["pars"]], float)
    hi = np.array([p["par2"] for p in spec["pars"]], float)

    u_vals = np.zeros((reps, npar))
    cov50 = np.zeros((reps, npar), bool)
    cov90 = np.zeros((reps, npar), bool)
    mean_err = np.zeros((reps, npar))
    for r in range(reps):
        # truths MUST come from the exact prior or the u ~ U(0,1) premise
        # of SBC breaks: truncating the truth range makes even an exactly
        # calibrated posterior read as conservative
        truth = rng.uniform(lo, hi)
        obs = np.asarray(spec["_sim"].run_batch(
            truth[None, :], np.array([100_000 + r]), np.array([0])
        )[0])
        abc = one_fit(spec, obs, n, seed=31 * r + 7)
        pars, w = abc.posterior()
        w = np.asarray(w, float)
        w /= w.sum()
        pars = np.asarray(pars, float)
        # interval endpoints come from the ENGINE's own quantile rule
        # (posterior_summary, inverse-CDF over the weight distribution), so
        # the coverage numbers certify the intervals practitioners read
        summ = abc.posterior_summary(quantiles=(0.05, 0.25, 0.75, 0.95))
        for p, (pname, s) in enumerate(summ.items()):
            x = pars[:, p]
            u_vals[r, p] = float(w[x <= truth[p]].sum())
            qs = s["quantiles"]
            cov50[r, p] = qs[0.25] <= truth[p] <= qs[0.75]
            cov90[r, p] = qs[0.05] <= truth[p] <= qs[0.95]
            mean_err[r, p] = abs(s["mean"] - truth[p])
        if (r + 1) % 10 == 0 or r + 1 == reps:
            print(f"[{name}] replicate {r + 1}/{reps}: "
                  f"cov90 {cov90[: r + 1].mean():.3f} "
                  f"cov50 {cov50[: r + 1].mean():.3f}", flush=True)
    return u_vals, cov50, cov90, mean_err


def ks_uniform(u):
    u = np.sort(np.asarray(u).ravel())
    k = len(u)
    grid = np.arange(1, k + 1) / k
    return float(np.max(np.maximum(np.abs(grid - u),
                                   np.abs(u - (np.arange(k) / k)))))


def main(reps: int = 100, n: int = 1024, configs=None) -> None:
    import jax

    all_specs = study_configs()
    names = configs or list(all_specs)
    rng = np.random.default_rng(20260819)

    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat()
    header = [
        "",
        f"## {stamp} - SBC calibration matrix, "
        f"backend={jax.default_backend()} ({len(jax.devices())} x "
        f"{jax.devices()[0].device_kind})",
        "",
        f"{reps} replicates x {n} particles x {GENS} generations per "
        "configuration, keep 10%; truths ~ the exact uniform priors; "
        "intervals from the engine's own posterior_summary quantile rule; "
        "host engine loop (jitted kernels, observed vector as argument).",
        "",
        "| config | family | machinery | cov50 (nom 0.50) | "
        "cov90 (nom 0.90) | KS(u, U(0,1)) | mean abs err |",
        "|---|---|---|---|---|---|---|",
    ]
    # write the section header up front and each row as its config
    # completes: a multi-hour study must not lose everything to a crash in
    # the last configuration (observed: a libgcc-unwind segfault inside
    # XLA:CPU after ~500 jitted re-fits took the whole summary with it)
    with open(LOG, "a") as fh:
        fh.write("\n".join(header) + "\n")
    sd50 = np.sqrt(0.5 * 0.5 / reps)
    sd90 = np.sqrt(0.9 * 0.1 / reps)
    summary = {}
    machinery = {
        "lg": "INDEPENDENT + multinomial + vdv",
        "lg-mvn-sys": "MULTIVARIATE + systematic + vdv",
        "sir": "INDEPENDENT + multinomial + vdv",
        "gauss-tol": "INDEPENDENT + multinomial + tolerance",
        "ricker": "INDEPENDENT + multinomial + vdv",
        "ricker-bc": "INDEPENDENT + multinomial + vdv + Box-Cox",
        "gk-mvn": "MULTIVARIATE + systematic + vdv",
        "ma2": "MULTIVARIATE + multinomial + vdv",
    }
    family = {
        "lg": "linear-Gaussian 6x13", "lg-mvn-sys": "linear-Gaussian 6x13",
        "sir": "stochastic SIR 2x6", "gauss-tol": "conjugate Gaussian 2x2",
        "ricker": "Ricker chaotic map 3x6 (Wood 2010)",
        "ricker-bc": "Ricker chaotic map 3x6 (Wood 2010)",
        "gk-mvn": "g-and-k quantile 4x8",
        "ma2": "MA(2) moving average 2x3 (Marin et al. 2012)",
    }
    for name in names:
        u, c50, c90, err = run_config(name, all_specs[name], reps, n, rng)
        row = (
            f"| {name} | {family.get(name, name)} "
            f"| {machinery.get(name, '?')} "
            f"| {c50.mean():.3f} +- {sd50:.3f} "
            f"| {c90.mean():.3f} +- {sd90:.3f} "
            f"| {ks_uniform(u):.3f} | {err.mean():.4f} |"
        )
        with open(LOG, "a") as fh:
            fh.write(row + "\n")
        summary[name] = {
            "cov50": round(float(c50.mean()), 3),
            "cov90": round(float(c90.mean()), 3),
            "ks_pooled": round(ks_uniform(u), 3),
            "mean_abs_err": round(float(err.mean()), 4),
        }
        print(json.dumps({name: summary[name]}), flush=True)
    with open(LOG, "a") as fh:
        fh.write("\n")
    print(json.dumps(summary), flush=True)
    print(f"appended to {LOG}", flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("reps", nargs="?", type=int, default=100)
    ap.add_argument("n", nargs="?", type=int, default=1024)
    ap.add_argument(
        "--configs", default=None,
        help="comma-separated subset of the matrix (both --configs=a,b "
        "and --configs a,b work)",
    )
    cli = ap.parse_args()
    main(cli.reps, cli.n,
         configs=cli.configs.split(",") if cli.configs else None)
