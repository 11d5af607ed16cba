"""abcsmc_tpu — an ABC-SMC (Approximate Bayesian Computation, Sequential Monte
Carlo) framework with Partial Least Squares particle filtering, in JAX.

This is a from-scratch, JAX/XLA/Pallas re-architecture of the capabilities of the
C++ reference library ``tjhladish/AbcSmc``, run on an NVIDIA GPU:

- priors / pseudo / posterior parameters become vectorized distribution modules
  (:mod:`abcsmc_tpu.models.parameters`),
- the SMC math (perturbation-kernel-mixture importance weights, PLS-score particle
  ranking, doubled-variance kernels, truncated-normal proposal sampling) becomes fused
  XLA/Pallas array programs over the whole particle population in device memory
  (:mod:`abcsmc_tpu.ops`),
- the SQLite job queue keeps a byte-compatible schema for durability / multi-process
  workers / R-visualization parity (:mod:`abcsmc_tpu.storage`), while the hot path is
  an in-memory columnar run store,
- GSL RNG becomes counter-based ``jax.random`` with per-particle stored seeds so any
  individual simulation is replayable,
- multi-chip scaling is ``jax.sharding.Mesh`` + ``shard_map`` over the particle axis
  (:mod:`abcsmc_tpu.parallel`), not MPI.

Reference parity targets are cited throughout as ``<file>:<line>`` of the
reference tree.
"""

import os as _os

import jax as _jax

# Statistical linear algebra throughout (covariances, PLS Grams, score
# projections) - none of it bound by the tensor cores, all of it
# accuracy-sensitive. On a GPU the default float32 matmul may run in TF32,
# whose 10-bit mantissa injects ~1e-3 relative error into covariance/Gram
# products; "highest" keeps them in full float32. Opt out (e.g. for heavy
# neural device-simulators) via ABCSMC_MATMUL_PRECISION.
_prec = _os.environ.get("ABCSMC_MATMUL_PRECISION", "highest")
if _prec and _prec != "unset":
    # let jax itself validate the value (the accepted set varies by jax
    # version); a garbage value must not make `import abcsmc_tpu` raise
    try:
        _jax.config.update("jax_default_matmul_precision", _prec)
    except Exception as _e:
        import warnings as _warnings

        _warnings.warn(
            f"ABCSMC_MATMUL_PRECISION={_prec!r} rejected by jax ({_e}); "
            "leaving the JAX default matmul precision in place",
            RuntimeWarning,
        )

from abcsmc_tpu.config import SmcConfig, ConfigError, parse_config
from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.models.parameters import (
    Parameter,
    GaussianPrior,
    ContinuousUniformPrior,
    DiscreteUniformPrior,
    PseudoParameter,
    PosteriorParameter,
    ParameterSet,
)
from abcsmc_tpu.models.metrics import Metric
from abcsmc_tpu.models.simulators import (
    Simulator,
    DeviceSimulator,
    PySimulator,
    ExecSimulator,
    SharedLibSimulator,
    BUILTIN_SIMULATORS,
    make_dice_simulator,
    make_gaussian_simulator,
    make_sir_simulator,
    make_linear_gaussian_simulator,
)
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh
from abcsmc_tpu.storage import MemoryStorage, SQLiteStorage

__version__ = "0.1.0"

__all__ = [
    "AbcSmc",
    "SmcConfig",
    "ConfigError",
    "parse_config",
    "Parameter",
    "GaussianPrior",
    "ContinuousUniformPrior",
    "DiscreteUniformPrior",
    "PseudoParameter",
    "PosteriorParameter",
    "ParameterSet",
    "Metric",
    "Simulator",
    "DeviceSimulator",
    "PySimulator",
    "ExecSimulator",
    "SharedLibSimulator",
    "BUILTIN_SIMULATORS",
    "make_dice_simulator",
    "make_gaussian_simulator",
    "make_sir_simulator",
    "make_linear_gaussian_simulator",
    "ShardedGeneration",
    "particle_mesh",
    "MemoryStorage",
    "SQLiteStorage",
]
