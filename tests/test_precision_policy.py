"""The package-wide matmul precision policy (docs/DESIGN.md "Precision
policy"): importing abcsmc_tpu sets jax_default_matmul_precision=highest so
covariance/Gram/score matmuls don't silently run with TF32 input rounding
on a GPU (a 10-bit mantissa: ~1e-3 relative error in every product).
"""

import os
import subprocess
import sys

import jax


def test_import_sets_highest_matmul_precision():
    import abcsmc_tpu  # noqa: F401

    assert jax.config.jax_default_matmul_precision == "highest"


def _lowered_dot_lines(fn, *args):
    txt = jax.jit(fn).lower(*args).as_text()
    return [ln for ln in txt.splitlines() if "dot_general" in ln]


def test_inference_dots_pinned_highest_under_optout():
    """Every dot_general in the fused generation step and the standalone
    proposal program carries explicit HIGHEST precision even when the
    global default is lowered - i.e. the documented ABCSMC_MATMUL_PRECISION
    opt-out (meant for user simulators) cannot degrade the inference math
    (docs/PARITY.md "Precision policy is two-layered")."""
    import jax.numpy as jnp
    import numpy as np

    from abcsmc_tpu.config import NoiseType, parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_dice_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    cfg = parse_config({
        "smc_iterations": 2,
        "num_samples": 64,
        "predictive_prior_fraction": 0.25,
        "noise": "MULTIVARIATE",
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
    })
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def check(label, fn, *args):
        with jax.default_matmul_precision("default"):
            lines = _lowered_dot_lines(fn, *args)
        assert lines, f"{label}: expected dot_generals in the program"
        weak = [ln.strip() for ln in lines if "HIGHEST" not in ln]
        assert not weak, f"{label}: non-HIGHEST dots under opt-out:\n" + (
            "\n".join(weak)
        )

    for row_block in (None, 16):  # resident and chunked row-pass modes
        gen = ShardedGeneration(
            ParameterSet.from_specs(cfg.parameters),
            ParameterTransform(cfg.parameters),
            make_dice_simulator(max_dice=50),
            np.array([44.0, 2.39925]),
            mesh=particle_mesh(),
            noise_type=NoiseType.MULTIVARIATE,
            dtype=dtype,
            row_block=row_block,
        )
        # weighted generation step, simulator excluded (the inference math)
        step_fn = gen._build_step(
            64, 16, 64, first=False, include_sim=False
        )
        key = jax.random.PRNGKey(0)
        params = jnp.ones((64, 2), dtype)
        mets = jnp.ones((64, 2), dtype)
        state = (jnp.ones((16, 2), dtype), jnp.full((16,), 1 / 16, dtype),
                 jnp.ones((2,), dtype))
        check(f"step(row_block={row_block})", step_fn, key, params, mets,
              *state)
    # the standalone split-propose program (MVN covariance + Cholesky apply)
    check("propose", lambda k, sp, w, dv: gen.propose(k, sp, w, dv, 64),
          key, *state)


def test_env_override_respected():
    """ABCSMC_MATMUL_PRECISION="unset" skips the package's config update,
    leaving jax's own default (None) - the documented opt-out for heavy
    neural device-simulators (abcsmc_tpu/__init__.py). A standalone test:
    its signal must not be masked by the HLO-lowering assertions above."""
    env = dict(os.environ)
    env["ABCSMC_MATMUL_PRECISION"] = "unset"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import abcsmc_tpu, jax; "
         "print(jax.config.jax_default_matmul_precision)"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    # "unset" skips the config update, leaving jax's own default (None)
    assert out.stdout.strip() == "None"
