"""Checks that only a GPU can run: the compiled Pallas weight kernel and the
fused step in float32 on the card. Each runs in a child process through the
``gpu_python`` fixture (tests/conftest.py) and skips without a GPU."""

import json

import pytest

pytestmark = pytest.mark.gpu

_KERNEL = """
import json, numpy as np, jax, jax.numpy as jnp
import abcsmc_tpu
from abcsmc_tpu.ops import weights as W
rng = np.random.default_rng(0)
n, p = 4096, 6
prev = rng.uniform(0.3, 0.7, (n, p)); dv = np.full(p, 0.02)
par = prev[rng.integers(0, n, n)] + rng.normal(0, 0.1, (n, p))
lw = np.log(rng.dirichlet(np.ones(n)))
args = [jnp.asarray(x, jnp.float32) for x in (par, prev, lw, dv)]
got = np.asarray(W.log_kernel_mixture_density(*args))
a = (par - prev.mean(0)) / np.sqrt(dv); b = (prev - prev.mean(0)) / np.sqrt(dv)
lg = lw[None, :] - 0.5 * ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
mx = lg.max(1)
want = mx + np.log(np.exp(lg - mx[:, None]).sum(1)) - 0.5 * np.log(2 * np.pi * dv).sum()
print(json.dumps({"platform": jax.default_backend(),
                  "err": float(np.abs(got - want).max())}))
"""

_STEP = """
import json, numpy as np, jax
import chip_smoke as cs
from bench import bench_generation, bench_inputs
n, keep = 200_000, 10_000
params, mets, state = bench_inputs(n, keep)
key = jax.random.PRNGKey(0)
res = bench_generation(n, keep).step_precomputed(key, params, mets, keep, n, state)
chk = bench_generation(n, keep, row_block=1 << 15).step_precomputed(
    key, params, mets, keep, n, state)
print(json.dumps(cs._compare(res, chk, keep)))
"""


def test_gpu_weight_kernel_matches_f64(gpu_python):
    """The compiled (not interpreted) kernel, reached through the public
    entry point, agrees with a float64 oracle to 1e-4 nats."""
    out = json.loads(gpu_python(_KERNEL).strip().splitlines()[-1])
    assert out["platform"] == "gpu"
    assert out["err"] <= 1e-4, out


def test_gpu_fused_step_chunked_equals_resident(gpu_python):
    """f32 on the card: PLS keeps more than one component on
    rank-structured metrics, and the chunked row passes select what the
    resident program does."""
    cmp = json.loads(gpu_python(_STEP).strip().splitlines()[-1])
    assert cmp["ncomp"][0] > 1 and cmp["ncomp"][0] == cmp["ncomp"][1], cmp
    assert cmp["survivor_overlap"] >= 0.999, cmp
    assert cmp["max_rel_weight_diff"] <= 1e-4, cmp
