"""SMC importance weights over the Gaussian perturbation-kernel mixture.

The reference computes, for each surviving particle i of generation t
(src/AbcUtil.cpp:539-586):

    w_i = prior(theta_i) / sum_j w'_j * prod_p N(theta_ip - theta'_jp; sqrt(dv_p))

where theta' / w' are the previous generation's predictive prior and weights and
dv is the previous generation's per-parameter *doubled variance*. The C++ loop is
O(N * M * P) scalar work; here the XLA path turns the mixture densities into
one matmul per block of centers:

    scale columns by 1/sqrt(dv) (after centering both populations by the same
    vector - the kernel only sees differences, so centering is free and keeps the
    squared-norm expansion numerically safe at f32):

        sum_p (a_ip - b_jp)^2 = ||a_i||^2 + ||b_j||^2 - 2 a_i . b_j

    log K_ij = -0.5 * sum_p (...) + C,  C = -0.5 * sum_p log(2 pi dv_p)
    log den_i = logsumexp_j (log w'_j + log K_ij)

computed block-streamed over j (flash-attention-style online logsumexp) so at
most an N x block tile of logits exists at a time. On a GPU the Pallas kernel
(ops/pallas_kernels.py) computes the same sum with direct differences and keeps
every logit in registers.

Parity quirks preserved:
- converged-parameter escape hatch: a parameter column with dv == 0 contributes no
  kernel factor (src/AbcUtil.cpp:570-576; the reference skips the factor when the
  values are equal, which is the only case that occurs since zero variance means
  zero noise was added),
- the returned weights are L2-normalized - unit norm, NOT sum-to-1
  (src/AbcUtil.cpp:583, Eigen .normalize()); downstream categorical resampling
  renormalizes, so this only matters for stored-weight parity,
- generation-0 weights are uniform 1/N and sum to 1 (src/AbcUtil.cpp:539-545).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

def uniform_weights(n: int, dtype=jnp.float32):
    """Generation-0 predictive prior weights (src/AbcUtil.cpp:539-545)."""
    return jnp.full((n,), 1.0 / n, dtype=dtype)


def _prep_scaled(params, prev_params, prev_doubled_variance):
    """Mask out converged (dv==0) columns and scale the rest to unit kernel sd."""
    params = jnp.asarray(params)
    prev_params = jnp.asarray(prev_params, params.dtype)
    dv = jnp.asarray(prev_doubled_variance, params.dtype)
    live = dv > 0
    # scale: 1/sqrt(dv) for live columns, 0 for converged ones (drops the factor)
    inv_sd = jnp.where(live, 1.0 / jnp.sqrt(jnp.where(live, dv, 1.0)), 0.0)
    center = jnp.mean(prev_params, axis=0)
    a = (params - center[None, :]) * inv_sd[None, :]
    b = (prev_params - center[None, :]) * inv_sd[None, :]
    # per-pair constant: only live columns contribute a normalization factor
    log_norm = -0.5 * jnp.sum(jnp.where(live, jnp.log(2.0 * jnp.pi * jnp.where(live, dv, 1.0)), 0.0))
    return a, b, log_norm


def log_kernel_mixture_density(
    params, prev_params, prev_log_weights, prev_doubled_variance,
    block: int = 2048,
):
    """log den_i = logsumexp_j [ log w'_j - 0.5 * sum_p (d_ijp^2 / dv_p) + C ].

    float32 on a GPU runs the fused Pallas kernel
    (:func:`abcsmc_tpu.ops.pallas_kernels.mixture_logsumexp`); every other
    case (the CPU, float64 parity runs) streams ``block``-wide center tiles
    through the XLA path, which is also the kernel's reference.
    """
    params = jnp.asarray(params)
    if params.dtype == jnp.float32 and jax.default_backend() == "gpu":
        from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp

        a, b, log_norm = _prep_scaled(
            params, prev_params, prev_doubled_variance
        )
        return mixture_logsumexp(
            a, b, jnp.asarray(prev_log_weights, a.dtype)
        ) + log_norm
    return _log_kernel_mixture_density_xla(
        params, prev_params, prev_log_weights, prev_doubled_variance, block
    )


@partial(jax.jit, static_argnames=("block",))
def _log_kernel_mixture_density_xla(
    params, prev_params, prev_log_weights, prev_doubled_variance, block: int = 2048
):
    a, b, log_norm = _prep_scaled(params, prev_params, prev_doubled_variance)
    n, m = a.shape[0], b.shape[0]
    lw = jnp.asarray(prev_log_weights, a.dtype)

    a_sq = jnp.sum(a * a, axis=1)  # [n]

    nblocks = -(-m // block)
    pad = nblocks * block - m
    b_pad = jnp.pad(b, ((0, pad), (0, 0)))
    lw_pad = jnp.pad(lw, (0, pad), constant_values=-jnp.inf)
    b_blocks = b_pad.reshape(nblocks, block, -1)
    lw_blocks = lw_pad.reshape(nblocks, block)

    neg_inf = jnp.array(-jnp.inf, a.dtype)

    def scan_step(carry, inp):
        run_max, run_sum = carry  # [n], [n]
        bb, lwb = inp
        b_sq = jnp.sum(bb * bb, axis=1)  # [block]
        # -0.5 * ||a_i - b_j||^2 = a.b - 0.5||a||^2 - 0.5||b||^2
        # full-f32 dot: a reduced-precision product (bf16, or TF32 on a
        # GPU) would dominate the log-density error
        logits = (
            jnp.matmul(a, bb.T, precision=jax.lax.Precision.HIGHEST)
            - 0.5 * a_sq[:, None]
            - 0.5 * b_sq[None, :]
            + lwb[None, :]
        )  # [n, block]
        blk_max = jnp.max(logits, axis=1)
        new_max = jnp.maximum(run_max, blk_max)
        # rescale the running sum; guard against -inf - -inf
        safe = lambda x, nm: jnp.where(jnp.isfinite(nm), x - nm, neg_inf)
        run_sum = run_sum * jnp.exp(safe(run_max, new_max)) + jnp.sum(
            jnp.exp(safe(logits, new_max[:, None])), axis=1
        )
        return (new_max, run_sum), None

    init = (jnp.full((n,), -jnp.inf, a.dtype), jnp.zeros((n,), a.dtype))
    (run_max, run_sum), _ = jax.lax.scan(scan_step, init, (b_blocks, lw_blocks))
    return run_max + jnp.log(run_sum) + log_norm


@partial(jax.jit, static_argnames=("prior_log_pdf_fn", "block"))
def weight_predictive_prior(
    params,
    prev_params,
    prev_weights,
    prev_doubled_variance,
    prior_log_pdf_fn,
    block: int = 2048,
):
    """Generation t>0 importance weights (src/AbcUtil.cpp:547-586).

    ``prior_log_pdf_fn(theta[N,P]) -> [N]`` is the summed prior log-density
    (ParameterSet.prior_log_pdf). Returns L2-normalized weights (parity quirk)."""
    params = jnp.asarray(params)
    log_num = prior_log_pdf_fn(params)
    prev_w = jnp.asarray(prev_weights, params.dtype)
    log_den = log_kernel_mixture_density(
        params, prev_params, jnp.log(prev_w), prev_doubled_variance, block=block
    )
    log_w = log_num - log_den
    # exponentiate stably, then L2-normalize (reference Eigen .normalize())
    log_w = log_w - jnp.max(log_w)
    w = jnp.exp(log_w)
    return w / jnp.linalg.norm(w)
