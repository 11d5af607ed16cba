"""Pallas GPU kernel (Triton route) for the SMC weight denominator.

``mixture_logsumexp``: the kernel-mixture weight denominator
(src/AbcUtil.cpp:563-578 - the O(N*M*P) loop) as one fused pass that never
writes the N x M logit matrix to device memory:

- the grid runs over tiles of query rows only; each program walks every
  tile of mixture centers in a ``fori_loop`` and keeps an online max and
  sum per query row in registers (flash-attention style),
- each logit tile is one small product of feature-augmented operands,

      a_aug_i = [c*a_i, -|a_i|^2 log2(e)/2, 1, 0...]
      b_aug_j = [c*b_j, 1, (log w_j - |b_j|^2/2) log2(e), 0...]
      a_aug_i . b_aug_j = log2(e) * (log w_j - |a_i - b_j|^2 / 2)

  with c = sqrt(log2 e), so the inner loop is the product, a row max and
  ``exp2``. The contraction is only P + 2 wide (zero-padded to 16). The
  product runs as ``F32_F32_F32``: plain float32 FMAs on the CUDA cores,
  no TF32 - the same expansion, at the same precision, as the XLA path's
  HIGHEST-precision dot.

A zero mixture weight (``log w = -inf``) is clamped to -1e30, which
contributes exactly nothing next to any finite weight. The XLA path
(``ops.weights._log_kernel_mixture_density_xla``) is the reference and the
CPU route; tests run this kernel in interpret mode.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_LOG2E = math.log2(math.e)
_NEG = -1e30
# tiles and warps: the fastest measured at p = 6 on an H100 (PERF.md)
_BLOCK_Q, _BLOCK_K, _NUM_WARPS = 64, 64, 4


def _kernel(a_ref, b_ref, out_ref, *, block_q, block_k, n_tiles):
    """One tile of query rows against every center tile.

    a_ref: [BQ, K] augmented queries; b_ref: [K, Mpad] augmented centers
    (padding centers carry a -1e30 log weight); out_ref: [BQ] result in
    natural-log units."""
    a = a_ref[...]
    m0 = jnp.full((block_q,), _NEG, jnp.float32)
    l0 = jnp.zeros((block_q,), jnp.float32)

    def body(t, carry):
        m_prev, l_prev = carry
        b = b_ref[:, pl.ds(t * block_k, block_k)]
        logit = pl.dot(a, b, precision=lax.DotAlgorithmPreset.F32_F32_F32)
        m_next = jnp.maximum(m_prev, jnp.max(logit, axis=1))
        l_next = l_prev * jnp.exp2(m_prev - m_next) + jnp.sum(
            jnp.exp2(logit - m_next[:, None]), axis=1
        )
        return m_next, l_next

    m, l = lax.fori_loop(0, n_tiles, body, (m0, l0))
    out_ref[...] = (m + jnp.log2(l)) / _LOG2E


@functools.partial(jax.jit, static_argnames=("interpret",))
def mixture_logsumexp(a, b, log_w, *, interpret: bool = False):
    """out[i] = logsumexp_j(log_w[j] - 0.5 * ||a_i - b_j||^2) in float32.

    a: [n, p] scaled query particles; b: [m, p] scaled mixture centers;
    log_w: [m] log mixture weights. Rows, centers and the feature axis are
    padded to the tile sizes here and trimmed on return.
    """
    block_q, block_k = _BLOCK_Q, _BLOCK_K
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    log_w = jnp.maximum(jnp.asarray(log_w, jnp.float32), _NEG)
    n, p = a.shape
    m = b.shape[0]
    k = -(-(p + 2) // 16) * 16
    n_pad = -(-n // block_q) * block_q
    n_tiles = -(-m // block_k)
    m_pad = n_tiles * block_k
    c = math.sqrt(_LOG2E)
    asq = jnp.sum(a * a, axis=1, keepdims=True)
    bsq = jnp.sum(b * b, axis=1, keepdims=True)
    a_aug = jnp.concatenate(
        [a * c, -0.5 * _LOG2E * asq, jnp.ones((n, 1), jnp.float32)], axis=1
    )
    lwb = jnp.pad(
        _LOG2E * (log_w[:, None] - 0.5 * bsq), ((0, m_pad - m), (0, 0)),
        constant_values=_NEG,
    )
    b_aug = jnp.concatenate(
        [jnp.pad(b * c, ((0, m_pad - m), (0, 0))),
         jnp.pad(jnp.ones((m, 1), jnp.float32), ((0, m_pad - m), (0, 0))),
         lwb], axis=1,
    )
    a_aug = jnp.pad(a_aug, ((0, n_pad - n), (0, k - p - 2)))
    b_aug = jnp.pad(b_aug, ((0, 0), (0, k - p - 2)))
    out = pl.pallas_call(
        functools.partial(
            _kernel, block_q=block_q, block_k=block_k, n_tiles=n_tiles
        ),
        grid=(n_pad // block_q,),
        in_specs=[
            pl.BlockSpec((block_q, k), lambda i: (i, 0)),
            pl.BlockSpec((k, m_pad), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((block_q,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=2
        ),
        interpret=interpret,
        name="mixture_logsumexp",
    )(a_aug, b_aug.T)
    return out[:n]
