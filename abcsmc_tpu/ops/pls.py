"""Partial Least Squares regression, accelerator-first.

The reference's PLS lives in the absent ``lib/PLS`` submodule (upstream
tjhladish/PLS, a NIPALS-family / kernel PLS per Dayal & MacGregor); the normative
contract is its call sites (src/AbcUtil.cpp:423-458):

    model = PLS::Model(X_train, Y_train)            # fit
    em    = model.cv_NEW_DATA(X_test, Y_test)        # error-vs-components matrix
    A     = PLS::optimal_num_components(em).maxCoeff()
    S     = model.scores(X, A).real()                # score-space projection

This implementation uses the **improved kernel PLS algorithm #1** (Dayal &
MacGregor 1997, J. Chemometrics 11:73-85): the entire fit operates on the Gram
matrices X'X (m x m) and X'Y (m x p), never on the n x m data matrix, so

- the O(n) work is two matmuls that shard over the particle axis
  with a single psum (see abcsmc_tpu.parallel),
- the per-component iteration is O(m^2) on tiny matrices,
- scores are one matmul: T = X @ R.

All quantities are real-valued by construction (the reference's complex-score edge
case, handled by ``.real()`` at src/AbcUtil.cpp:453-454, cannot arise here).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class PLSModel:
    """Fitted PLS model. ``rotations`` R (m x A) maps X to scores; ``y_loadings``
    Q (p x A); coefficients for A components are R[:, :A] @ Q[:, :A].T."""

    rotations: jnp.ndarray     # R, m x A
    x_loadings: jnp.ndarray    # P, m x A
    y_loadings: jnp.ndarray    # Q, p x A
    ncomp: int

    def scores(self, x, num_components: int | None = None):
        """T = X @ R[:, :A] (Dayal-MacGregor; equals NIPALS X W(P'W)^-1)."""
        a = self.ncomp if num_components is None else int(num_components)
        return jnp.asarray(x) @ self.rotations[:, :a]

    def coefficients(self, num_components: int | None = None):
        a = self.ncomp if num_components is None else int(num_components)
        return self.rotations[:, :a] @ self.y_loadings[:, :a].T

    def predict(self, x, num_components: int | None = None):
        return jnp.asarray(x) @ self.coefficients(num_components)

    def cv_new_data(self, x_val, y_val):
        """Error matrix for NEW_DATA validation (reference cv_NEW_DATA,
        src/AbcUtil.cpp:446): entry [a, j] = SSE of response j using a+1
        components on the held-out data."""
        return _sse_per_component(
            self.rotations, self.y_loadings,
            jnp.asarray(x_val), jnp.asarray(y_val),
        )


def _fit_gram(xtx, xty, ncomp: int):
    """Dayal & MacGregor improved kernel PLS #1 on Gram matrices.

    Traced under explicit HIGHEST matmul precision: the per-component
    iteration runs on tiny (m x m / m x p) matrices whose bf16 input
    rounding would corrupt the deflation chain, and the documented
    ABCSMC_MATMUL_PRECISION opt-out (for neural simulators) must not
    reach the fit (docs/PARITY.md "Precision policy")."""
    with jax.default_matmul_precision("highest"):
        return _fit_gram_impl(xtx, xty, ncomp)


def _fit_gram_impl(xtx, xty, ncomp: int):
    m = xtx.shape[0]
    p = xty.shape[1]
    dtype = xtx.dtype

    def step(carry, _):
        xty_c, R, P, Q, a = carry
        if p == 1:
            w = xty_c[:, 0]
        else:
            # dominant eigenvector of (X'Y)'(X'Y) (p x p, symmetric PSD) via
            # normalized matrix squaring + power steps: error ~ (l2/l1)^(2^k),
            # compiles fast and vectorizes, unlike eigh-in-scan
            c = xty_c.T @ xty_c

            def _nrm(m):
                s = jnp.sqrt(jnp.sum(m * m))
                return m / jnp.where(s > 0, s, 1.0)

            ck = _nrm(c)
            for _ in range(8):          # ck ~ c^256, renormalized
                ck = _nrm(ck @ ck)
            v0 = jnp.ones((p,), dtype) / jnp.sqrt(jnp.asarray(p, dtype))
            v = ck @ v0

            def power_step(vec, _):
                v2 = c @ vec
                norm = jnp.sqrt(jnp.sum(v2 * v2))
                return v2 / jnp.where(norm > 0, norm, 1.0), None

            q_dom, _ = jax.lax.scan(power_step, _nrm(v), None, length=8)
            w = xty_c @ q_dom
        wnorm = jnp.sqrt(jnp.sum(w * w))
        w = w / jnp.where(wnorm > 0, wnorm, 1.0)
        # orthogonalize against previous loadings: r = w - R (P' w)
        r = w - R @ (P.T @ w)
        xtx_r = xtx @ r
        tt = r @ xtx_r
        tt_safe = jnp.where(tt > 0, tt, 1.0)
        p_a = xtx_r / tt_safe
        q_a = (xty_c.T @ r) / tt_safe
        xty_next = xty_c - tt * jnp.outer(p_a, q_a)
        R = R.at[:, a].set(jnp.where(tt > 0, r, 0.0))
        P = P.at[:, a].set(jnp.where(tt > 0, p_a, 0.0))
        Q = Q.at[:, a].set(jnp.where(tt > 0, q_a, 0.0))
        return (xty_next, R, P, Q, a + 1), None

    init = (
        xty,
        jnp.zeros((m, ncomp), dtype),
        jnp.zeros((m, ncomp), dtype),
        jnp.zeros((p, ncomp), dtype),
        jnp.int32(0),
    )
    (xty_f, R, P, Q, _), _ = jax.lax.scan(step, init, None, length=ncomp)
    return R, P, Q


@partial(jax.jit, static_argnames=("ncomp",))
def _fit_arrays(x, y, ncomp: int):
    xtx = x.T @ x
    xty = x.T @ y
    return _fit_gram(xtx, xty, ncomp)


def fit(x, y, ncomp: int | None = None) -> PLSModel:
    """Fit PLS of Y on X (both already centered/z-scored by the caller, matching
    the reference call sites which pass z-scored matrices).

    ncomp defaults to min(n-1, m) like NIPALS' maximum meaningful rank."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    max_rank = min(x.shape[0] - 1, x.shape[1])
    a = max_rank if ncomp is None else min(int(ncomp), max_rank)
    a = max(a, 1)
    R, P, Q = _fit_arrays(x, y, a)
    return PLSModel(rotations=R, x_loadings=P, y_loadings=Q, ncomp=a)


def fit_from_gram(xtx, xty, ncomp: int) -> PLSModel:
    """Fit directly from Gram matrices (the sharded path: X'X and X'Y are psums
    of per-shard partial products over the particle axis)."""
    R, P, Q = _fit_gram(jnp.asarray(xtx), jnp.asarray(xty), int(ncomp))
    return PLSModel(rotations=R, x_loadings=P, y_loadings=Q, ncomp=int(ncomp))


def _sse_per_component(R, Q, x_val, y_val):
    """[A, p] SSE of cumulative-component predictions on held-out rows."""
    t_val = x_val @ R                                   # [nv, A]
    contribs = t_val[:, :, None] * Q.T[None, :, :]      # [nv, A, p]
    preds = jnp.cumsum(contribs, axis=1)
    resid = y_val[:, None, :] - preds
    return jnp.sum(resid * resid, axis=0)


@partial(jax.jit, static_argnames=("ncomp",))
def cv_loo(x, y, ncomp: int):
    """Leave-one-out validation error matrix [A, p] (upstream PLS 'LOO').

    Each held-out fit is a rank-1 *downdate* of the full Gram matrices
    (X'X - x_i x_i', X'Y - x_i y_i'), so the n refits are n tiny fits vmapped
    on device rather than n passes over the data."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    xtx = x.T @ x
    xty = x.T @ y

    def one(xi, yi):
        R, _, Q = _fit_gram(
            xtx - jnp.outer(xi, xi), xty - jnp.outer(xi, yi), ncomp
        )
        return _sse_per_component(R, Q, xi[None, :], yi[None, :])

    return jnp.sum(jax.vmap(one)(x, y), axis=0)


@partial(jax.jit, static_argnames=("ncomp", "num_splits"))
def cv_lso(x, y, ncomp: int, key, num_splits: int = 10,
           test_fraction: float = 0.3):
    """Leave-some-out (random-split) validation error matrix [A, p]
    (upstream PLS 'LSO'): ``num_splits`` random train/test partitions, each
    fitted via a masked Gram downdate and scored on its held-out rows."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    n = x.shape[0]
    xtx = x.T @ x
    xty = x.T @ y

    def one(k):
        test = jax.random.bernoulli(k, test_fraction, (n,))
        tmask = test.astype(x.dtype)[:, None]
        xt = x * tmask
        yt = y * tmask
        R, _, Q = _fit_gram(xtx - xt.T @ xt, xty - xt.T @ yt, ncomp)
        return _sse_per_component(R, Q, xt, yt)

    keys = jax.random.split(key, num_splits)
    return jnp.sum(jax.vmap(one)(keys), axis=0)


def _per_row_sq_errors(R, Q, x_val, y_val):
    """[nv, A, p] squared prediction errors per held-out row and component
    count (cumulative-component predictions)."""
    t_val = x_val @ R
    contribs = t_val[:, :, None] * Q.T[None, :, :]
    preds = jnp.cumsum(contribs, axis=1)
    resid = y_val[:, None, :] - preds
    return resid * resid


def _fmix32(x):
    """murmur3 finalizer: full-avalanche 32-bit mix."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def vdv_seed(key):
    """Scalar uint32 sign-stream seed from a PRNG key. Replicated math: every
    mesh shard derives the identical seed from the replicated step key."""
    return jax.random.bits(jax.random.fold_in(key, 98321), (), jnp.uint32)


def vdv_signs(seed, n_perm: int, gidx, dtype):
    """+-1 sign matrix [n_perm, len(gidx)] for the van der Voet randomization
    test, counter-based on (seed, permutation index, GLOBAL row index) only.

    The statistic built from these signs is therefore invariant to mesh
    layout: a held-out row contributes the same sign no matter which device
    holds it or where it sits in the shard-local buffer, so a 1-device and an
    8-device mesh compute the SAME selection on identical data (component
    selection is a property of the data, not the mesh - the reference call
    site src/AbcUtil.cpp:446-449 is likewise layout-free)."""
    g = jnp.asarray(gidx).astype(jnp.uint32)
    k = jnp.arange(n_perm, dtype=jnp.uint32)
    h = _fmix32(g[None, :] ^ _fmix32(k[:, None] ^ jnp.uint32(seed)))
    return jnp.where((h & jnp.uint32(1)) == 1, 1.0, -1.0).astype(dtype)


@partial(jax.jit, static_argnames=("n_perm",))
def _vdv_pvalues(sq_err, key, n_perm: int, gidx=None):
    """Van der Voet (1994) sign-randomization p-values: for each component
    count A and response j, test H0 'A performs as well as the PRESS-minimal
    count' by randomizing the signs of the per-row error differences.

    ``gidx`` (optional [nv] int): global row indices of the validation rows,
    making the sign stream layout-invariant (see :func:`vdv_signs`); defaults
    to 0..nv-1."""
    nv, A, p = sq_err.shape
    press = jnp.sum(sq_err, axis=0)                      # [A, p]
    best = jnp.argmin(press, axis=0)                     # [p]
    best_err = jnp.take_along_axis(
        sq_err, best[None, None, :].repeat(nv, 0), axis=1
    )                                                    # [nv, 1, p]
    d = sq_err - best_err                                # [nv, A, p]
    t_obs = jnp.mean(d, axis=0)                          # [A, p]
    if gidx is None:
        gidx = jnp.arange(nv)
    signs = vdv_signs(vdv_seed(key), n_perm, gidx, sq_err.dtype)
    t_perm = jnp.einsum("kn,nap->kap", signs, d) / nv    # [n_perm, A, p]
    return jnp.mean(
        jnp.abs(t_perm) >= jnp.abs(t_obs)[None, :, :], axis=0
    )                                                    # [A, p]


def optimal_num_components_vdv(
    model: PLSModel, x_val, y_val, key, n_perm: int = 199,
    alpha: float = 0.25, gidx=None,
) -> jnp.ndarray:
    """Per-response optimal component counts (1-based) by van der Voet's
    randomization test - the selection rule upstream tjhladish/PLS uses: the
    *fewest* components whose held-out errors are not significantly worse
    (p > alpha) than the PRESS-minimal count's.

    ``gidx``: global row indices of the validation rows (layout-invariant
    sign stream; pass the same indices the sharded path sees to make this
    the exactness oracle for parallel.generation's distributed vdv)."""
    x_val = jnp.asarray(x_val)
    y_val = jnp.asarray(y_val)
    if y_val.ndim == 1:
        y_val = y_val[:, None]
    sq_err = _per_row_sq_errors(
        model.rotations, model.y_loadings, x_val, y_val
    )
    pvals = _vdv_pvalues(sq_err, key, n_perm, gidx)
    ok = pvals > alpha
    # the PRESS-minimal count itself always has p == 1
    return jnp.argmax(ok, axis=0) + 1


def optimal_num_components(error_matrix, rel_tol: float = 0.1) -> jnp.ndarray:
    """Per-response optimal component counts (1-based) from a validation error
    matrix [A x p] (reference PLS::optimal_num_components; the call site takes
    .maxCoeff(), src/AbcUtil.cpp:447-449).

    Selection is parsimonious: the *fewest* components whose PRESS is within
    ``rel_tol`` (relative) of the minimum - the standard guard against PRESS's
    long noisy plateau selecting an overfit count (upstream tjhladish/PLS uses a
    van der Voet-style test to the same effect; the submodule source is absent
    from the reference snapshot, so the tolerance rule here is the documented
    stand-in)."""
    em = jnp.asarray(error_matrix)
    min_press = jnp.min(em, axis=0)
    ok = em <= (1.0 + rel_tol) * min_press[None, :]
    return jnp.argmax(ok, axis=0) + 1
