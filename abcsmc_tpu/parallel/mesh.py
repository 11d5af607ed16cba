"""Device-mesh helpers.

The reference distributes work as N independent processes polling a SQLite file
(SURVEY 2, parallelism strategy 1) or an MPI master-worker loop (strategy 2).
Here the equivalent is SPMD over a 1-D device mesh on the *particle* axis:
every particle-indexed array is sharded on axis 0, collectives (psum for global
moments/Gram matrices, all_gather for global top-k) cross the device
interconnect (NVLink between the cards of one host), and dynamic load
balancing is unnecessary because vectorized simulators are statically balanced.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"


def particle_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices, axis name 'particles'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [N, ...] particle-major arrays."""
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
):
    """Multi-process initialization (replaces the reference's MPI_Init): call
    once per process before building the mesh; jax.distributed wires the
    processes and jax.devices() then spans all of them. No-op if already
    initialized.

    ``local_device_ids`` names the cards of this host that this process
    owns. Several processes on one host must each get their own (e.g.
    ``[local_rank]``): a JAX process reserves most of every card it opens,
    so two processes on one card fail for want of memory."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


_replicate_ident_cache: dict = {}


def replicate_ident(mesh: Mesh):
    """One cached jitted replicate-identity per mesh (an all-gather riding
    the mesh interconnect). A fresh ``jax.jit(lambda)`` per call would defeat
    jit's function-identity cache and re-trace/re-compile on every fetch —
    once per SMC set on the mirror and projection paths."""
    fn = _replicate_ident_cache.get(mesh)
    if fn is None:
        rep = NamedSharding(mesh, P())
        fn = jax.jit(lambda t: t, out_shardings=rep)
        _replicate_ident_cache[mesh] = fn
    return fn


_chunk_fetch_cache: dict = {}


def _chunk_fetcher(mesh: Mesh, chunk_rows: int, axis: int):
    """Cached shard_map program replicating rows [start, start+chunk_rows)
    along the sharded ``axis``: each shard contributes the rows it owns and
    zeros elsewhere, one psum assembles them — the same mesh-size-independent
    payload trick as the two-stage top-K row assembly."""
    import jax.numpy as jnp
    from jax import lax

    key = (mesh, chunk_rows, axis)
    fn = _chunk_fetch_cache.get(key)
    if fn is None:

        def window(t, start):
            local_n = t.shape[axis]
            base = lax.axis_index(PARTICLE_AXIS) * local_n
            idx = start - base + jnp.arange(chunk_rows)
            valid = (idx >= 0) & (idx < local_n)
            rows = jnp.take(t, jnp.clip(idx, 0, local_n - 1), axis=axis)
            shape = [1] * t.ndim
            shape[axis] = chunk_rows
            mask = valid.reshape(shape)
            return lax.psum(jnp.where(mask, rows, 0), PARTICLE_AXIS)

        fn = jax.jit(
            jax.shard_map(
                window, mesh=mesh,
                in_specs=(P(*([None] * axis), PARTICLE_AXIS), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        _chunk_fetch_cache[key] = fn
    return fn


def assemble_rows_chunked(
    arr, mesh: Mesh, chunk_rows: int, axis: int = 0
) -> np.ndarray:
    """Host copy of a row-sharded global array, assembled chunk-by-chunk so
    the peak extra device memory is one ``chunk_rows``-wide replicated
    window instead of the full replication a jitted identity would
    materialize on every device. ``axis`` is the sharded row axis (0 for
    [N, ...] population buffers; 1 for [G, N, ...] scan histories). Works
    on single- and multi-process meshes (the windows are replicated, hence
    fully addressable everywhere)."""
    n = int(arr.shape[axis])
    fetch = _chunk_fetcher(mesh, chunk_rows, axis)
    head = (slice(None),) * axis
    parts = []
    start = 0
    while start < n:
        # the final partial window slides back so the program is one shape;
        # the host keeps only its fresh tail rows
        s_eff = min(start, n - chunk_rows)
        part = np.asarray(jax.device_get(fetch(arr, s_eff)))
        parts.append(part[head + (slice(start - s_eff, None),)])
        start = s_eff + chunk_rows
    return np.concatenate(parts, axis=axis)


def fetch_rows_global(arr, mesh: Mesh, chunk_rows: int = 1 << 22,
                      axis: int = 0):
    """device_get of a row-sharded array that is safe on multi-process
    meshes AND at HBM-bound N: small arrays replicate whole (one
    all-gather); above ``chunk_rows`` rows along the sharded ``axis`` the
    copy is assembled in windows (``assemble_rows_chunked``) so fetching a
    population that barely fits sharded never OOMs a device with an
    ndev-fold replicated copy. Single-process fetches of addressable
    arrays stay a plain device_get."""
    if jax.process_count() == 1:
        return jax.device_get(arr)
    if int(arr.shape[axis]) <= chunk_rows:
        return jax.device_get(replicate_ident(mesh)(arr))
    return assemble_rows_chunked(arr, mesh, chunk_rows, axis)
