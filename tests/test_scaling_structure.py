"""The multi-chip scaling contract, pinned at compile level.

The design's scaling claim (docs/SCALING.md; SURVEY.md section 5.7's
"population-scale axis"): sharding the particle axis over an n-device mesh
must cut per-device FLOPs ~1/ndev while cross-device traffic stays a fixed
set of collectives whose all-reduce payload is independent of BOTH mesh size
and population size. These tests compile the exact north-star step
(`ShardedGeneration._build_step`) at tiny shapes on the virtual CPU mesh and
read the contract out of the compiled artifact, so a refactor that silently
replicates an O(N) pass, drops a psum fusion, or starts all-gathering raw
rows fails here instead of on an 8-chip bill.
"""

import os
import sys

import jax

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools")
)

import functools  # noqa: E402

from scaling_analysis import collective_inventory  # noqa: E402
from scaling_analysis import analyze as _analyze  # noqa: E402

# both tests need the same (ndev, N, KEEP) compiles - cache them (each is a
# full XLA compile, ~8 s on this box)
analyze = functools.lru_cache(maxsize=None)(_analyze)

N, KEEP = 4096, 256


def test_per_device_flops_scale_with_mesh():
    assert len(jax.devices()) == 8
    r1 = analyze(1, N, KEEP)
    r8 = analyze(8, N, KEEP)
    speedup = r1["flops_per_device"] / r8["flops_per_device"]
    # perfect would be 8.0; the replicated A x A recombination constant is
    # proportionally large at this tiny shape (measured 7.33x here, 7.96x at
    # the 1M production shape) - anything under ~5x means an O(N) pass got
    # replicated
    assert speedup > 5.0, (r1["flops_per_device"], r8["flops_per_device"])


def test_collective_structure_fixed_and_allreduce_constant():
    r1 = analyze(1, N, KEEP)
    r8 = analyze(8, N, KEEP)
    r8_bign = analyze(8, 4 * N, KEEP)

    for r in (r1, r8, r8_bign):
        kinds = set(r["collectives"])
        assert kinds <= {"all-reduce", "all-gather"}, kinds
        # the fused step's wire protocol: 3 fused all-reduces (dual-frame
        # moments + Grams + PRESS/vdv; the moments psum CANNOT fuse with
        # the Grams, whose operands depend on its mean/sd result) and 5
        # all-gathers (top-K candidate pool + the [K] log-weight
        # reassembly). NB: the >= 6-element moments tuple exposed a parser
        # bug that silently dropped it (test_collective_inventory_parser
        # pins the fix) - a "2" here means the inventory went blind again,
        # not that a collective fused away.
        assert r["collectives"]["all-reduce"]["count"] == 3, r
        assert r["collectives"]["all-gather"]["count"] == 5, r

    # all-reduce payload: identical bytes regardless of mesh size or N
    ar = {r["collectives"]["all-reduce"]["bytes"] for r in (r1, r8, r8_bign)}
    assert len(ar) == 1, ar

    # all-gather payload is O(ndev * min(keep, local_n) * rowbytes): with
    # local_n >= keep in all three configs it must not grow with N ...
    assert (r8["collectives"]["all-gather"]["bytes"]
            == r8_bign["collectives"]["all-gather"]["bytes"])
    # ... and scales ~ndev at fixed keep (the gathered candidate pool)
    ratio = (r8["collectives"]["all-gather"]["bytes"]
             / r1["collectives"]["all-gather"]["bytes"])
    assert 7.0 < ratio <= 8.0, ratio


def _compile_hlo(gen, n, keep, first=True):
    """Post-partitioning HLO text of the fused step at (n, keep) - the same
    compile recipe as scaling_analysis.analyze, shared here so structural
    assertions can target arbitrary ShardedGeneration configurations."""
    import dataclasses

    import jax.numpy as jnp

    from scaling_analysis import NMET, NPAR

    n_pad = gen._padded(n)
    step_fn = gen._build_step(n_pad, keep, n, first=first, include_sim=False)

    def whole(key, params, mets, pp, pw, pdv):
        res = step_fn(key, params, mets, pp, pw, pdv)
        return tuple(getattr(res, f.name) for f in dataclasses.fields(res))

    f32 = jnp.float32
    pk = 1 if first else keep
    abstract = (
        jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((n_pad, NPAR), f32),
        jax.ShapeDtypeStruct((n_pad, NMET), f32),
        jax.ShapeDtypeStruct((pk, NPAR), f32),
        jax.ShapeDtypeStruct((pk,), f32),
        jax.ShapeDtypeStruct((NPAR,), f32),
    )
    return jax.jit(whole).lower(*abstract).compile().as_text()


def test_hbm_scaled_auto_thresholds(monkeypatch):
    """The row-chunking / propose-split auto-points follow a rule in bytes:
    half the memory the device reports, over the per-row bytes of the
    buffers each threshold guards. A backend reporting no limit (the CPU)
    never chunks or splits on its own; forced settings beat the rule."""
    import abcsmc_tpu.parallel.generation as G
    from scaling_analysis import NMET, NPAR, build_step

    gen = build_step(8, 64, 16)
    it = 4                                  # build_step runs float32
    assert gen.resident_row_bytes == it * (7 * NMET + 3 * NPAR + 4)
    assert gen.propose_row_bytes == it * (NPAR + NMET + 2 + 4 * NPAR + 6)
    for limit in (60 * 2**30, 16 * 2**30, 1 << 20):
        monkeypatch.setattr(G, "_detect_device_bytes", lambda m, b=limit: b)
        gen = build_step(8, 64, 16)
        assert gen.device_bytes == limit
        assert gen.row_chunk_threshold == (limit // 2) // gen.resident_row_bytes
        assert gen.split_threshold == (limit // 2) // gen.propose_row_bytes

    monkeypatch.setattr(G, "_detect_device_bytes", lambda m: None)
    gen = build_step(8, 64, 16)
    assert gen.row_chunk_threshold is None and gen.split_threshold is None
    assert not gen.split_propose_active(8 * 10**9, 8 * 10**9)

    # the threshold actually gates the split decision
    gen.split_threshold = 64
    assert gen.split_propose_active(8 * 64, 8 * 64)       # ln = 64 >= 64
    assert not gen.split_propose_active(8 * 63, 8 * 63)   # ln = 63 < 64
    gen.propose_split = False                              # forced beats auto
    assert not gen.split_propose_active(8 * 64, 8 * 64)


def test_forced_row_block_reaches_compiled_program():
    """`row_block` forced must produce the CHUNKED program (lax.scan row
    passes -> HLO while loops), not silently fall back to the resident one."""
    from scaling_analysis import build_step

    gen_res = build_step(8, 4096, 64)
    gen_chk = build_step(8, 4096, 64)
    gen_chk.row_block = 64
    hlo_res = _compile_hlo(gen_res, 4096, 64)
    hlo_chk = _compile_hlo(gen_chk, 4096, 64)
    assert hlo_chk.count("while(") > hlo_res.count("while("), (
        hlo_res.count("while("), hlo_chk.count("while("),
    )


def test_forced_topk_strategy_reaches_compiled_program():
    """`topk_two_stage` forced must change the compiled collective pattern:
    the two-stage program gathers distances only (lighter all-gather
    payload) and assembles survivor rows with extra psums."""
    single = analyze(8, N, KEEP, "single")
    two = analyze(8, N, KEEP, "two")
    assert (two["collectives"]["all-gather"]["bytes"]
            < single["collectives"]["all-gather"]["bytes"]), (two, single)
    assert (two["collectives"]["all-reduce"]["count"]
            > single["collectives"]["all-reduce"]["count"]), (two, single)


def test_collective_inventory_parser():
    hlo = """
  ar = (f32[13,13]{1,0}, f32[6]{0}) all-reduce(a, b), replica_groups={}
  ag.1 = f32[8,256,6]{2,1,0} all-gather(c), dimensions={0}
  ag.2 = (u32[256]{0}, u32[2048]{0}) all-gather-start(d), dimensions={0}
  agd = u32[2048]{0} all-gather-done(ag.2)
  x = f32[4,4]{1,0} add(e, f)
"""
    inv = collective_inventory(hlo)
    assert inv["all-reduce"] == {"count": 1, "bytes": 13 * 13 * 4 + 6 * 4}
    # >= 6-element result tuples carry /*index=N*/ comments whose '=' broke
    # the old tuple regex - the 7-element dual-frame moments psum vanished
    # from count AND bytes, and the structure test mistook the blindness
    # for a real 3 -> 2 fusion
    big = ("ar7 = (f32[13]{0}, f32[13]{0}, f32[13]{0}, f32[6]{0}, "
           "f32[6]{0}, /*index=5*/f32[6]{0}, f32[6]{0}) "
           "all-reduce(a, b, c, d, e, f, g)")
    inv7 = collective_inventory(big)
    assert inv7["all-reduce"] == {"count": 1, "bytes": 3 * 13 * 4 + 4 * 6 * 4}
    # the async pair is counted once, at -done (the -start result tuple
    # carries both operand and result buffers and would double-count)
    assert inv["all-gather"]["count"] == 2
    assert inv["all-gather"]["bytes"] == 8 * 256 * 6 * 4 + 2048 * 4
