"""Multi-chip scaling analysis of the sharded generation step - compile-time,
no accelerator needed.

One real chip is available in this environment, so wall-clock multi-chip
numbers cannot be measured (and a virtual CPU mesh on a 1-core box would
time-slice shards, telling us nothing). What CAN be established honestly is
the *structure* XLA compiles for an n-device mesh:

  - per-device FLOPs must scale ~1/ndev at fixed global N (the particle axis
    is sharded; every O(N) pass is shard-local), and
  - the collective payload must be O(keep*P + M^2 + A*M) - independent of N -
    because the only cross-shard traffic is psum'd moments/Grams/PRESS, the
    all_gather'd top-K survivor block, and scalar reductions.

This tool compiles ``ShardedGeneration._build_step`` (the exact program behind
``bench.py``'s north-star unit: PLS filter + vdv selection + mixture weights +
resample + perturbation, simulator excluded) for each mesh size on virtual CPU
devices, then reads both quantities out of the compiled artifact:
``compiled.cost_analysis()`` for per-device flops/bytes, and the
post-partitioning HLO text for every collective op and its payload shape.

Usage:
  python tools/scaling_analysis.py [--n 1048576] [--keep 50000] \
      [--ndev 1,2,4,8] [--n-sweep 131072,1048576]

Prints one JSON line per configuration plus a final markdown table (the
source for docs/SCALING.md). Reference scaling contract this substantiates:
SURVEY.md section 5.7 (the multi-chip scaling curve).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _prescan_max_ndev() -> int:
    """Virtual CPU device count. Must take effect BEFORE jax initializes its
    backends — i.e. before argparse can run — so ``--max-ndev`` is pre-scanned
    from argv. Values beyond 8 (e.g. 32) let ``--ndev 16,32`` substantiate the
    pod-scale compile structure of the two-stage top-K."""
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--max-ndev" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--max-ndev="):
            return int(a.split("=", 1)[1])
    return 8


MAX_NDEV = _prescan_max_ndev()

# force the virtual CPU mesh BEFORE any backend initialization
import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", MAX_NDEV)
except RuntimeError:
    # backends already initialized (imported from pytest, whose conftest set
    # up the 8-device CPU mesh itself) - callers assert the device count
    pass

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

NPAR = 6
NMET = 13

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# `f32[50000,6]{1,0}` or `u32[]` (layout suffix optional)
_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
# collectives as they appear post-SPMD-partitioning. Async pairs are counted
# at the -done op (whose result shape is the actual payload buffer); the
# -start op's result is a (operands..., results...) tuple that would
# double-count bytes. The tuple group must admit '=' INSIDE the parens:
# HLO prints /*index=N*/ element comments in tuples of >= 6 elements, and a
# [^=]* group silently drops any such collective from both count and bytes
# (a 7-element moments psum vanished this way; tuple shapes never nest
# parens, so match to the closing paren instead).
_COLL_RE = re.compile(
    r"=\s*(\([^)]*?\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"(-start|-done)?\("
)


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of one HLO shape string (tuples summed)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue  # token[] etc.
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_inventory(hlo_text: str) -> dict:
    """Count collective ops and sum their (per-device) payload bytes."""
    inv: dict[str, dict] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind, suffix = m.groups()
        if suffix == "-start":
            continue  # counted at the matching -done
        e = inv.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += _shape_bytes(shape_str)
    return inv


def build_step(ndev: int, n: int, keep: int, topk: str = "auto"):
    """The north-star generation step (bench.py shape) on an ndev-mesh."""
    from abcsmc_tpu.config import parse_config
    from abcsmc_tpu.models.parameters import ParameterSet
    from abcsmc_tpu.models.simulators import make_gaussian_simulator
    from abcsmc_tpu.models.transforms import ParameterTransform
    from abcsmc_tpu.parallel.generation import ShardedGeneration
    from abcsmc_tpu.parallel.mesh import particle_mesh

    mesh = particle_mesh(jax.devices()[:ndev])
    cfg = parse_config({
        "smc_iterations": 2,
        "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0}
            for i in range(NPAR)
        ],
        "metrics": [
            {"name": f"m{i}", "num_type": "FLOAT", "value": 0.0}
            for i in range(NMET)
        ],
    })
    gen = ShardedGeneration(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_gaussian_simulator(),  # unused: metrics precomputed
        np.zeros(NMET),
        mesh=mesh,
        dtype=jnp.float32,
        topk_two_stage={"auto": None, "single": False, "two": True}[topk],
    )
    # pin one traced pick path across mesh sizes (the sorted-picks gate is a
    # rows-per-SHARD threshold, so it would otherwise flip between ndev=1 and
    # ndev=8 at the same global N and muddy the flops comparison)
    gen.sorted_pick_min = 1 << 62
    return gen


def analyze(ndev: int, n: int, keep: int, topk: str = "auto") -> dict:
    gen = build_step(ndev, n, keep, topk)
    n_pad = gen._padded(n)
    step_fn = gen._build_step(n_pad, keep, n, first=False, include_sim=False)

    import dataclasses

    def whole(key, params, mets, pp, pw, pdv):
        res = step_fn(key, params, mets, pp, pw, pdv)
        # return every field so nothing is dead-code-eliminated
        return tuple(
            getattr(res, f.name) for f in dataclasses.fields(res)
        )

    key = jax.random.PRNGKey(0)
    f32 = jnp.float32
    abstract = (
        key,
        jax.ShapeDtypeStruct((n_pad, NPAR), f32),
        jax.ShapeDtypeStruct((n_pad, NMET), f32),
        jax.ShapeDtypeStruct((keep, NPAR), f32),
        jax.ShapeDtypeStruct((keep,), f32),
        jax.ShapeDtypeStruct((NPAR,), f32),
    )
    compiled = jax.jit(whole).lower(*abstract).compile()

    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):  # older jax returns one dict per device
        ca = ca[0] if ca else {}
    flops = float(ca.get("flops", float("nan")))
    bytes_accessed = float(ca.get("bytes accessed", float("nan")))

    inv = collective_inventory(compiled.as_text())
    coll_bytes = sum(e["bytes"] for e in inv.values())
    coll_count = sum(e["count"] for e in inv.values())
    return {
        "ndev": ndev,
        "n": n,
        "keep": keep,
        "flops_per_device": flops,
        "bytes_accessed_per_device": bytes_accessed,
        "collective_count": coll_count,
        "collective_bytes_per_device": coll_bytes,
        "collectives": inv,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--keep", type=int, default=50_000)
    ap.add_argument("--ndev", default="1,2,4,8")
    ap.add_argument(
        "--n-sweep", default="",
        help="extra global-N values at the largest mesh (shows collective "
        "bytes are N-independent)",
    )
    ap.add_argument(
        "--topk", default="auto", choices=["auto", "single", "two"],
        help="global top-K strategy: auto (payload threshold), single "
        "(candidate-row gather), two (distance gather + row psum)",
    )
    ap.add_argument(
        "--max-ndev", type=int, default=8,
        help="virtual CPU device count (pre-scanned before jax backend "
        "init, so it must be a real argv token); raise to let --ndev go "
        "beyond 8, e.g. --max-ndev 32 --ndev 8,16,32",
    )
    args = ap.parse_args()

    ndevs = [int(x) for x in args.ndev.split(",") if x]
    avail = len(jax.devices())
    assert max(ndevs) <= avail, (
        f"--ndev {max(ndevs)} exceeds the {avail} virtual devices; raise "
        f"--max-ndev (currently {MAX_NDEV})"
    )
    rows = []
    for ndev in ndevs:
        r = analyze(ndev, args.n, args.keep, args.topk)
        rows.append(r)
        print(json.dumps(r))
        sys.stdout.flush()
    for extra_n in [int(x) for x in args.n_sweep.split(",") if x]:
        if extra_n == args.n:
            continue
        r = analyze(max(ndevs), extra_n, args.keep, args.topk)
        rows.append(r)
        print(json.dumps(r))
        sys.stdout.flush()

    base = rows[0]
    print("\n| mesh | global N | per-device GFLOPs | scaling | "
          "collectives (count) | collective payload/device |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        rel = base["flops_per_device"] / r["flops_per_device"] \
            if r["flops_per_device"] else float("nan")
        kinds = ", ".join(
            f"{k} x{v['count']}" for k, v in sorted(r["collectives"].items())
        ) or "none"
        print(
            f"| {r['ndev']} dev | {r['n']:,} | "
            f"{r['flops_per_device'] / 1e9:.2f} | "
            f"{rel:.2f}x | {kinds} | "
            f"{r['collective_bytes_per_device'] / 1024:.1f} KiB |"
        )


if __name__ == "__main__":
    main()
