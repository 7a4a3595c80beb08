#!/usr/bin/env python
"""Multi-card scaling model for the blocked EKF (BASELINE.md target 3:
>= 80% efficiency when the map is split over more devices).

The claim rests on the communication the compiled PRODUCTION programs
actually issue, priced with a pessimistic roofline:

1. Lower the real tick step functions (parallel/blocked_ekf.py's
   make_sharded_step and make_sharded_deferred_step — the exact programs
   bigmap/bench_bigmap run, at the production M=8) on a virtual mesh and
   read every collective op out of the optimized HLO, including collectives
   hidden in tuple-shaped ops (XLA's all-reduce combiner merges psums; async
   all-gather-start outputs are (operand, result) tuples) and collectives
   inside the per-measurement lax.scan body, which execute M times per tick
   while appearing once in the HLO text.
2. Combine with the per-shard device-memory traffic into a pessimistic
   roofline: ALL collective bytes cross the card-to-card link at the
   bisection minimum (comm/2 per direction, full-duplex), and compute and
   communication do NOT overlap.

Device figures (NVIDIA H100 SXM data sheet): 3.35 TB/s of HBM per card and
NVLink at 900 GB/s per card to the others of its host, 450 GB/s each way.
These are the published peaks of the card the model is about, not
measurements of this program.

Per-tick cost model (matches what each program executes):

- sequential (non-deferred) step: M grid passes (read+write the local
  (N/P, 2, N, 2) rows per update) + M x O(N)-byte collectives
  (one (2,N,2) H-Sigma all_gather + one (2,N,2) init-cross all_gather +
  O(1) owner psums).
- deferred step: ONE grid pass per tick + per-measurement O(1)-byte psums
  + two O(M*N)-byte per-tick all_gathers (the HSbuf/CRbuf strip
  assemblies). Comm per tick is O(M*N) against O(N^2/P) compute, so
  efficiency grows with N.

`tests/test_scaling_model.py` pins: no O(N^2) collective anywhere, O(1)
in-scan bytes for the deferred step, and the efficiency floors.

Run: python benchmarks/bench_scaling.py (CPU only; prints one JSON line).
"""

import json
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=16").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth per card, and NVLink
# bandwidth per card in each direction (900 GB/s total to the other cards
# of the host).
HBM_GBPS = 3350.0
LINK_GBPS = 450.0
# device memory per card (80 GB) and the share a JAX process reserves by
# default (XLA_PYTHON_CLIENT_MEM_FRACTION = 0.75)
CARD_BYTES = 80e9
JAX_MEM_FRACTION = 0.75

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s64": 8, "u64": 8, "pred": 1, "s8": 1, "u8": 1}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")

# one HLO instruction: "%name = <shape-or-tuple> opcode(..."
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
                    r"([\w\-]+)\(", re.M)
# one shape inside a shape spec: f32[2048,2,2]{...}
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
# computation header: "%region_1.23 (arg: (...)) -> ... {" or "ENTRY %main ..."
# — a non-indented line ending in "{"; args may contain nested parens
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_WHILE_BODY = re.compile(r"\bwhile\([^)]*\).*?body=%?([\w.\-]+)")


def _shape_bytes(spec: str) -> int:
    """Total bytes of a shape spec, summing every tuple element."""
    total = 0
    for dtype, dims in _SHAPE.findall(spec):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _split_computations(hlo_text: str) -> dict:
    """Map computation name -> its body text (flat HLO blocks)."""
    comps = {}
    name, lines = None, []
    for line in hlo_text.splitlines():
        m = _COMP.match(line) if line and not line[0].isspace() else None
        if m:
            name, lines = m.group(1), []
        elif line.strip() == "}" and name is not None:
            comps[name] = "\n".join(lines)
            name = None
        elif name is not None:
            lines.append(line)
    return comps


def collective_bytes(hlo_text: str, per_op: bool = True) -> dict:
    """Sum output bytes of every collective op in an HLO module (every
    tuple element counted; `-start` async forms included — their
    (operand, result) tuple slightly over-counts, which is conservative
    for a no-O(N^2) pin and for a pessimistic roofline)."""
    out = {}
    for m in _INSTR.finditer(hlo_text):
        shape_spec, opcode = m.groups()
        base = opcode[:-6] if opcode.endswith("-start") else opcode
        if base not in _COLLECTIVES:
            continue
        out[base] = out.get(base, 0) + _shape_bytes(shape_spec)
    return out


def executed_collective_bytes(hlo_text: str, scan_len: int) -> dict:
    """Collective bytes EXECUTED per call: collectives inside while-loop
    bodies (the per-measurement lax.scan) count ``scan_len`` times; all
    others once. Returns {"in_scan": ..., "outside": ..., "total": ...,
    "by_op": {...}}."""
    comps = _split_computations(hlo_text)
    bodies = set(_WHILE_BODY.findall(hlo_text))
    in_scan, outside, by_op = 0, 0, {}
    for name, body in comps.items():
        mult = scan_len if name in bodies else 1
        for op, nbytes in collective_bytes(body).items():
            by_op[op] = by_op.get(op, 0) + nbytes * mult
            if name in bodies:
                in_scan += nbytes
            else:
                outside += nbytes
    return {"in_scan_per_iter": in_scan, "outside": outside,
            "total": in_scan * scan_len + outside, "by_op": by_op,
            "n_scan_bodies": len(bodies)}


def lower_production_step(N: int, n_map: int, M: int, deferred: bool,
                          known: bool = True) -> str:
    """Compile ONE production tick (predict + M sequential measurements) of
    the map-sharded EKF — the exact step function bigmap/bench_bigmap run —
    and return its optimized HLO text."""
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel import blocked_ekf
    from shermbot_navigation.parallel.mesh import make_mesh

    cfg = EKFConfig(num_landmarks=N)
    mesh = make_mesh(jax.devices()[:n_map], data=1, map_=n_map)
    if deferred:
        maker = (blocked_ekf.make_sharded_deferred_step if known
                 else blocked_ekf.make_sharded_deferred_unknown_step)
    else:
        maker = (blocked_ekf.make_sharded_step if known
                 else blocked_ekf.make_sharded_unknown_step)
    step = maker(cfg, mesh, 1, M)

    st = blocked_ekf.init(cfg, 1)
    twist = jnp.zeros((1, 3), jnp.float32)
    zs = jnp.broadcast_to(jnp.asarray([0.5, 0.1], jnp.float32), (1, M, 2))
    valid = jnp.ones((1, M), bool)
    Q = jnp.eye(3, dtype=jnp.float32) * 1e-4
    R = jnp.eye(2, dtype=jnp.float32) * 1e-3
    if known:
        ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (1, M))
        lowered = step.lower(st, twist, zs, valid, ids, Q, R)
    else:
        lowered = step.lower(st, twist, zs, valid, Q, R)
    return lowered.compile().as_text()


def project(N: int, n_map: int, M: int, comm_bytes_per_tick: int,
            grid_passes_per_tick: float) -> dict:
    """Pessimistic multi-card projection for one tick.

    Compute: ``grid_passes_per_tick`` read+write passes over the local
    rows of the (N,2,N,2) grid plus the O(N) strip traffic, at HBM speed.
    Cross-card traffic: with the map axis split over the cards, each card
    already owns its part of every gathered/reduced buffer, so the
    bisection minimum is comm/2 inbound per card (full-duplex NVLink). The
    pessimism: zero compute/communication overlap and every collective
    byte priced at the link rate.
    """
    grid = grid_passes_per_tick * 2 * (N // n_map) * 2 * N * 2 * 4
    strip = M * 2 * 3 * (N // n_map) * 2 * 4
    t_comp = (grid + strip) / (HBM_GBPS * 1e9)
    t_comm = (comm_bytes_per_tick / 2) / (LINK_GBPS * 1e9)
    eff = t_comp / (t_comp + t_comm)
    return {"hbm_bytes_per_shard_per_tick": int(grid + strip),
            "t_compute_us": round(t_comp * 1e6, 2),
            "t_link_us": round(t_comm * 1e6, 2),
            "projected_efficiency": round(eff, 4)}


def smallest_split_map() -> int:
    """The smallest power-of-two map whose grid (16 N^2 bytes) exceeds
    what one JAX process reserves on one card: where a map must be split
    over cards rather than may be."""
    N = 1024
    while 16 * N * N <= CARD_BYTES * JAX_MEM_FRACTION:
        N *= 2
    return N


def analyze(N: int, n_map: int, M: int, deferred: bool) -> dict:
    hlo = lower_production_step(N, n_map, M, deferred)
    ex = executed_collective_bytes(hlo, M)
    # grid passes per tick: sequential rewrites the grid per measurement;
    # deferred reads+writes it once (the fused pass)
    passes = 1.0 if deferred else float(M)
    proj = project(N, n_map, M, ex["total"], passes)
    return {
        "step": "deferred" if deferred else "sequential",
        "N": N, "map_shards": n_map, "M": M,
        "collective_bytes_per_tick": ex["total"],
        "in_scan_bytes_per_measurement": ex["in_scan_per_iter"],
        "per_tick_gather_bytes": ex["outside"],
        "by_op": ex["by_op"],
        **proj,
    }


def main():
    M = int(os.environ.get("SCALING_M", "8"))
    n_map = int(os.environ.get("SCALING_SHARDS", "4"))
    n_split = smallest_split_map()
    rows = []
    # config-4 size on both step variants + the first size that must be
    # split over cards, on the deferred production default
    for N, deferred in ((2048, False), (2048, True), (8192, True)):
        rows.append(analyze(N, n_map, M, deferred))
    d = rows[1]
    scale = n_split // 2048
    comm = (d["per_tick_gather_bytes"] * scale
            + M * d["in_scan_bytes_per_measurement"])
    headline = project(n_split, n_map, M, comm, 1.0)
    print(json.dumps({
        "metric": "blocked_ekf_multicard_scaling_projection",
        "value": headline["projected_efficiency"],
        "unit": "efficiency",
        "at": f"N={n_split} deferred on {n_map} cards (smallest map whose "
              "grid exceeds one card's default JAX reservation)",
        "rows": rows,
        "model": ("bisection minimum (comm_bytes/2) over NVLink at "
                  f"{LINK_GBPS} GB/s each way, zero compute/comm overlap; "
                  f"compute at {HBM_GBPS} GB/s HBM; scan-body collectives "
                  "counted per-measurement from the compiled HLO"),
    }))


if __name__ == "__main__":
    main()
