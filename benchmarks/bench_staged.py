#!/usr/bin/env python
"""PP staging (pipeline/staged.py) vs the fused single-program tick on the
lidar20 workload — the build-or-refute measurement for SURVEY section 2.5's
PP row (reference analog: the 3-process tube_world -> landmarks -> slam
topic pipeline, unknown_data_assoc.launch:4-21).

Both programs run the identical workload: T ticks of 5 sim substeps + 360-
ray lidar + clustering + circle fit + EKF (the staged variant with the
reference's one-tick topic latency), here on a 2-device virtual CPU mesh;
the comparison isolates what staging buys and costs: tick-granular stage
overlap vs per-tick ppermute + conditional overhead and the loss of
cross-stage XLA fusion. A CPU run says nothing of a GPU's speed.

Run: python benchmarks/bench_staged.py
Prints one JSON line.
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)          # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    from shermbot_navigation.pipeline import staged
    from shermbot_navigation.pipeline.config import get_scenario
    from shermbot_navigation.pipeline.driver import run_scenario_batch

    scn = get_scenario("lidar20_full")
    T = int(os.environ.get("STAGED_T", "300"))
    key = jax.random.PRNGKey(0)

    # fused single program, 1 sequence (the production shape of this
    # workload; DP batching is orthogonal and available to both designs)
    t_fused, _ = timed(
        lambda k: run_scenario_batch(scn, k[None], steps=T), key)

    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    run_staged = staged.make_staged_rollout(scn, mesh)
    t_staged, _ = timed(lambda k: run_staged(k, T), key)

    # sequential oracle of the staged semantics on ONE device — separates
    # the cost of the latency semantics from the cost of distribution
    run_oracle = staged.make_staged_reference(scn)
    t_seq_oracle, _ = timed(lambda k: run_oracle(k, T), key)

    print(json.dumps({
        "metric": "pp_staging_vs_fused",
        "value": round(t_fused / t_staged, 3),
        "unit": "fused/staged speedup (>1 means staging wins)",
        "workload": f"lidar20_full x {T} ticks",
        "fused_ticks_per_s": round(T / t_fused, 1),
        "staged_ticks_per_s": round(T / t_staged, 1),
        "staged_oracle_1dev_ticks_per_s": round(T / t_seq_oracle, 1),
        "device": "2 virtual CPU devices",
    }))


if __name__ == "__main__":
    main()
