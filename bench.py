#!/usr/bin/env python
"""Headline benchmark: full-pipeline SLAM throughput on one GPU vs the
measured C++ reference baseline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
with the device it ran on. Exits non-zero when JAX finds no GPU.

The workload is BASELINE.json config 1 (5-landmark loop, known association):
each tick = 5 tube-world sim substeps (noise, collision, kinematics,
landmark sensor) + odometry + EKF predict + 5 sequential Kalman updates.
The GPU engine runs B independent worlds in lockstep (one jitted scan);
the baseline is the faithful C++ port of the reference's dense math
(native/baseline, -O2, measured fresh on the card's host — the reference
publishes no numbers, BASELINE.md).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_DIR = os.path.join(REPO, "native", "baseline")
BASELINE_BIN = os.path.join(BASELINE_DIR, "baseline")

SCENARIO = "loop5_known"
BATCH = int(os.environ.get("BENCH_BATCH", "16384"))
# "lanes" = the batch-trailing engine (models/ekf_batch.py); "vmapped" =
# the vmapped dense engine, kept for A/Bs.
ENGINE = os.environ.get("BENCH_ENGINE", "lanes")


def measure_cpp(runs=5):
    """Median-of-N C++ baseline with the spread recorded: a CPU number on
    a shared host swings run to run, so the median and its spread are the
    comparison row."""
    if not os.path.exists(BASELINE_BIN):
        subprocess.run(["make"], cwd=BASELINE_DIR, check=True,
                       capture_output=True)
    samples = []
    ate = None
    for _ in range(runs):
        out = subprocess.run(
            [BASELINE_BIN, "--scenario", SCENARIO, "--deterministic",
             "--repeat", "5"],
            check=True, capture_output=True, text=True)
        r = json.loads(out.stdout.strip())
        samples.append(r["ticks_per_sec"])
        ate = r["ate"]
    samples.sort()
    return {
        "ticks_per_sec": samples[len(samples) // 2],
        "ticks_per_sec_min": samples[0],
        "ticks_per_sec_max": samples[-1],
        "ate": ate,
    }


def measure_gpu():
    import jax

    from shermbot_navigation.pipeline import driver, metrics
    from shermbot_navigation.pipeline.config import get_scenario

    scn = get_scenario(SCENARIO)
    run = (driver.run_scenario_batch_lanes if ENGINE == "lanes"
           else driver.run_scenario_batch)

    def timed(key):
        t0 = time.time()
        o = run(scn, jax.random.split(key, BATCH))
        jax.block_until_ready(o)
        return time.time() - t0, o

    timed(jax.random.PRNGKey(0))                  # compile + warmup
    best = float("inf")
    outs = None
    for i in range(1, 4):
        dt, o = timed(jax.random.PRNGKey(i))
        if dt < best:
            best, outs = dt, o
    ticks = BATCH * scn.steps / best
    ate = float(metrics.ate(outs.slam_pose[..., 1:], outs.true_pose[..., 1:]))
    return ticks, ate, best


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shermbot_navigation.utils import compile_cache
    compile_cache.enable()

    cpp = measure_cpp()
    gpu_ticks, gpu_ate, secs = measure_gpu()
    result = {
        "metric": "slam_pipeline_ticks_per_sec",
        "value": round(gpu_ticks, 1),
        "unit": "ticks/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": round(gpu_ticks / cpp["ticks_per_sec"], 2),
        "baseline_ticks_per_sec": cpp["ticks_per_sec"],
        "baseline_spread": [cpp["ticks_per_sec_min"],
                            cpp["ticks_per_sec_max"]],
        "batch": BATCH,
        "scenario": SCENARIO,
        "engine": ENGINE,
        "gpu_ate_m": round(gpu_ate, 6),
        "cpp_ate_m": cpp["ate"],
        "seconds_per_batch_run": round(secs, 3),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
