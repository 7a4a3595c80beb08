#!/usr/bin/env python
"""BASELINE configs 2 and 3 on the GPU vs the same-call C++ baseline.

Config 2 (`course12_noisy`): 12-landmark course, slip + sensor noise,
UNKNOWN association (Mahalanobis first-hit gating) — the reference's
`unknown_data_assoc.launch` workload driven by /fake_sensor.
Config 3 (`lidar20_full`): the full perception stack — 360-ray lidar
simulation -> adjacent-range clustering -> inscribed-angle classification
-> Hyperaccurate circle fit -> EKF — the reference's hot kernel chain
(/root/reference/nuslam/src/landmarks.cpp:68-118 driving
/root/reference/nuslam/src/circle_fit_library.cpp:15-134 at 10 Hz).

- ENGINE A/B per config: the vmapped dense engine (`run_scenario_batch`)
  vs the batch-trailing engine (`run_scenario_batch_lanes`,
  models/ekf_batch.py; covariances (D, D, B) instead of (B, D, D)).
- DETERMINISTIC quality rows: noise-off quirks-matched single-trajectory
  runs (the setups test_baseline_parity.py pins on CPU-f64) in f32 on the
  device against the C++ deterministic ATE.
- TUNED quality rows: course12_tuned / lidar20_tuned (nearest-neighbor
  gating, wrapped innovations, physical slip) through the same harness.

Methodology as in bench.py: B independent worlds in one jitted scan,
best-of-3 after warmup, each run ended by block_until_ready; the C++
baseline is a same-call median-of-5 with its spread. Exits non-zero when
JAX finds no GPU.

Run ALONE: python benchmarks/bench_configs23.py  (prints one JSON line)
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BASELINE_DIR = os.path.join(REPO, "native", "baseline")
BASELINE_BIN = os.path.join(BASELINE_DIR, "baseline")


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def measure_cpp(scenario, runs=5):
    if not os.path.exists(BASELINE_BIN):
        subprocess.run(["make"], cwd=BASELINE_DIR, check=True,
                       capture_output=True)
    samples, ate = [], None
    for _ in range(runs):
        out = subprocess.run(
            [BASELINE_BIN, "--scenario", scenario, "--deterministic",
             "--repeat", "5"],
            check=True, capture_output=True, text=True)
        r = json.loads(out.stdout.strip())
        samples.append(r["ticks_per_sec"])
        ate = r["ate"]
    samples.sort()
    return {"ticks_per_sec": samples[len(samples) // 2],
            "spread": [samples[0], samples[-1]], "ate_deterministic": ate}


def quality_stats(outs):
    import jax.numpy as jnp

    from shermbot_navigation.pipeline import metrics

    # per-world ATE quantiles, reduced on the device
    ate_w = jnp.sqrt(jnp.mean(jnp.sum(
        (outs.slam_pose[..., 1:] - outs.true_pose[..., 1:]) ** 2, -1), -1))
    return {
        "ate_median_world": round(float(jnp.median(ate_w)), 6),
        "ate_p99_world": round(float(jnp.quantile(ate_w, 0.99)), 6),
        "frac_worlds_diverged_gt1m": round(
            float(jnp.mean((ate_w > 1.0).astype(jnp.float32))), 5),
        "ate_odom": round(float(metrics.ate(
            outs.odom_pose[..., 1:], outs.true_pose[..., 1:])), 6),
    }


def measure_gpu(scenario, batch, engine="vmapped"):
    import jax

    from shermbot_navigation.pipeline import driver
    from shermbot_navigation.pipeline.config import get_scenario

    scn = get_scenario(scenario)
    run = (driver.run_scenario_batch if engine == "vmapped"
           else driver.run_scenario_batch_lanes)

    def timed(key):
        t0 = time.time()
        o = run(scn, jax.random.split(key, batch))
        jax.block_until_ready(o)
        return time.time() - t0, o

    log(f"{scenario} [{engine}]: compiling batch={batch} ...")
    timed(jax.random.PRNGKey(0))          # compile + warmup
    best, outs = float("inf"), None
    for i in range(1, 4):
        dt, o = timed(jax.random.PRNGKey(i))
        if dt < best:
            best, outs = dt, o
    ticks = batch * scn.steps / best
    row = {"engine": engine, "ticks_per_sec": round(ticks, 1),
           "batch": batch, "seconds_per_batch_run": round(best, 3)}
    row.update(quality_stats(outs))
    return row


def measure_deterministic(scenario):
    """f32 single-trajectory run on the device with noise off and quirks matched
    to the C++ deterministic mode (the setups test_baseline_parity.py pins
    on CPU-f64) — the apples-to-apples quality row."""
    import jax
    import jax.numpy as jnp

    from shermbot_navigation.pipeline import metrics
    from shermbot_navigation.pipeline.config import get_scenario
    from shermbot_navigation.pipeline.driver import run_scenario

    scn = get_scenario(scenario)
    if scenario == "course12_noisy":
        scn = dataclasses.replace(scn, twist_noise=0.0,
                                  slip_min=0.95, slip_max=0.95)
    elif scenario == "lidar20_full":
        scn = dataclasses.replace(scn, twist_noise=0.0, slip_min=0.975,
                                  slip_max=0.975, scan_noise=0.0)
    outs = run_scenario(scn, jax.random.PRNGKey(0))
    return {
        "ate": round(float(metrics.ate(
            outs.slam_pose[:, 1:], outs.true_pose[:, 1:])), 6),
        "ate_odom": round(float(metrics.ate(
            outs.odom_pose[:, 1:], outs.true_pose[:, 1:])), 6),
        "n_seen": int(outs.n_seen[-1]),
    }


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_configs23: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    points = [("course12_noisy", int(os.environ.get("BENCH23_BATCH2",
                                                    "2048"))),
              ("lidar20_full", int(os.environ.get("BENCH23_BATCH3",
                                                  "1024")))]
    tuned_points = [("course12_tuned",
                     int(os.environ.get("BENCH23_BATCH2", "2048"))),
                    ("lidar20_tuned",
                     int(os.environ.get("BENCH23_BATCH3", "1024")))]
    only = os.environ.get("BENCH23_SCENARIOS")
    if only:
        keep = only.split(",")
        points = [p for p in points if p[0] in keep]
        tuned_points = [p for p in tuned_points if p[0] in keep]
    engines = os.environ.get("BENCH23_ENGINES", "vmapped,lanes").split(",")
    skip_det = os.environ.get("BENCH23_SKIP_DET")
    skip_tuned = os.environ.get("BENCH23_SKIP_TUNED")

    rows = []
    for scenario, batch in points:
        cpp = measure_cpp(scenario)
        log(f"{scenario}: C++ median {cpp['ticks_per_sec']:.0f} ticks/s "
            f"spread {cpp['spread']} det-ATE {cpp['ate_deterministic']}")
        gpu_rows = [measure_gpu(scenario, batch, engine=e) for e in engines]
        for r in gpu_rows:
            log(str(r))
        best = max(gpu_rows, key=lambda r: r["ticks_per_sec"])
        row = {"scenario": scenario, "gpu": gpu_rows, "cpp": cpp,
               "best_engine": best["engine"],
               "vs_baseline": round(
                   best["ticks_per_sec"] / cpp["ticks_per_sec"], 2)}
        if not skip_det:
            row["deterministic_gpu_f32"] = measure_deterministic(scenario)
            log(f"{scenario} deterministic: {row['deterministic_gpu_f32']} "
                f"(C++ det ATE {cpp['ate_deterministic']})")
        rows.append(row)

    tuned_rows = []
    if not skip_tuned:
        for scenario, batch in tuned_points:
            r = measure_gpu(scenario, batch, engine=os.environ.get(
                "BENCH23_TUNED_ENGINE", "lanes"))
            r["scenario"] = scenario
            log(str(r))
            tuned_rows.append(r)

    out = {
        "metric": "configs23_ticks_per_sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "value": rows[-1]["gpu"][-1]["ticks_per_sec"] if rows else None,
        "unit": "ticks/s (last scenario, last engine)",
        "rows": rows, "tuned_rows": tuned_rows,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
