#!/usr/bin/env python
"""Smoke run of the SLAM engine on one NVIDIA GPU, through its user entry
points at full size, with every compiled Pallas kernel checked against the
plain XLA schedule it replaces.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards

Phases (one process; a failed phase is reported, the later ones still run,
and the script then exits non-zero without the final ``ok`` line):

0. device: a GPU or exit; card name and power limit from ``nvidia-smi``.
1. fleet batch (configs 1 and 3): ``driver.run_scenario_batch_lanes`` on
   ``loop5_known`` (B=16384) and ``lidar20_full`` (B=1024), 600 ticks, all
   outputs finite; then the deterministic single-trajectory runs of
   ``loop5_known``, ``course12_noisy`` and ``lidar20_full`` in f32 against
   the C++ host engine's deterministic ATE (``native/baseline``).
2. single-robot serving (``ServingEngine``) at N=2048, M=8, known and
   unknown association: the Triton grid kernel against the XLA schedule
   (the auto route at this size) from the same inputs, with ms/tick for
   each.
3. config 4 (``bigmap.make_runner`` / ``make_unknown_runner``) at N=8192 and
   N=16384, M=8, 32 ticks: the routed grid kernel against the XLA
   schedule, plus ``memory_analysis()``.
4. config 5 (``megamap.run_megamap``) at N=50,000 on one card.

``--four-cards`` runs only the deferred known-association step on a
('data', 'map') = (1, 4) mesh at N=16384 against the same run on one card,
and ``run_megamap`` on four cards against one.

Every timing line carries the card's name and power limit. The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

CARD = "card unknown"

# Deterministic parity setups (noise at its mean, quirks matched to the
# C++ deterministic mode; tests/test_baseline_parity.py pins the same runs
# in f64 on the CPU) and the largest |ATE_f32 - ATE_cpp| each may show.
# loop5_known: known association, no gating, so the runs differ only by
# f32 rounding over 600 ticks: 1e-4 m. lidar20_full: the perception chain
# adds circle fits whose f32 error feeds every update: 1e-3 m.
# course12_noisy: unknown association with Mahalanobis gates, where f32
# rounding moves the estimate at each gated update: 3e-3 m. All are under
# the 1 cm bound of BASELINE.json.
PARITY = {
    "loop5_known": ({}, 1e-4),
    "course12_noisy": (dict(twist_noise=0.0, slip_min=0.95,
                            slip_max=0.95), 3e-3),
    "lidar20_full": (dict(twist_noise=0.0, slip_min=0.975, slip_max=0.975,
                          scan_noise=0.0), 1e-3),
}
ATE_BOUND_M = 0.01
assert all(tol < ATE_BOUND_M for _, tol in PARITY.values())

# Full sizes (a CPU rehearsal may shrink them by editing this table).
SIZES = {
    "fleet": (("loop5_known", 16384), ("lidar20_full", 1024)),
    "serving": (2048, 8, 8, 72),        # N, M, warm-up ticks, ticks
    "bigmap": ((8192, 16384), 8, 32),   # Ns, M, ticks per call
    "megamap": (50000, 512),            # landmarks, keyframes
    "four_cards": (16384, 8, 16),       # N, M, ticks per call
}

# Kernel-vs-XLA state agreement: both run the same f32 algebra (the Triton
# dot at IEEE f32, precision=HIGHEST, like every XLA product on this path);
# only the rank-2M product's summation order differs, so discrete
# decisions must match exactly and continuous state to ~1e-6 relative,
# which these absolute bounds cover at the state's scale.
MEAN_TOL = 1e-4
COV_TOL = 1e-4


def out(msg: str) -> None:
    print(msg, flush=True)


def timing(msg: str) -> None:
    out(f"[{CARD}] {msg}")


def _finite(tree) -> bool:
    leaves = [x for x in jax.tree_util.tree_leaves(tree)
              if jnp.issubdtype(x.dtype, jnp.floating)]
    return all(bool(jnp.all(jnp.isfinite(x))) for x in leaves)


def _maxdiff(a, b) -> float:
    return float(jnp.max(jnp.abs(a - b)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_device() -> None:
    global CARD
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD = smi.splitlines()[0].strip()
    out(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    out(f"nvidia-smi: {smi}")


def _cpp_deterministic_ate(scenario: str) -> float:
    bdir = os.path.join(REPO, "native", "baseline")
    subprocess.run(["make"], cwd=bdir, check=True, capture_output=True)
    res = subprocess.run(
        [os.path.join(bdir, "baseline"), "--scenario", scenario,
         "--deterministic"], check=True, capture_output=True, text=True)
    return float(json.loads(res.stdout.strip().splitlines()[-1])["ate"])


def phase_fleet() -> None:
    from shermbot_navigation.pipeline import driver, metrics
    from shermbot_navigation.pipeline.config import get_scenario

    for name, B in SIZES["fleet"]:
        scn = get_scenario(name)
        t0 = time.perf_counter()
        outs = driver.run_scenario_batch_lanes(
            scn, jax.random.split(jax.random.PRNGKey(0), B))
        jax.block_until_ready(outs)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = driver.run_scenario_batch_lanes(
            scn, jax.random.split(jax.random.PRNGKey(1), B))
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        _check(outs.slam_pose.shape == (B, scn.steps, 3),
               f"{name}: slam_pose {outs.slam_pose.shape}")
        _check(_finite(outs), f"{name}: non-finite outputs")
        ate = float(metrics.ate(outs.slam_pose[..., 1:],
                                outs.true_pose[..., 1:]))
        timing(f"fleet {name} B={B} T={scn.steps}: "
               f"{B * scn.steps / dt:.1f} ticks/s ({dt:.4f} s/run, first "
               f"run incl. compile {t_first:.1f} s), ATE {ate:.6f} m")

    for name, (overrides, tol) in PARITY.items():
        scn = dataclasses.replace(get_scenario(name), **overrides)
        outs = driver.run_scenario(scn, jax.random.PRNGKey(0), jnp.float32)
        ate = float(metrics.ate(outs.slam_pose[:, 1:],
                                outs.true_pose[:, 1:]))
        ref = _cpp_deterministic_ate(name)
        gap = abs(ate - ref)
        out(f"parity {name}: f32 GPU ATE {ate:.6f} m, C++ deterministic "
            f"ATE {ref:.6f} m, gap {gap:.2e} m (tolerance {tol:.0e})")
        _check(gap <= tol, f"{name}: ATE gap {gap} > {tol}")


def _serving_inputs(N: int, M: int, T: int):
    """Per-tick (twist, zs, ids) device arrays for a robot looping over an
    N-landmark grid; the config-4 workload's measurement model."""
    from shermbot_navigation.models.ekf_slam import cartesian2polar
    from shermbot_navigation.ops import se2
    from shermbot_navigation.parallel import bigmap

    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0))

    @jax.jit
    def one(t):
        pose = bigmap._true_pose(wl.cmd, t.astype(jnp.float32) + 1.0,
                                 jnp.float32)
        ids = wl.schedule[t]
        lm = wl.landmarks[ids]
        zs = cartesian2polar(lm[:, 0] - pose[1], lm[:, 1] - pose[2])
        zs = zs.at[:, 1].set(se2.normalize_angle(zs[:, 1] - pose[0]))
        return wl.cmd[t], zs, ids

    ticks = [one(jnp.int32(t)) for t in range(T)]
    jax.block_until_ready(ticks)
    return ticks


def _serve(cfg, M, known, kernels, inputs, warm):
    """Run ``ServingEngine`` over ``inputs``; time the ticks after the
    first ``warm`` (which include compilation)."""
    from shermbot_navigation.pipeline.serving import ServingEngine

    Q = np.diag([1e-4] * 3).astype(np.float32)
    R = np.diag([1e-3] * 2).astype(np.float32)
    eng = ServingEngine(cfg, M, Q, R, known=known, grid_kernel=kernels)
    valid = jnp.ones((M,), bool)
    for tw, zs, ids in inputs[:warm]:
        eng.tick(tw, zs, valid, ids if known else None)
    jax.block_until_ready(eng.state)
    t0 = time.perf_counter()
    for tw, zs, ids in inputs[warm:]:
        eng.tick(tw, zs, valid, ids if known else None)
    jax.block_until_ready(eng.state)
    return eng.state, (time.perf_counter() - t0) / (len(inputs) - warm)


def _compare(tag: str, a, b) -> None:
    """State ``b`` against reference state ``a`` (the XLA schedule)."""
    dev0 = jax.devices()[0]
    a, b = (jax.tree_util.tree_map(lambda x: jax.device_put(x, dev0), t)
            for t in (a, b))
    _check(_finite(b), f"{tag}: non-finite kernel state")
    _check(bool(jnp.all(a.n_seen == b.n_seen))
           and bool(jnp.all(a.seen == b.seen)),
           f"{tag}: association decisions differ")
    d_mean = max(_maxdiff(a.mean_r, b.mean_r), _maxdiff(a.mean_m, b.mean_m))
    d_cov = max(_maxdiff(a.cov_rr, b.cov_rr), _maxdiff(a.cov_rm, b.cov_rm),
                _maxdiff(a.cov_mm, b.cov_mm))
    out(f"{tag}: max |d mean| {d_mean:.3e}, max |d Sigma| "
        f"{d_cov:.3e} (f32, precision HIGHEST; tolerance {MEAN_TOL:.0e} / "
        f"{COV_TOL:.0e}), n_seen {int(b.n_seen[0])}")
    _check(d_mean <= MEAN_TOL and d_cov <= COV_TOL,
           f"{tag}: kernel state off the XLA schedule")


def _check_routed(cfg, mesh) -> None:
    """On the card the auto route picks the grid kernel exactly for maps
    of at least ``GRID_KERNEL_MIN_N`` landmarks."""
    from shermbot_navigation.parallel import bigmap

    routed = bigmap._resolve_grid_kernel(None, cfg, mesh, jnp.float32)
    want = (jax.devices()[0].platform == "gpu"
            and cfg.num_landmarks >= bigmap.GRID_KERNEL_MIN_N)
    out(f"N={cfg.num_landmarks}: auto route picks the grid kernel: {routed}")
    _check(routed == want, "grid kernel routing off its rule")


def phase_serving() -> None:
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel.mesh import make_mesh

    N, M, warm, T = SIZES["serving"]
    cfg = EKFConfig(num_landmarks=N)
    _check_routed(cfg, make_mesh(jax.devices()[:1], data=1))
    inputs = _serving_inputs(N, M, T)
    for known in (True, False):
        tag = f"serving N={N} M={M} {'known' if known else 'unknown'}"
        st_x, ms_x = _serve(cfg, M, known, False, inputs, warm)
        st_k, ms_k = _serve(cfg, M, known, True, inputs, warm)
        timing(f"{tag}: XLA {ms_x * 1e3:.4f} ms/tick, grid kernel "
               f"{ms_k * 1e3:.4f} ms/tick ({T - warm} ticks)")
        _compare(tag, st_x, st_k)


def _bigmap_run(N, M, T, known, kernels, mesh=None):
    """One config-4 run of 2 x T ticks; returns (state, ms/tick of the
    second call, compile s, memory analysis)."""
    from jax.sharding import NamedSharding

    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel import bigmap, blocked_ekf
    from shermbot_navigation.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, 2 * T, M, jax.random.PRNGKey(0))
    mk = bigmap.make_runner if known else bigmap.make_unknown_runner
    run = mk(cfg, mesh, 1, M, grid_kernel=kernels, donate=True)
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    st = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        blocked_ekf.init(cfg, 1), blocked_ekf.state_sharding(mesh))
    t0 = time.perf_counter()
    compiled = run.lower(st, wl, Q, R, jnp.int32(0), T).compile()
    t_compile = time.perf_counter() - t0
    st = compiled(st, wl, Q, R, jnp.int32(0))
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    st = compiled(st, wl, Q, R, jnp.int32(T))
    jax.block_until_ready(st)
    dt = (time.perf_counter() - t0) / T
    return st, dt, t_compile, compiled.memory_analysis()


def phase_bigmap() -> None:
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel.mesh import make_mesh

    Ns, M, T = SIZES["bigmap"]
    for N in Ns:
        _check_routed(EKFConfig(num_landmarks=N),
                      make_mesh(jax.devices()[:1], data=1))
        for known in (True, False):
            tag = f"config4 N={N} M={M} {'known' if known else 'unknown'}"
            st_x, ms_x, c_x, mem_x = _bigmap_run(N, M, T, known, False)
            out(f"{tag} XLA step memory_analysis: {mem_x}")
            st_k, ms_k, c_k, mem_k = _bigmap_run(N, M, T, known, None)
            out(f"{tag} routed step memory_analysis: {mem_k}")
            timing(f"{tag}: XLA {ms_x * 1e3:.4f} ms/tick (compile "
                   f"{c_x:.1f} s), routed grid kernel {ms_k * 1e3:.4f} "
                   f"ms/tick (compile {c_k:.1f} s)")
            _compare(tag, st_x, st_k)
            del st_x, st_k


def _megamap(N, T, mesh):
    from shermbot_navigation.parallel import megamap

    t0 = time.perf_counter()
    prob, refined = megamap.run_megamap(
        N=N, T=T, obs_per_pose=max(1, (2 * N) // T // 2), mesh=mesh,
        pg_iters=5, gn_iters=12, cg_iters=64)
    jax.block_until_ready(refined)
    dt = time.perf_counter() - t0
    _check(_finite(refined), "megamap: non-finite refinement")
    pe = np.asarray(refined.poses[:, 1:]) - np.asarray(
        prob.truth_poses[:, 1:])
    ate = float(np.sqrt(np.mean(np.sum(pe ** 2, -1))))
    return refined, ate, dt


def phase_megamap() -> None:
    from shermbot_navigation.parallel.mesh import make_mesh

    N, T = SIZES["megamap"]
    _, ate, dt = _megamap(N, T, make_mesh(jax.devices()[:1], data=1))
    timing(f"config5 megamap N={N}: end to end {dt:.2f} s incl. compile, "
           f"refined pose ATE {ate:.6f} m")


def phase_four_cards() -> None:
    from shermbot_navigation.parallel.mesh import make_mesh

    devs = jax.devices()
    _check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh4 = make_mesh(devs[:4], data=1)
    _check(dict(mesh4.shape) == {"data": 1, "map": 4},
           f"mesh {dict(mesh4.shape)}")
    N, M, T = SIZES["four_cards"]
    st1, ms1, _, _ = _bigmap_run(N, M, T, True, False,
                                 make_mesh(devs[:1], data=1))
    st4, ms4, _, mem4 = _bigmap_run(N, M, T, True, False, mesh4)
    placed = {d.id for d in st4.cov_mm.sharding.device_set}
    shards = {s.device.id: s.data.shape for s in
              st4.cov_mm.addressable_shards}
    out(f"four-card grid placement: devices {sorted(placed)}, per-device "
        f"cov_mm shards {shards}")
    _check(len(placed) == 4 and all(s[3] == N // 4 for s in shards.values()),
           "sharded grid did not land on four devices")
    out(f"four-card step memory_analysis (per device): {mem4}")
    timing(f"config4 N={N} M={M} known deferred: 1 card {ms1 * 1e3:.4f} "
           f"ms/tick, ('data','map')=(1,4) {ms4 * 1e3:.4f} ms/tick")
    _compare(f"config4 N={N} 4 cards vs 1", st1, st4)
    del st1, st4

    N5, T5 = SIZES["megamap"]
    r1, ate1, dt1 = _megamap(N5, T5, make_mesh(devs[:1], data=1))
    r4, ate4, dt4 = _megamap(N5, T5, mesh4)
    d_pose = float(np.max(np.abs(np.asarray(r1.poses)
                                 - np.asarray(r4.poses))))
    d_lm = float(np.max(np.abs(np.asarray(r1.landmarks)
                               - np.asarray(r4.landmarks))))
    timing(f"config5 megamap N={N5}: 1 card {dt1:.2f} s ATE {ate1:.6f} m, "
           f"4 cards {dt4:.2f} s ATE {ate4:.6f} m; max |d pose| "
           f"{d_pose:.3e}, max |d landmark| {d_lm:.3e}")
    # f32 CG whose psums add the shards' partial sums in another order:
    # 12 GN x 64 CG iterations carry that rounding, so the bounds sit two
    # orders above it and well under the 1 cm ATE bound
    _check(abs(ate1 - ate4) <= 1e-3 and d_pose <= 5e-3,
           "megamap: 4-card refinement differs from 1-card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    from shermbot_navigation.utils import compile_cache
    out(f"compile cache: {compile_cache.enable()}")

    phases = ([("device", phase_device), ("four_cards", phase_four_cards)]
              if args.four_cards else
              [("device", phase_device), ("fleet", phase_fleet),
               ("serving", phase_serving), ("bigmap", phase_bigmap),
               ("megamap", phase_megamap)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        out(f"== phase {name}")
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            out(f"== phase {name} FAILED")
            if name == "device":
                break
        else:
            out(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        out(f"chip_smoke: failed phases {failed}")
        return 1
    out(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
