"""Command-line interface.

Subcommands:

- ``run``    — run a registered scenario end-to-end, print metrics (the
               equivalent of launching ``unknown_data_assoc.launch`` and
               eyeballing rviz, but with numbers: ATE/RPE/NEES/n_seen).
- ``frames`` — the SE(2) frame calculator: reads T_ab, T_bc, a vector, a
               twist and a frame name; prints all six transforms and the
               vector/twist in frames a/b/c (the equivalent of the
               reference CLI demo, ``rigid2d/src/main.cpp:5-101``).
- ``bench``  — run the headline benchmark (delegates to bench.py logic).

Usage::

    python -m shermbot_navigation.pipeline.cli run --scenario loop5_known
    python -m shermbot_navigation.pipeline.cli frames < input.txt
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_run(args):
    if args.engine == "native":
        return _run_native(args)

    import jax
    import jax.numpy as jnp

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from ..utils import compile_cache
    from . import metrics
    from .config import SCENARIOS, get_scenario
    from .driver import run_scenario

    scn = get_scenario(args.scenario)
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    compile_cache.enable()
    outs = run_scenario(scn, jax.random.PRNGKey(args.seed), dtype)
    out = {
        "scenario": scn.name,
        "steps": scn.steps,
        "n_seen": int(outs.n_seen[-1]),
        "ate_slam_m": float(metrics.ate(outs.slam_pose[:, 1:],
                                        outs.true_pose[:, 1:])),
        "ate_odom_m": float(metrics.ate(outs.odom_pose[:, 1:],
                                        outs.true_pose[:, 1:])),
        "heading_rmse_rad": float(metrics.heading_rmse(
            outs.slam_pose[:, 0], outs.true_pose[:, 0])),
        "rpe_m": float(metrics.rpe(outs.slam_pose, outs.true_pose)),
        "mean_nees": float(outs.nees.mean()),
    }
    if args.traj:
        import numpy as np
        with open(args.traj, "w") as f:
            f.write("tick,true_th,true_x,true_y,odom_th,odom_x,odom_y,"
                    "slam_th,slam_x,slam_y,n_seen\n")
            tp = np.asarray(outs.true_pose)
            op = np.asarray(outs.odom_pose)
            sp = np.asarray(outs.slam_pose)
            ns = np.asarray(outs.n_seen)
            for t in range(tp.shape[0]):
                f.write(f"{t},{tp[t,0]},{tp[t,1]},{tp[t,2]},"
                        f"{op[t,0]},{op[t,1]},{op[t,2]},"
                        f"{sp[t,0]},{sp[t,1]},{sp[t,2]},{int(ns[t])}\n")
    print(json.dumps(out))


def _run_native(args):
    """Run the scenario on the in-process C++ host engine
    (shermbot_navigation.native) — the low-latency serving path with no
    JAX or accelerator dependency. Deterministic (noise at its mean) when --seed >= 0;
    a negative seed enables sampled noise (seeded with |seed|).

    The native engine implements the reference algorithm exactly (first-hit
    association, gates 0.01/60, unwrapped innovations, Q=.1/R=.001,
    reference slip); scenarios that configure anything else are rejected
    rather than silently run with different algorithms under the same name.
    """
    from ..native import HostEngine
    from .config import get_scenario

    scn = get_scenario(args.scenario)
    if scn.command[0] != "circle":
        raise SystemExit("native engine supports circle commands only")
    unsupported = []
    if scn.assoc_mode != "first_hit":
        unsupported.append(f"assoc_mode={scn.assoc_mode}")
    if scn.wrap_innovation:
        unsupported.append("wrap_innovation")
    if scn.slip_mode != "reference":
        unsupported.append(f"slip_mode={scn.slip_mode}")
    if (scn.match_gate, scn.new_gate) != (0.01, 60.0):
        unsupported.append(f"gates={scn.match_gate}/{scn.new_gate}")
    if tuple(scn.q_diag) != (0.1, 0.1, 0.1) or tuple(scn.r_diag) != (
            0.001, 0.001):
        unsupported.append("non-default Q/R")
    if scn.scan_noise or scn.sensor_dropout or scn.scan_dropout:
        unsupported.append("scan_noise/dropout")
    if unsupported:
        raise SystemExit(
            "native engine runs the reference algorithm only; scenario "
            f"'{scn.name}' configures: {', '.join(unsupported)} — use the "
            "JAX engine for these knobs")
    if scn.num_landmarks > 1024:
        raise SystemExit(
            f"native engine is dense O(D^3); capacity {scn.num_landmarks} "
            "is a large-map workload — use the JAX blocked/megamap engines")
    w, v = scn.command[1], scn.command[2]
    eng = HostEngine(
        tubes=list(scn.tubes), capacity=scn.num_landmarks,
        known_assoc=scn.known_association, use_lidar=scn.use_lidar,
        max_range=scn.max_range, tube_var=scn.tube_var,
        twist_noise=scn.twist_noise, slip_min=scn.slip_min,
        slip_max=scn.slip_max, deterministic=args.seed >= 0,
        seed=abs(args.seed) + 12345, steps=scn.steps)
    tf = open(args.traj, "w") if args.traj else None
    if tf:
        tf.write("tick,true_th,true_x,true_y,odom_th,odom_x,odom_y,"
                 "slam_th,slam_x,slam_y,n_seen\n")
    for t in range(scn.steps):
        n_seen = eng.tick(w, v)
        if tf:
            p = eng.poses
            row = (*p["truth"], *p["odom"], *p["slam"])
            tf.write(str(t) + "," +
                     ",".join(f"{x:.12g}" for x in row) +
                     f",{n_seen}\n")
    if tf:
        tf.close()
    out = {
        "scenario": scn.name,
        "engine": "native",
        "steps": scn.steps,
        "n_seen": eng.n_seen,
        "ate_slam_m": eng.ate,
        "ate_odom_m": eng.ate_odom,
    }
    print(json.dumps(out))


def _parse_floats(line):
    return [float(tok) for tok in line.replace(",", " ").split()]


def _cmd_frames(args):
    """Frame calculator (ref rigid2d/src/main.cpp): input is
    T_ab (deg dx dy), T_bc (deg dx dy), a vector (x y), a frame (a|b|c),
    a twist (w x y), a frame — whitespace separated on stdin."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ..ops import se2

    toks = sys.stdin.read().replace(",", " ").split()
    vals = iter(toks)

    def nums(n):
        return [float(next(vals)) for _ in range(n)]

    deg, dx, dy = nums(3)
    T_ab = se2.from_parts(jnp.array([dx, dy]), se2.deg2rad(jnp.float32(deg)))
    deg, dx, dy = nums(3)
    T_bc = se2.from_parts(jnp.array([dx, dy]), se2.deg2rad(jnp.float32(deg)))

    def show(name, T):
        print(f"{name}: dtheta (degrees): {float(se2.rad2deg(se2.angle(T))):.6g} "
              f"dx: {float(T[2]):.6g} dy: {float(T[3]):.6g}")

    T_ba = se2.inv(T_ab)
    T_cb = se2.inv(T_bc)
    T_ac = se2.compose(T_ab, T_bc)
    T_ca = se2.inv(T_ac)
    for name, T in [("T_ab", T_ab), ("T_ba", T_ba), ("T_bc", T_bc),
                    ("T_cb", T_cb), ("T_ac", T_ac), ("T_ca", T_ca)]:
        show(name, T)

    vx, vy = nums(2)
    v = jnp.array([vx, vy])
    frame = next(vals)
    to_a = {"a": se2.identity(), "b": T_ab, "c": T_ac}[frame]
    v_a = se2.apply(to_a, v)
    v_b = se2.apply(se2.inv(T_ab), v_a)
    v_c = se2.apply(se2.inv(T_ac), v_a)
    print(f"v_a: [{float(v_a[0]):.6g} {float(v_a[1]):.6g}]")
    print(f"v_b: [{float(v_b[0]):.6g} {float(v_b[1]):.6g}]")
    print(f"v_c: [{float(v_c[0]):.6g} {float(v_c[1]):.6g}]")

    w, tx, ty = nums(3)
    tw = jnp.array([w, tx, ty])
    frame = next(vals)
    tw_a = se2.adjoint_twist(to_a, tw)
    tw_b = se2.adjoint_twist(se2.inv(T_ab), tw_a)
    tw_c = se2.adjoint_twist(se2.inv(T_ac), tw_a)
    for name, t in [("V_a", tw_a), ("V_b", tw_b), ("V_c", tw_c)]:
        print(f"{name}: angular velocity: {float(t[0]):.6g} "
              f"vx: {float(t[1]):.6g} vy: {float(t[2]):.6g}")


def _cmd_bench(args):
    import runpy
    import os
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runpy.run_path(os.path.join(repo, "bench.py"), run_name="__main__")


def main(argv=None):
    p = argparse.ArgumentParser(prog="shermbot")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a scenario")
    pr.add_argument("--scenario", default="stock6")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--f64", action="store_true")
    pr.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    pr.add_argument("--engine", default="jax", choices=["jax", "native"],
                    help="jax (GPU/CPU pipeline) or native (in-process C++)")
    pr.add_argument("--traj", default=None, help="write trajectory CSV")
    pr.set_defaults(fn=_cmd_run)

    pf = sub.add_parser("frames", help="SE(2) frame calculator (stdin)")
    pf.set_defaults(fn=_cmd_frames)

    pb = sub.add_parser("bench", help="headline benchmark")
    pb.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
