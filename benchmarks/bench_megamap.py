#!/usr/bin/env python
"""Config-5 benchmark: pose-graph loop closure + distributed Schur bundle
refinement on a 50,000-landmark map. Prints ONE JSON line including the
single end-to-end wall-clock (synthesize -> pose graph -> Schur GN).

Iteration budget: GN=12 / CG=64. A CPU sweep showed the pose-ATE gap
once blamed on f32 precision was an ITERATION DEFICIT — f64 at a gn4/cg32
budget lands on the same 0.1582 m as f32, while f32 at gn12/cg64 reaches
0.1242 m and f64 at the same budget 0.1241 m (f32 arithmetic costs
nothing here). The budget knee on the CPU: gn4/cg32 0.158, gn8/cg32
0.153, gn4/cg64 0.149, gn8/cg64 0.136, gn12/cg64 0.124 = the f64 floor."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from shermbot_navigation.models import pose_graph as pg
    from shermbot_navigation.parallel import megamap, schur_dist
    from shermbot_navigation.parallel.mesh import make_mesh
    import numpy as np

    N = int(os.environ.get("MEGAMAP_N", "50000"))
    T = int(os.environ.get("MEGAMAP_T", "512"))
    OBS = int(os.environ.get("MEGAMAP_OBS", str(max(1, (2 * N) // T // 2))))
    mesh = make_mesh(jax.devices()[:1], data=1)
    n_map = mesh.shape["map"]

    t0 = time.time()
    prob = megamap.synthesize(N, T, OBS)
    t_synth = time.time() - t0

    # stage 1: loop closure (host f64 — see pose_graph.optimize_host)
    t0 = time.time()
    g = pg.optimize_host(prob.graph, iters=5)
    t_pg = time.time() - t0

    # stage 2: sharded Schur GN refinement — all steps in ONE program
    GN_STEPS = int(os.environ.get("MEGAMAP_GN", "12"))
    CG_ITERS = int(os.environ.get("MEGAMAP_CG", "64"))
    t0 = time.time()
    bundle = prob.bundle._replace(poses=g.poses)
    part = schur_dist.partition_problem(bundle, n_map)
    t_part = time.time() - t0
    step = schur_dist.make_sharded_gn(
        mesh, T=T, N=N, M=part.obs_t.shape[0], cg_iters=CG_ITERS,
        gn_steps=GN_STEPS)
    out = step(part)          # compile + run
    jax.block_until_ready(out)
    t0 = time.time()
    out = step(part)
    jax.block_until_ready(out)
    t_stage2 = time.time() - t0
    t_gn = t_stage2 / GN_STEPS

    pe = np.asarray(out.poses[:, 1:] - prob.truth_poses[:, 1:])
    ate = float(np.sqrt(np.mean(np.sum(pe ** 2, -1))))
    lm_err = float(np.sqrt(np.mean(np.sum(
        np.asarray(out.landmarks - prob.truth_lms) ** 2, -1))))

    print(json.dumps({
        "metric": "megamap_refinement",
        "N_landmarks": N,
        "keyframes": T,
        "observations": int(part.obs_t.shape[0]),
        "gn_steps": GN_STEPS,
        "cg_iters": CG_ITERS,
        "end_to_end_s": round(t_synth + t_pg + t_part + t_stage2, 3),
        "posegraph_5iters_s": round(t_pg, 3),
        "partition_s": round(t_part, 3),
        "schur_stage2_s": round(t_stage2, 3),
        "schur_gn_step_s": round(t_gn, 3),
        "refined_pose_ate_m": round(ate, 4),
        "refined_landmark_rmse_m": round(lm_err, 4),
        "synthesize_s": round(t_synth, 1),
    }))


if __name__ == "__main__":
    main()
