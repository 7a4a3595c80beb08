"""Config-5 pipeline: loop closure + distributed Schur on a sharded map."""

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.parallel import megamap, mesh as mesh_lib


def test_megamap_two_stage_reduces_error():
    mesh = mesh_lib.make_mesh(jax.devices()[:4], data=1, map_=4)
    prob, out = megamap.run_megamap(
        N=64, T=24, obs_per_pose=4, mesh=mesh, pg_iters=8, gn_iters=4,
        cg_iters=64, dtype=jnp.float64)

    truth_p = np.asarray(prob.truth_poses)
    drifted = np.asarray(prob.graph.poses)     # pre-refinement odometry
    refined = np.asarray(out.poses)

    e_before = np.sqrt(np.mean(
        np.sum((drifted[:, 1:] - truth_p[:, 1:]) ** 2, -1)))
    e_after = np.sqrt(np.mean(
        np.sum((refined[:, 1:] - truth_p[:, 1:]) ** 2, -1)))
    assert e_after < e_before * 0.5, (e_before, e_after)

    lm_err = np.sqrt(np.mean(np.sum(
        (np.asarray(out.landmarks) - np.asarray(prob.truth_lms)) ** 2, -1)))
    assert lm_err < 0.05, lm_err


def test_megamap_shard_invariance():
    outs = []
    for n in (1, 4):
        mesh = mesh_lib.make_mesh(jax.devices()[:n], data=1, map_=n)
        _, out = megamap.run_megamap(
            N=32, T=16, obs_per_pose=4, mesh=mesh, pg_iters=4, gn_iters=2,
            cg_iters=64, dtype=jnp.float64)
        outs.append(np.asarray(out.poses))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-8)


def test_midscale_quality_pin():
    """End-to-end config-5 pipeline at mid scale: host-f64 loop closure +
    sharded f32 Schur refinement must land near the measurement-noise
    floor (millimeters here). Catches regressions in gauge projection,
    stage handoff, and GN convergence that tiny shapes can't see."""
    import numpy as np
    from shermbot_navigation.parallel import megamap

    prob, out = megamap.run_megamap(N=512, T=96, obs_per_pose=6,
                                    gn_iters=4)
    pe = np.asarray(out.poses[:, 1:] - prob.truth_poses[:, 1:])
    le = np.asarray(out.landmarks - prob.truth_lms)
    assert float(np.sqrt(np.mean(np.sum(pe ** 2, -1)))) < 0.01
    assert float(np.sqrt(np.mean(np.sum(le ** 2, -1)))) < 0.01


def test_fullscale_f32_budget_reaches_f64_floor():
    """r04: the recorded 0.158-vs-0.136 m config-5 'f32 precision gap'
    was an ITERATION DEFICIT — f64 at the old gn4/cg32 budget lands on
    the same 0.1582, while at gn12/cg64 f32 reaches 0.1242 and f64
    0.1241 (CPU sweep, /tmp-diagnostic rerun of r03_megamap). Pin the
    production budget at FULL config-5 scale in f32: ATE well under the
    old 0.136 'f64 floor'. (~15 s on CPU — the stage-2 arrays are
    component vectors, not grids.)"""
    prob, out = megamap.run_megamap(N=50000, T=512, obs_per_pose=97,
                                    pg_iters=5, gn_iters=12, cg_iters=64)
    pe = np.asarray(out.poses[:, 1:] - prob.truth_poses[:, 1:])
    ate = float(np.sqrt(np.mean(np.sum(pe ** 2, -1))))
    assert ate < 0.13, ate
    le = np.asarray(out.landmarks - prob.truth_lms)
    lrmse = float(np.sqrt(np.mean(np.sum(le ** 2, -1))))
    assert lrmse < 0.15, lrmse


def test_refinement_checkpoint_resume():
    """Config-5 refinement is restartable: checkpoint the bundle mid-way,
    reload, continue — bitwise-identical to the uninterrupted run (the
    multi-host elastic-recovery story from SURVEY.md section 5)."""
    import numpy as np
    import jax
    from shermbot_navigation.models import pose_graph as pg
    from shermbot_navigation.parallel import megamap, schur_dist
    from shermbot_navigation.parallel.mesh import make_mesh
    from shermbot_navigation.pipeline import checkpoint
    import tempfile, os

    mesh = make_mesh(jax.devices()[:2], data=1, map_=2)
    prob = megamap.synthesize(64, 24, 4)
    g = pg.optimize_host(prob.graph, iters=3)
    part = schur_dist.partition_problem(
        prob.bundle._replace(poses=g.poses), 2)
    step = schur_dist.make_sharded_gn(
        mesh, T=24, N=64, M=part.obs_t.shape[0], cg_iters=20, gn_steps=2)

    full = step(step(part))                       # 4 GN steps straight

    half = step(part)                             # 2 steps, checkpoint
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bundle.npz")
        checkpoint.save(path, half, step=2)
        restored, saved_step = checkpoint.load(path, half)
        assert saved_step == 2
    resumed = step(restored)                      # 2 more after reload

    np.testing.assert_array_equal(np.asarray(full.poses),
                                  np.asarray(resumed.poses))
    np.testing.assert_array_equal(np.asarray(full.landmarks),
                                  np.asarray(resumed.landmarks))
