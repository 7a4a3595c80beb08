"""Pose-graph and Schur-complement refinement tests: drift correction on
synthetic loops with known ground truth."""

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.models import pose_graph as pg
from shermbot_navigation.models import schur
from shermbot_navigation.ops import se2


def make_loop(T=40, radius=1.0, drift=0.002, seed=0, dtype=jnp.float64):
    """Ground-truth circular loop + drifted odometry estimate."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, T, endpoint=False)
    truth = np.stack([th + np.pi / 2,
                      radius * np.cos(th), radius * np.sin(th)], -1)
    # odometry: integrate true relative motions with small angular drift
    odo = [truth[0]]
    rels = []
    for t in range(T - 1):
        Ti = se2.from_pose(jnp.asarray(truth[t]))
        Tj = se2.from_pose(jnp.asarray(truth[t + 1]))
        rel = np.asarray(se2.to_pose(se2.compose(se2.inv(Ti), Tj)))
        noisy = rel + np.array([drift + rng.normal(0, drift / 4),
                                rng.normal(0, drift / 4),
                                rng.normal(0, drift / 4)])
        rels.append(noisy)
        Tn = se2.compose(se2.from_pose(jnp.asarray(odo[-1])),
                         se2.from_pose(jnp.asarray(noisy)))
        odo.append(np.asarray(se2.to_pose(Tn)))
    return (jnp.asarray(truth, dtype), jnp.asarray(np.stack(odo), dtype),
            jnp.asarray(np.stack(rels), dtype))


class TestPoseGraph:
    def test_loop_closure_reduces_error(self):
        dtype = jnp.float64
        truth, odo, rels = make_loop()
        T = truth.shape[0]
        info_odo = jnp.eye(3, dtype=dtype) * 100.0
        ei = jnp.arange(T - 1, dtype=jnp.int32)
        odo_edges = (ei, ei + 1, rels,
                     jnp.broadcast_to(info_odo, (T - 1, 3, 3)))
        # loop closure: relative pose between last and first from truth
        Tl = se2.from_pose(truth[-1])
        T0 = se2.from_pose(truth[0])
        z_loop = se2.to_pose(se2.compose(se2.inv(Tl), T0))[None]
        lc = (jnp.array([T - 1], jnp.int32), jnp.array([0], jnp.int32),
              z_loop, (jnp.eye(3, dtype=dtype) * 1e4)[None])

        g = pg.build_graph(odo, [odo_edges, lc])
        before = float(pg.chi2(g))
        g2 = jax.jit(lambda gg: pg.optimize(gg, iters=10))(g)
        after = float(pg.chi2(g2))
        assert after < before * 0.1

        # end-pose error vs truth shrinks dramatically
        err_before = np.linalg.norm(np.asarray(odo[-1][1:] - truth[-1][1:]))
        err_after = np.linalg.norm(np.asarray(g2.poses[-1][1:] - truth[-1][1:]))
        assert err_after < err_before * 0.5

    def test_cg_matches_dense(self):
        dtype = jnp.float64
        truth, odo, rels = make_loop(T=20)
        T = truth.shape[0]
        ei = jnp.arange(T - 1, dtype=jnp.int32)
        edges = [(ei, ei + 1, rels,
                  jnp.broadcast_to(jnp.eye(3, dtype=dtype) * 100.0,
                                   (T - 1, 3, 3)))]
        g = pg.build_graph(odo, edges)
        a = pg.gauss_newton_step(g, solve="dense")
        b = pg.gauss_newton_step(g, solve="cg", cg_iters=200)
        np.testing.assert_allclose(a.poses, b.poses, atol=1e-6)

    def test_residual_zero_at_truth(self):
        truth, _, _ = make_loop()
        T = truth.shape[0]
        ei, ej, meas, info = pg.odometry_edges(
            truth, jnp.eye(3, dtype=jnp.float64))
        g = pg.PoseGraph(poses=truth, edge_i=ei, edge_j=ej, meas=meas,
                         info=info, weight=jnp.ones(T - 1, jnp.float64))
        assert float(pg.chi2(g)) < 1e-18


class TestSchur:
    def _problem(self, T=30, N=12, dtype=jnp.float64, seed=1):
        rng = np.random.default_rng(seed)
        truth, odo, rels = make_loop(T=T, drift=0.004, seed=seed)
        lms = rng.uniform(-1.6, 1.6, (N, 2))
        # observations: every pose sees every landmark within 1.6 m
        obs_t, obs_j, obs_z = [], [], []
        for t in range(T):
            for j in range(N):
                dx, dy = lms[j, 0] - truth[t, 1], lms[j, 1] - truth[t, 2]
                rr = np.hypot(dx, dy)
                if rr < 1.6:
                    brg = np.arctan2(dy, dx) - truth[t, 0]
                    obs_t.append(t)
                    obs_j.append(j)
                    obs_z.append([rr + rng.normal(0, 1e-3),
                                  np.arctan2(np.sin(brg), np.cos(brg))
                                  + rng.normal(0, 1e-3)])
        M = len(obs_t)
        prob = schur.BundleProblem(
            poses=odo,
            landmarks=jnp.asarray(lms + rng.normal(0, 0.05, lms.shape),
                                  dtype),
            odo_meas=rels,
            odo_info=jnp.eye(3, dtype=dtype) * 1e4,
            obs_t=jnp.asarray(obs_t, jnp.int32),
            obs_j=jnp.asarray(obs_j, jnp.int32),
            obs_z=jnp.asarray(obs_z, dtype),
            obs_info=jnp.eye(2, dtype=dtype) * 1e6,
            obs_w=jnp.ones(M, dtype),
            anchor_w=jnp.asarray(1e8, dtype),
        )
        return prob, truth, jnp.asarray(lms, dtype)

    def test_refinement_recovers_truth(self):
        prob, truth, lms = self._problem()
        c0 = float(schur.total_cost(prob))
        out = jax.jit(lambda p: schur.optimize(p, iters=8))(prob)
        c1 = float(schur.total_cost(out))
        assert c1 < c0 * 0.05

        pose_err0 = np.sqrt(np.mean(
            np.sum((np.asarray(prob.poses[:, 1:] - truth[:, 1:])) ** 2, -1)))
        pose_err1 = np.sqrt(np.mean(
            np.sum((np.asarray(out.poses[:, 1:] - truth[:, 1:])) ** 2, -1)))
        assert pose_err1 < pose_err0 * 0.5
        lm_err = np.sqrt(np.mean(
            np.sum((np.asarray(out.landmarks - lms)) ** 2, -1)))
        assert lm_err < 0.01


def test_optimize_host_matches_jax_dense():
    """The host-side f64 pose-graph solver (stage 1 of large-map
    refinement) must match the JAX dense GN bit-for-near-bit on an f64
    problem — same residuals, Jacobians, anchor, and gauge projection."""
    import jax.numpy as jnp
    import numpy as np
    from shermbot_navigation.models import pose_graph as pg
    from shermbot_navigation.parallel import megamap

    prob = megamap.synthesize(64, 24, 4, dtype=jnp.float64)
    a = pg.optimize(prob.graph, iters=6, solve="dense")
    b = pg.optimize_host(prob.graph, iters=6)
    np.testing.assert_allclose(np.asarray(a.poses), np.asarray(b.poses),
                               rtol=0, atol=1e-10)
