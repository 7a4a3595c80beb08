"""Config-5 workload: huge landmark maps refined across the mesh.

BASELINE.json: "50,000-landmark map partitioned across 2+ hosts, distributed
Schur-complement refinement + pose-graph loop closure". A dense covariance
at that scale is physically impossible (a (2N)^2 float32 Sigma is 40 GB), so
the large-map estimator switches to the information/batch form — the classic
two-stage pipeline:

1. **pose-graph loop closure** (models.pose_graph, matrix-free CG): drifted
   keyframe odometry + loop-closure constraints -> globally consistent
   keyframes;
2. **distributed Schur bundle refinement** (parallel.schur_dist): jointly
   polish all keyframes + landmarks, with landmarks and their observations
   sharded over the 'map' axis and one (T, 3) psum per CG matvec.

Multi-host: the same program runs under ``jax.distributed.initialize``
(parallel.mesh.initialize_multihost) with the 'map' axis spanning hosts —
the psum compiles to NVLink within a host and the network across.

This module synthesizes the workload (keyframe loop over a landmark field,
drifted odometry, loop-closure edge, range-bearing observations) and runs
the two stages; used by tests (tiny), the multi-chip dryrun, and bench.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import pose_graph as pg
from ..models import schur
from . import schur_dist
from .mesh import make_mesh


class MegaMapProblem(NamedTuple):
    truth_poses: jnp.ndarray   # (T, 3)
    truth_lms: jnp.ndarray     # (N, 2)
    graph: pg.PoseGraph        # odometry + loop-closure edges, drifted init
    bundle: schur.BundleProblem


def synthesize(N: int, T: int, obs_per_pose: int, seed: int = 0,
               drift: float = 0.002, meas_noise: float = 1e-3,
               dtype=jnp.float32) -> MegaMapProblem:
    """Build a loop trajectory over an N-landmark grid with drifted odometry,
    one loop-closure edge, and a sweep observation schedule covering every
    landmark (host-side numpy; run once)."""
    rng = np.random.default_rng(seed)
    side = math.ceil(math.sqrt(N))
    ii = np.arange(N)
    extent = max(side, 4) * 1.0
    lms = np.stack([(ii % side + 0.5 - side / 2) * (extent / side) * 2,
                    (ii // side + 0.5 - side / 2) * (extent / side) * 2],
                   axis=-1)

    th = np.linspace(0, 2 * np.pi, T, endpoint=False)
    radius = extent * 0.5
    truth = np.stack([th + np.pi / 2,
                      radius * np.cos(th), radius * np.sin(th)], -1)

    # drifted odometry — pure numpy (this is host-side synthesis; jnp ops
    # here would dispatch one device op per edge)
    def np_wrap(a):
        return np.arctan2(np.sin(a), np.cos(a))

    def np_rel(a, b):
        """to_pose(inv(T_a) @ T_b) for pose rows [th, x, y]."""
        c, s = np.cos(a[..., 0]), np.sin(a[..., 0])
        dx = b[..., 1] - a[..., 1]
        dy = b[..., 2] - a[..., 2]
        return np.stack([np_wrap(b[..., 0] - a[..., 0]),
                         c * dx + s * dy, -s * dx + c * dy], axis=-1)

    rel = np_rel(truth[:-1], truth[1:])                      # (T-1, 3)
    rels = rel + np.stack(
        [drift + rng.normal(0, drift / 4, T - 1),
         rng.normal(0, drift / 4, T - 1),
         rng.normal(0, drift / 4, T - 1)], axis=-1)
    # accumulate the drifted chain: odo_{t+1} = odo_t o rels_t
    odo_th = np.concatenate([[truth[0, 0]],
                             truth[0, 0] + np.cumsum(rels[:, 0])])
    c, s = np.cos(odo_th[:-1]), np.sin(odo_th[:-1])
    steps = np.stack([c * rels[:, 1] - s * rels[:, 2],
                      s * rels[:, 1] + c * rels[:, 2]], axis=-1)
    odo_xy = np.concatenate(
        [truth[0:1, 1:3], truth[0, 1:3] + np.cumsum(steps, axis=0)], axis=0)
    odo = np.concatenate([odo_th[:, None], odo_xy], axis=-1)

    # pose graph: odometry chain + one loop closure (last -> first, truth)
    ei = np.arange(T - 1, dtype=np.int32)
    info_odo = np.eye(3) * (1.0 / drift) ** 2
    z_loop = np_rel(truth[-1], truth[0])
    # All problem arrays stay HOST-SIDE (numpy): the pose-graph stage is
    # solved on the host. Device upload happens once, when the jitted
    # stage-2 step consumes the bundle.
    npdt = np.dtype(jnp.dtype(dtype).name)
    graph = pg.PoseGraph(
        poses=odo.astype(npdt),
        edge_i=np.concatenate([ei, np.array([T - 1], np.int32)]),
        edge_j=np.concatenate([ei + 1, np.array([0], np.int32)]),
        meas=np.concatenate([rels, z_loop[None]]).astype(npdt),
        info=np.concatenate(
            [np.broadcast_to(info_odo, (T - 1, 3, 3)),
             (np.eye(3) * 1e6)[None]]).astype(npdt),
        weight=np.ones(T, npdt),
    )

    # observations: sweep so every landmark is seen from THREE poses spread
    # around the loop (t, t+T/3, t+2T/3). The spread sightings are the
    # landmark-level loop closures a real 50k-landmark survey has (places
    # are revisited); with only adjacent-pose sightings the bundle would be
    # gauge-soft — a coherent "bent map" (poses + landmarks bending
    # together under the odometry bias) costs almost nothing and
    # refinement cannot recover the true geometry at large radius.
    t_base = np.repeat(np.arange(T), obs_per_pose)          # (T*OBS,)
    j_base = np.arange(T * obs_per_pose) % N
    offsets = np.array([0, T // 3, (2 * T) // 3])
    tt = ((t_base[:, None] + offsets[None, :]) % T).reshape(-1)
    jj = np.broadcast_to(j_base[:, None], (len(j_base), 3)).reshape(-1)
    dxy = lms[jj] - truth[tt, 1:3]
    rr = np.hypot(dxy[:, 0], dxy[:, 1])
    brg = np.arctan2(dxy[:, 1], dxy[:, 0]) - truth[tt, 0]
    obs_t = tt
    obs_j = jj
    obs_z = np.stack(
        [rr + rng.normal(0, meas_noise, rr.shape),
         np.arctan2(np.sin(brg), np.cos(brg))
         + rng.normal(0, meas_noise, rr.shape)], axis=-1)
    M = len(obs_t)

    bundle = schur.BundleProblem(
        poses=odo.astype(npdt),            # replaced by stage-1 output
        landmarks=(lms + rng.normal(0, 0.05, lms.shape)).astype(npdt),
        odo_meas=rels.astype(npdt),
        odo_info=info_odo.astype(npdt),
        obs_t=np.asarray(obs_t, np.int32),
        obs_j=np.asarray(obs_j, np.int32),
        obs_z=obs_z.astype(npdt),
        obs_info=(np.eye(2) / meas_noise ** 2).astype(npdt),
        obs_w=np.ones(M, npdt),
        anchor_w=np.asarray(1e8, npdt),
    )
    return MegaMapProblem(
        truth_poses=truth.astype(npdt),
        truth_lms=lms.astype(npdt),
        graph=graph, bundle=bundle)


def run_megamap(N: int = 1024, T: int = 64, obs_per_pose: int = 16,
                mesh=None, pg_iters: int = 8, gn_iters: int = 4,
                cg_iters: int = 48, dtype=jnp.float32):
    """Two-stage refinement; returns (problem, refined BundleProblem)."""
    if mesh is None:
        mesh = make_mesh(jax.devices()[:1], data=1)
    n_map = mesh.shape["map"]

    prob = synthesize(N, T, obs_per_pose, dtype=dtype)

    # stage 1: loop closure on the pose graph, solved on the HOST in f64
    # (pg.optimize_host). Dense normal equations: chain graphs are too
    # ill-conditioned for (even block-Jacobi preconditioned) CG —
    # information crosses ~1 edge/iteration — and at 50k-map extent the
    # f32 GN sits on a stability cliff, so the small serial solve runs
    # host-side in double while the device does the sharded landmark stage.
    g = pg.optimize_host(prob.graph, iters=pg_iters)

    # stage 2: distributed Schur bundle refinement from the closed poses.
    # All GN iterations run inside ONE device program (gn_steps) instead of
    # one dispatch per step.
    bundle = prob.bundle._replace(poses=g.poses)
    part = schur_dist.partition_problem(bundle, n_map)
    step = schur_dist.make_sharded_gn(
        mesh, T=T, N=N, M=part.obs_t.shape[0], cg_iters=cg_iters,
        gn_steps=gn_iters)
    return prob, step(part)
