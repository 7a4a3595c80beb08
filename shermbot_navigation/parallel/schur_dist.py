"""Distributed Schur-complement refinement (BASELINE config 5).

Shards the bundle problem of ``models.schur`` over the 'map' mesh axis:
landmarks live on their owner shard together with every observation that
references them (observations are pre-partitioned by landmark id, so the
landmark-side products ``Hll``, ``Hlp v``, ``Hpl u`` are fully local).
Pose-space vectors (T, 3) are replicated; each CG matvec combines the
shards' pose-space partials with ONE ``psum`` — the communication pattern
is a single all-reduce of (T, 3) floats per iteration, riding ICI.

The odometry-chain part of ``Hpp`` is computed redundantly on every shard
(it is O(T) — negligible next to the observation terms) so no additional
collective is needed.

Partitioning contract: observation arrays are ordered so shard s owns the
slice ``[s * M_local, (s+1) * M_local)`` and every observation in that slice
references a landmark in ``[s * N_local, (s+1) * N_local)``. Use
:func:`partition_problem` to reorder/pad an arbitrary problem into this
layout (host-side, once).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import schur
from ..ops.smallalg import solve3
from ..models.pose_graph import (PoseGraph, gauge_project,
                                 residuals as pg_residuals)
from ..ops import se2

PRECISION = jax.lax.Precision.HIGHEST


def partition_problem(prob: schur.BundleProblem, n_shards: int
                      ) -> schur.BundleProblem:
    """Reorder observations by landmark owner and pad each shard's slice to
    a common length (host-side numpy; run once before jit)."""
    N = prob.landmarks.shape[0]
    if N % n_shards:
        raise ValueError(f"N={N} not divisible by {n_shards}")
    n_local = N // n_shards
    obs_j = np.asarray(prob.obs_j)
    obs_w = np.asarray(prob.obs_w)
    owner = obs_j // n_local
    counts = [int(((owner == s) & (obs_w > 0)).sum())
              for s in range(n_shards)]
    m_local = max(counts) if counts else 1
    m_local = max(m_local, 1)

    idx_t = np.zeros((n_shards, m_local), np.int32)
    idx_j = np.full((n_shards, m_local), 0, np.int32)
    z = np.zeros((n_shards, m_local, 2), np.asarray(prob.obs_z).dtype)
    w = np.zeros((n_shards, m_local), np.asarray(prob.obs_w).dtype)
    for s in range(n_shards):
        sel = np.where((owner == s) & (obs_w > 0))[0]
        k = len(sel)
        idx_t[s, :k] = np.asarray(prob.obs_t)[sel]
        idx_j[s, :k] = obs_j[sel]
        # padded slots must reference a landmark the shard owns
        idx_j[s, k:] = s * n_local
        z[s, :k] = np.asarray(prob.obs_z)[sel]
        w[s, :k] = 1.0
    return prob._replace(
        obs_t=jnp.asarray(idx_t.reshape(-1)),
        obs_j=jnp.asarray(idx_j.reshape(-1)),
        obs_z=jnp.asarray(z.reshape(-1, 2)),
        obs_w=jnp.asarray(w.reshape(-1)),
    )


def make_sharded_gn(mesh: Mesh, T: int, N: int, M: int,
                    cg_iters: int = 64, damping: float = 1e-6,
                    gn_steps: int = 1):
    """Build the jitted sharded Gauss-Newton refinement.

    Array placement: poses/odometry replicated; ``landmarks`` (N, 2) and the
    observation arrays (M,) sharded over 'map'. Returns
    ``step(prob) -> prob`` applying ``gn_steps`` GN iterations.

    ``gn_steps`` loops INSIDE the program (lax.scan): one device program for
    the whole refinement, instead of one dispatch per step with each
    call's outputs fed back as the next call's inputs.
    """
    n_map = mesh.shape["map"]
    if N % n_map or M % n_map:
        raise ValueError("N and M must divide the map axis")

    in_specs = schur.BundleProblem(
        poses=P(), landmarks=P("map", None),
        odo_meas=P(), odo_info=P(),
        obs_t=P("map"), obs_j=P("map"), obs_z=P("map", None),
        obs_info=P(), obs_w=P("map"), anchor_w=P(),
    )

    def shard_fn(prob: schur.BundleProblem):
        (poses, landmarks), _ = jax.lax.scan(
            lambda carry, _: (_gn_once(prob, *carry, damping=damping,
                                       cg_iters=cg_iters), None),
            (prob.poses, prob.landmarks), None, length=gn_steps)
        return prob._replace(poses=poses, landmarks=landmarks)

    def _gn_once(prob, cur_poses, cur_landmarks, *, damping, cg_iters):
        # local views: landmarks (Nl, 2); obs (Ml,) referencing GLOBAL ids
        shard = jax.lax.axis_index("map")
        n_local = cur_landmarks.shape[0]
        off = shard * n_local
        dtype = cur_poses.dtype
        prob = prob._replace(poses=cur_poses, landmarks=cur_landmarks)

        # odometry graph (replicated, cheap)
        Tn = prob.poses.shape[0]
        ii = jnp.arange(Tn - 1, dtype=jnp.int32)
        g = PoseGraph(
            poses=prob.poses, edge_i=ii, edge_j=ii + 1, meas=prob.odo_meas,
            info=jnp.broadcast_to(prob.odo_info, (Tn - 1, 3, 3)),
            weight=jnp.ones(Tn - 1, dtype))
        r_o, Ji, Jj = pg_residuals(g)

        # ---- per-observation COMPONENT arrays, all (Ml,) -------------
        # A batched (Ml, 2, 3) Jacobian tensor carries tiny trailing dims
        # through every op (BENCH_NOTES pathology 9).
        # The 9 Jacobian nonzeros (ref slam_library.cpp:162-186) as flat
        # vectors keep every byte useful (same trick as ops/smallalg).
        t = prob.obs_t
        j_loc = prob.obs_j - off
        w = prob.obs_w
        pth = prob.poses[t, 0]
        dx = prob.landmarks[j_loc, 0] - prob.poses[t, 1]
        dy = prob.landmarks[j_loc, 1] - prob.poses[t, 2]
        d = jnp.maximum(dx * dx + dy * dy, 1e-12)
        sq = jnp.sqrt(d)
        r1 = sq - prob.obs_z[:, 0]
        r2 = se2.normalize_angle(
            se2.normalize_angle(jnp.arctan2(dy, dx) - pth)
            - prob.obs_z[:, 1])
        # pose Jacobian rows: range (0, -dx/sq, -dy/sq),
        #                     bearing (-1, dy/d, -dx/d)
        ar_x, ar_y = -dx / sq, -dy / sq
        ab_x, ab_y = dy / d, -dx / d          # theta column is exactly -1
        # landmark Jacobian: range (dx/sq, dy/sq), bearing (-dy/d, dx/d)
        lr_x, lr_y = dx / sq, dy / sq
        lb_x, lb_y = -dy / d, dx / d
        w11 = prob.obs_info[0, 0]
        w12 = prob.obs_info[0, 1]
        w22 = prob.obs_info[1, 1]

        def omega_w(s1, s2):
            """(w * Omega) applied to a measurement-space pair."""
            return (w * (w11 * s1 + w12 * s2), w * (w12 * s1 + w22 * s2))

        def jpT(o1, o2):
            """J_pose^T applied to a measurement-space pair -> 3 comps."""
            return (-o2, ar_x * o1 + ab_x * o2, ar_y * o1 + ab_y * o2)

        def jlT(o1, o2):
            """J_lm^T applied to a measurement-space pair -> 2 comps."""
            return (lr_x * o1 + lb_x * o2, lr_y * o1 + lb_y * o2)

        def jp(v):
            """J_pose applied to pose-space v (T, 3) -> meas pair."""
            vt = v[t]
            return (ar_x * vt[:, 1] + ar_y * vt[:, 2],
                    -vt[:, 0] + ab_x * vt[:, 1] + ab_y * vt[:, 2])

        def jl(u):
            """J_lm applied to landmark-space u (Nl, 2) -> meas pair."""
            ux, uy = u[j_loc, 0], u[j_loc, 1]
            return (lr_x * ux + lr_y * uy, lb_x * ux + lb_y * uy)

        def scat_t(c1, c2, c3):
            return jnp.zeros((Tn, 3), dtype).at[t].add(
                jnp.stack([c1, c2, c3], axis=-1))

        def scat_j(c1, c2):
            return jnp.zeros((n_local, 2), dtype).at[j_loc].add(
                jnp.stack([c1, c2], axis=-1))

        # local Hll blocks (symmetric 2x2 per landmark, 3 component arrays)
        o1x, o2x = omega_w(lr_x, lb_x)        # (w Omega) column x
        o1y, o2y = omega_w(lr_y, lb_y)
        q_xx = lr_x * o1x + lb_x * o2x
        q_xy = lr_x * o1y + lb_x * o2y
        q_yy = lr_y * o1y + lb_y * o2y
        zl = jnp.zeros((n_local,), dtype)
        Hxx = zl.at[j_loc].add(q_xx) + 1e-8
        Hxy = zl.at[j_loc].add(q_xy)
        Hyy = zl.at[j_loc].add(q_yy) + 1e-8
        det = jnp.maximum(Hxx * Hyy - Hxy * Hxy, 1e-30)
        ixx, ixy, iyy = Hyy / det, -Hxy / det, Hxx / det

        def hll_inv(u):
            """Hll^-1 applied per landmark to u (Nl, 2)."""
            ux, uy = u[..., 0], u[..., 1]
            return jnp.stack([ixx * ux + ixy * uy,
                              ixy * ux + iyy * uy], axis=-1)

        # rhs
        Or = jnp.einsum("eij,ej->ei", g.info, r_o, precision=PRECISION)
        bp_odo = jnp.zeros((Tn, 3), dtype)
        bp_odo = bp_odo.at[g.edge_i].add(
            jnp.einsum("eji,ej->ei", Ji, Or, precision=PRECISION))
        bp_odo = bp_odo.at[g.edge_j].add(
            jnp.einsum("eji,ej->ei", Jj, Or, precision=PRECISION))

        or1, or2 = omega_w(r1, r2)
        bp_obs_local = scat_t(*jpT(or1, or2))
        bl_local = scat_j(*jlT(or1, or2))

        def hlp_v(v):
            o1, o2 = omega_w(*jp(v))
            return scat_j(*jlT(o1, o2))

        def hpl_u_local(u):
            o1, o2 = omega_w(*jl(u))
            return scat_t(*jpT(o1, o2))

        def hpp_obs_v(v):
            o1, o2 = omega_w(*jp(v))
            return scat_t(*jpT(o1, o2))

        def hpp_odo_v(v):
            vi = v[g.edge_i]
            vj = v[g.edge_j]
            Jv = (jnp.einsum("eij,ej->ei", Ji, vi, precision=PRECISION)
                  + jnp.einsum("eij,ej->ei", Jj, vj, precision=PRECISION))
            OJv = jnp.einsum("eij,ej->ei", g.info, Jv, precision=PRECISION)
            out = jnp.zeros_like(v)
            out = out.at[g.edge_i].add(
                jnp.einsum("eji,ej->ei", Ji, OJv, precision=PRECISION))
            out = out.at[g.edge_j].add(
                jnp.einsum("eji,ej->ei", Jj, OJv, precision=PRECISION))
            return out.at[0].add(prob.anchor_w * v[0])

        def Sv(v):
            # local contributions, then one psum over 'map'
            u = hll_inv(hlp_v(v))
            local = hpp_obs_v(v) - hpl_u_local(u)
            total = jax.lax.psum(local, "map")
            # odo part + damping computed redundantly (identical on shards)
            return total + hpp_odo_v(v) + damping * v

        bp = bp_odo + jax.lax.psum(bp_obs_local, "map")
        rhs = -bp + jax.lax.psum(hpl_u_local(hll_inv(bl_local)), "map")
        # block-Jacobi preconditioner: 3x3 diagonal blocks of Hpp
        # (odometry-chain part + local observation part psummed)
        Dodo = jnp.zeros((Tn, 3, 3), dtype)
        Oi = jnp.einsum("eij,ejk->eik", g.info, Ji, precision=PRECISION)
        Oj = jnp.einsum("eij,ejk->eik", g.info, Jj, precision=PRECISION)
        Dodo = Dodo.at[g.edge_i].add(
            jnp.einsum("eji,ejk->eik", Ji, Oi, precision=PRECISION))
        Dodo = Dodo.at[g.edge_j].add(
            jnp.einsum("eji,ejk->eik", Jj, Oj, precision=PRECISION))
        Dodo = Dodo.at[0].add(prob.anchor_w * jnp.eye(3, dtype=dtype))
        # observation part of diag(Hpp): 6 unique comps of Jp^T (w Omega) Jp
        # with pose columns c_t = (0, -1), c_x = (ar_x, ab_x), c_y = (...)
        p1x, p2x = omega_w(ar_x, ab_x)
        p1y, p2y = omega_w(ar_y, ab_y)
        p_tt = w * w22
        p_tx = -p2x
        p_ty = -p2y
        p_xx = ar_x * p1x + ab_x * p2x
        p_xy = ar_x * p1y + ab_x * p2y
        p_yy = ar_y * p1y + ab_y * p2y
        Dflat = jnp.zeros((Tn, 6), dtype).at[t].add(
            jnp.stack([p_tt, p_tx, p_ty, p_xx, p_xy, p_yy], axis=-1))
        Dobs = jnp.stack([
            jnp.stack([Dflat[:, 0], Dflat[:, 1], Dflat[:, 2]], -1),
            jnp.stack([Dflat[:, 1], Dflat[:, 3], Dflat[:, 4]], -1),
            jnp.stack([Dflat[:, 2], Dflat[:, 4], Dflat[:, 5]], -1),
        ], axis=-2)
        D = Dodo + jax.lax.psum(Dobs, "map") + damping * jnp.eye(
            3, dtype=dtype)

        # preconditioned CG on the replicated pose space
        def cg(matvec, b):
            x = jnp.zeros_like(b)
            r = b
            z = solve3(D, r)
            p = z
            rz = jnp.sum(r * z)

            def body(carry, _):
                x, r, p, rz = carry
                Ap = matvec(p)
                alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * Ap
                z = solve3(D, r)
                rz_new = jnp.sum(r * z)
                p = z + (rz_new / jnp.maximum(rz, 1e-30)) * p
                return (x, r, p, rz_new), None

            (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None,
                                           length=cg_iters)
            return x

        dp = cg(Sv, rhs)
        dl_local = -hll_inv(bl_local + hlp_v(dp))

        poses = prob.poses + dp
        poses = poses.at[:, 0].set(se2.normalize_angle(poses[:, 0]))
        # exact gauge fix (see models.pose_graph.gauge_project): G is
        # computed from replicated pose data, so every shard applies the
        # same rigid motion to its landmark block.
        poses, landmarks = gauge_project(
            poses, prob.poses[0], prob.landmarks + dl_local)
        return poses, landmarks

    fn = shard_map(shard_fn, mesh=mesh, in_specs=(in_specs,),
                   out_specs=in_specs, check_vma=False)
    return jax.jit(fn)
