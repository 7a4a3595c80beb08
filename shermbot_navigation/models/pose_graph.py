"""SE(2) keyframe pose-graph optimization (loop closure).

The reference has no smoothing/refinement at all — its only trajectory
estimate is the online EKF (SURVEY.md section 5 "long-context" row calls for
keyframe pose graphs as the config-5 component). This module is the
from-scratch accelerator design:

- a pose graph is arrays: poses (T, 3) ``[th, x, y]`` + edges
  (odometry & loop closures) as index pairs with measured relative poses
  and information matrices;
- residuals use the SE(2) group: ``e = log(Z^-1 (X_i^-1 X_j))`` with the
  heading wrapped; Jacobians come from ``jax.jacfwd`` on the residual —
  no hand-derived formulas to get wrong, and XLA fuses the batched (3,3)
  blocks anyway;
- one Gauss-Newton step assembles the normal equations either densely
  (small graphs) or matrix-free via conjugate gradients (``solve="cg"``),
  where ``H v`` is an edge-wise gather -> block product -> scatter-add —
  the form that shards over a device mesh (see parallel/schur_dist.py);
- pose 0 is gauge-anchored with a strong prior.

Everything is fixed-shape: pad edges and mask with ``weight=0``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import se2
from ..ops.smallalg import solve3

PRECISION = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    poses: jnp.ndarray    # (T, 3) [th, x, y]
    edge_i: jnp.ndarray   # (E,) int32 source pose index
    edge_j: jnp.ndarray   # (E,) int32 target pose index
    meas: jnp.ndarray     # (E, 3) measured relative pose [th, x, y]
    info: jnp.ndarray     # (E, 3, 3) information matrix
    weight: jnp.ndarray   # (E,) 0/1 mask for padded edges


def edge_residual(xi, xj, zij):
    """``log(Z^-1 (X_i^-1 X_j))`` as ``[dth, dx, dy]`` (heading wrapped)."""
    Ti = se2.from_pose(xi)
    Tj = se2.from_pose(xj)
    Z = se2.from_pose(zij)
    E = se2.compose(se2.inv(Z), se2.compose(se2.inv(Ti), Tj))
    p = se2.to_pose(E)
    return p.at[..., 0].set(se2.normalize_angle(p[..., 0]))


_res_and_jac = jax.vmap(
    lambda xi, xj, z: (
        edge_residual(xi, xj, z),
        jax.jacfwd(edge_residual, argnums=0)(xi, xj, z),
        jax.jacfwd(edge_residual, argnums=1)(xi, xj, z),
    )
)


def residuals(g: PoseGraph):
    """(E, 3) residuals + per-edge Jacobians (E, 3, 3) wrt xi and xj."""
    xi = g.poses[g.edge_i]
    xj = g.poses[g.edge_j]
    return _res_and_jac(xi, xj, g.meas)


def chi2(g: PoseGraph):
    r, _, _ = residuals(g)
    return jnp.sum(
        g.weight * jnp.einsum("ei,eij,ej->e", r, g.info, r,
                              precision=PRECISION))


def _assemble_rhs(g: PoseGraph, r, Ji, Jj):
    """b = sum_e J^T Omega r scattered to pose blocks; (T, 3)."""
    T = g.poses.shape[0]
    w = g.weight[:, None]
    Or = jnp.einsum("eij,ej->ei", g.info, r, precision=PRECISION)
    bi = jnp.einsum("eji,ej->ei", Ji, Or, precision=PRECISION) * w
    bj = jnp.einsum("eji,ej->ei", Jj, Or, precision=PRECISION) * w
    b = jnp.zeros((T, 3), g.poses.dtype)
    b = b.at[g.edge_i].add(bi)
    b = b.at[g.edge_j].add(bj)
    return b


def _hv(g: PoseGraph, Ji, Jj, v, anchor_w):
    """Matrix-free ``H v`` for CG: edge-wise gather/product/scatter.

    ``H = sum_e J_e^T Omega J_e + anchor``; v is (T, 3).
    """
    w = g.weight[:, None]
    vi = v[g.edge_i]
    vj = v[g.edge_j]
    Jv = (jnp.einsum("eij,ej->ei", Ji, vi, precision=PRECISION)
          + jnp.einsum("eij,ej->ei", Jj, vj, precision=PRECISION))
    OJv = jnp.einsum("eij,ej->ei", g.info, Jv, precision=PRECISION)
    hi = jnp.einsum("eji,ej->ei", Ji, OJv, precision=PRECISION) * w
    hj = jnp.einsum("eji,ej->ei", Jj, OJv, precision=PRECISION) * w
    out = jnp.zeros_like(v)
    out = out.at[g.edge_i].add(hi)
    out = out.at[g.edge_j].add(hj)
    # gauge anchor on pose 0
    out = out.at[0].add(anchor_w * v[0])
    return out


def _diag_blocks(g: PoseGraph, Ji, Jj, anchor_w, damping):
    """Block-diagonal (T, 3, 3) of H for Jacobi preconditioning."""
    T = g.poses.shape[0]
    w = g.weight[:, None, None]
    Oi = jnp.einsum("eij,ejk->eik", g.info, Ji, precision=PRECISION)
    Oj = jnp.einsum("eij,ejk->eik", g.info, Jj, precision=PRECISION)
    Hii = jnp.einsum("eji,ejk->eik", Ji, Oi, precision=PRECISION) * w
    Hjj = jnp.einsum("eji,ejk->eik", Jj, Oj, precision=PRECISION) * w
    D = jnp.zeros((T, 3, 3), g.poses.dtype)
    D = D.at[g.edge_i].add(Hii)
    D = D.at[g.edge_j].add(Hjj)
    D = D.at[0].add(anchor_w * jnp.eye(3, dtype=g.poses.dtype))
    return D + damping * jnp.eye(3, dtype=g.poses.dtype)


def _cg(matvec, b, iters, precond=None):
    """(Preconditioned) conjugate gradients on the pose-block space.

    Chain-structured graphs are ill-conditioned (information propagates one
    edge per iteration); block-Jacobi preconditioning with the 3x3 diagonal
    blocks makes CG usable at long T."""
    Minv = precond if precond is not None else (lambda r: r)
    x = jnp.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = jnp.sum(r * z)

    def body(carry, _):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.maximum(jnp.sum(p * Ap), 1e-30)
        alpha = rz / denom
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=iters)
    return x


def gauss_newton_step(g: PoseGraph, damping: float = 1e-6,
                      anchor_w: float = 1e6, solve: str = "dense",
                      cg_iters: int = 50) -> PoseGraph:
    """One (Levenberg-damped) Gauss-Newton step. ``solve``: "dense" builds
    the (3T, 3T) normal matrix (fine to a few thousand keyframes on one
    chip); "cg" is matrix-free."""
    T = g.poses.shape[0]
    r, Ji, Jj = residuals(g)
    b = _assemble_rhs(g, r, Ji, Jj)

    if solve == "dense":
        H = jnp.zeros((T, 3, T, 3), g.poses.dtype)
        w = g.weight[:, None, None]
        Oi = jnp.einsum("eij,ejk->eik", g.info, Ji, precision=PRECISION)
        Oj = jnp.einsum("eij,ejk->eik", g.info, Jj, precision=PRECISION)
        Hii = jnp.einsum("eji,ejk->eik", Ji, Oi, precision=PRECISION) * w
        Hij = jnp.einsum("eji,ejk->eik", Ji, Oj, precision=PRECISION) * w
        Hji = jnp.einsum("eji,ejk->eik", Jj, Oi, precision=PRECISION) * w
        Hjj = jnp.einsum("eji,ejk->eik", Jj, Oj, precision=PRECISION) * w
        H = H.at[g.edge_i, :, g.edge_i, :].add(Hii)
        H = H.at[g.edge_i, :, g.edge_j, :].add(Hij)
        H = H.at[g.edge_j, :, g.edge_i, :].add(Hji)
        H = H.at[g.edge_j, :, g.edge_j, :].add(Hjj)
        H = H.at[0, :, 0, :].add(anchor_w * jnp.eye(3, dtype=g.poses.dtype))
        Hm = H.reshape(3 * T, 3 * T)
        Hm = Hm + damping * jnp.eye(3 * T, dtype=g.poses.dtype)
        # Jacobi equilibration: exact in infinite precision, and keeps the
        # f32 solve stable when information scales span decades (an f32
        # LU at (3T)^2 otherwise overflows to NaN on ill-conditioned
        # long-chain graphs).
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(Hm), 1e-12))
        Hs = Hm / d[:, None] / d[None, :]
        y = jnp.linalg.solve(Hs, -b.reshape(-1) / d)
        dx = (y / d).reshape(T, 3)
    elif solve == "cg":
        mv = lambda v: _hv(g, Ji, Jj, v, anchor_w) + damping * v
        D = _diag_blocks(g, Ji, Jj, anchor_w, damping)
        dx = _cg(mv, -b, cg_iters, precond=lambda r: solve3(D, r))
    else:
        raise ValueError(solve)

    poses = g.poses + dx
    poses = poses.at[:, 0].set(se2.normalize_angle(poses[:, 0]))
    poses = gauge_project(poses, g.poses[0])
    return g._replace(poses=poses)


def gauge_project(poses, target0, landmarks=None):
    """Apply the rigid motion G with ``G o pose0 == target0`` to all poses
    (and optionally landmarks).

    The gauge anchor enters H only (its residual is zero at every
    linearization point), so the anchor resists motion of pose 0 within a
    step but ratifies wherever it lands — over many GN steps the solution
    drifts along the near-free global-rotation mode (the only stiffness is
    the finite anchor weight against huge observation gradients). Projecting
    the gauge after each step removes the mode exactly: observation and
    odometry residuals are invariant under G, and the anchor residual
    becomes exactly zero."""
    dth = se2.normalize_angle(target0[0] - poses[0, 0])
    c, s = jnp.cos(dth), jnp.sin(dth)
    p0 = poses[0, 1:]
    tx = target0[1] - (c * p0[0] - s * p0[1])
    ty = target0[2] - (s * p0[0] + c * p0[1])
    x, y = poses[:, 1], poses[:, 2]
    # wrap headings RELATIVE to the target so pose 0 comes back exactly
    # target0[0] even when the target heading lies outside (-pi, pi]
    th = se2.normalize_angle(poses[:, 0] + dth - target0[0]) + target0[0]
    out = jnp.stack([th, c * x - s * y + tx, s * x + c * y + ty], axis=-1)
    if landmarks is None:
        return out
    lx, ly = landmarks[..., 0], landmarks[..., 1]
    lms = jnp.stack([c * lx - s * ly + tx, s * lx + c * ly + ty], axis=-1)
    return out, lms


def optimize(g: PoseGraph, iters: int = 10, **kw) -> PoseGraph:
    """Run ``iters`` GN steps under one jit (lax.scan over steps)."""
    def body(gg, _):
        return gauss_newton_step(gg, **kw), None

    g, _ = jax.lax.scan(body, g, None, length=iters)
    return g


# ---------------------------------------------------------------------------
# Host-side float64 solver
# ---------------------------------------------------------------------------

def optimize_host(g: PoseGraph, iters: int = 10, damping: float = 1e-6,
                  anchor_w: float = 1e6) -> PoseGraph:
    """Dense Gauss-Newton on the HOST in float64 (numpy).

    The pose graph is the small serial stage of large-map refinement (T
    keyframes, a (3T)^2 solve — microseconds of FLOPs) while its chain
    conditioning grows with map extent: at 50k-landmark scale (loop radius
    ~112 m) float32 GN sits on a stability cliff (some noise realizations
    diverge), and f64 on an accelerator is slow where it exists at all.
    So the framework runs this stage on the host in f64 — the same split
    as the C++ host runtime — and reserves the device for the big sharded
    landmark stage
    (parallel/schur_dist.py). Matches ``optimize(..., solve="dense")``
    in exact arithmetic (see tests/test_refinement.py)."""
    import numpy as np

    poses = np.asarray(g.poses, np.float64).copy()
    ei = np.asarray(g.edge_i)
    ej = np.asarray(g.edge_j)
    meas = np.asarray(g.meas, np.float64)
    info = np.asarray(g.info, np.float64)
    w = np.asarray(g.weight, np.float64)
    T = poses.shape[0]
    E = ei.shape[0]

    def wrap(a):
        return np.arctan2(np.sin(a), np.cos(a))

    target0 = poses[0].copy()
    for _ in range(iters):
        thi = poses[ei, 0]
        u = poses[ej, 1:3] - poses[ei, 1:3]
        ci, si = np.cos(thi), np.sin(thi)
        # A = R(-thi); m = A u - z_xy; e = [wrap(dth - zth), R(-zth) m]
        Au = np.stack([ci * u[:, 0] + si * u[:, 1],
                       -si * u[:, 0] + ci * u[:, 1]], -1)
        m = Au - meas[:, 1:3]
        zc, zs = np.cos(meas[:, 0]), np.sin(meas[:, 0])
        Rz = np.stack([np.stack([zc, zs], -1),
                       np.stack([-zs, zc], -1)], -2)      # (E, 2, 2) R(-zth)
        e = np.empty((E, 3))
        e[:, 0] = wrap(poses[ej, 0] - thi - meas[:, 0])
        e[:, 1:] = np.einsum("eij,ej->ei", Rz, m)

        # Jacobians wrt [th, x, y] of pose i and pose j
        dAu = np.stack([-si * u[:, 0] + ci * u[:, 1],
                        -ci * u[:, 0] - si * u[:, 1]], -1)  # dA/dthi @ u
        A = np.stack([np.stack([ci, si], -1),
                      np.stack([-si, ci], -1)], -2)          # (E, 2, 2)
        RzA = np.einsum("eij,ejk->eik", Rz, A)
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0, 0] = -1.0
        Jj[:, 0, 0] = 1.0
        Ji[:, 1:, 0] = np.einsum("eij,ej->ei", Rz, dAu)
        Ji[:, 1:, 1:] = -RzA
        Jj[:, 1:, 1:] = RzA

        Oi = np.einsum("eij,ejk->eik", info, Ji) * w[:, None, None]
        Oj = np.einsum("eij,ejk->eik", info, Jj) * w[:, None, None]
        H = np.zeros((T, 3, T, 3))
        np.add.at(H, (ei, slice(None), ei, slice(None)),
                  np.einsum("eji,ejk->eik", Ji, Oi))
        np.add.at(H, (ei, slice(None), ej, slice(None)),
                  np.einsum("eji,ejk->eik", Ji, Oj))
        np.add.at(H, (ej, slice(None), ei, slice(None)),
                  np.einsum("eji,ejk->eik", Jj, Oi))
        np.add.at(H, (ej, slice(None), ej, slice(None)),
                  np.einsum("eji,ejk->eik", Jj, Oj))
        H[0, :, 0, :] += anchor_w * np.eye(3)
        b = np.zeros((T, 3))
        Or = np.einsum("eij,ej->ei", info, e) * w[:, None]
        np.add.at(b, ei, np.einsum("eji,ej->ei", Ji, Or))
        np.add.at(b, ej, np.einsum("eji,ej->ei", Jj, Or))

        Hm = H.reshape(3 * T, 3 * T) + damping * np.eye(3 * T)
        dx = np.linalg.solve(Hm, -b.reshape(-1)).reshape(T, 3)
        poses += dx
        poses[:, 0] = wrap(poses[:, 0])
        # gauge projection (same rationale + relative wrap as gauge_project)
        dth = wrap(target0[0] - poses[0, 0])
        c, s = np.cos(dth), np.sin(dth)
        tx = target0[1] - (c * poses[0, 1] - s * poses[0, 2])
        ty = target0[2] - (s * poses[0, 1] + c * poses[0, 2])
        x, y = poses[:, 1].copy(), poses[:, 2].copy()
        poses[:, 0] = wrap(poses[:, 0] + dth - target0[0]) + target0[0]
        poses[:, 1] = c * x - s * y + tx
        poses[:, 2] = s * x + c * y + ty

    # stay host-side: callers upload to device (if at all) when the jitted
    # stage-2 step consumes the poses
    return g._replace(poses=poses.astype(np.dtype(g.poses.dtype)))


# ---------------------------------------------------------------------------
# Graph construction helpers
# ---------------------------------------------------------------------------

def odometry_edges(poses_odom, info):
    """Consecutive-pose edges from an odometry trajectory (T, 3)."""
    T = poses_odom.shape[0]
    i = jnp.arange(T - 1, dtype=jnp.int32)
    j = i + 1
    Ti = se2.from_pose(poses_odom[:-1])
    Tj = se2.from_pose(poses_odom[1:])
    meas = se2.to_pose(se2.compose(se2.inv(Ti), Tj))
    info_e = jnp.broadcast_to(info, (T - 1, 3, 3))
    return i, j, meas, info_e


def build_graph(poses_init, edges):
    """Stack (i, j, meas, info) edge groups into one padded PoseGraph."""
    ei = jnp.concatenate([e[0] for e in edges])
    ej = jnp.concatenate([e[1] for e in edges])
    meas = jnp.concatenate([e[2] for e in edges])
    info = jnp.concatenate([e[3] for e in edges])
    return PoseGraph(
        poses=jnp.asarray(poses_init),
        edge_i=ei.astype(jnp.int32),
        edge_j=ej.astype(jnp.int32),
        meas=meas,
        info=info,
        weight=jnp.ones(ei.shape[0], jnp.asarray(poses_init).dtype),
    )
