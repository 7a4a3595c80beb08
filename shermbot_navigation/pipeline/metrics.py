"""Trajectory and filter-consistency metrics.

The reference's only 'metrics' are rviz paths eyeballed by a human
(``/real_path`` tube_world.cpp:391-402, ``/odom_path`` slam.cpp:161-173).
Here: absolute trajectory error (ATE), relative pose error (RPE), and NEES
(normalized estimation error squared) for filter consistency — all pure
functions over stacked rollout outputs.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import se2
from ..ops.smallalg import solve3


def ate(est_xy, true_xy):
    """Root-mean-square absolute trajectory error over (T, 2) positions."""
    d = jnp.asarray(est_xy) - jnp.asarray(true_xy)
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1)))


def max_te(est_xy, true_xy):
    """Maximum translational error."""
    d = jnp.asarray(est_xy) - jnp.asarray(true_xy)
    return jnp.sqrt(jnp.max(jnp.sum(d * d, axis=-1)))


def heading_rmse(est_th, true_th):
    """RMS heading error with angle wrapping."""
    e = se2.normalize_angle(jnp.asarray(est_th) - jnp.asarray(true_th))
    return jnp.sqrt(jnp.mean(e * e))


def rpe(est_poses, true_poses, delta: int = 10):
    """Relative pose error: RMS translational drift over windows of
    ``delta`` ticks. Poses are (T, 3) ``[th, x, y]``."""
    est = jnp.asarray(est_poses)
    tru = jnp.asarray(true_poses)
    Te = se2.from_pose(est)
    Tt = se2.from_pose(tru)
    rel_e = se2.compose(se2.inv(Te[:-delta]), Te[delta:])
    rel_t = se2.compose(se2.inv(Tt[:-delta]), Tt[delta:])
    err = se2.compose(se2.inv(rel_t), rel_e)
    d = err[..., 2:4]
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1)))


def nis(dz, psi):
    """Per-measurement normalized innovation squared ``dz^T psi^{-1} dz``
    (2 dof). ``dz``: (..., 2) innovations; ``psi``: (..., 2, 2) innovation
    covariances (``models.ekf_slam.innovation``). A consistent filter has
    mean NIS ~= 2 over a rollout (chi-square with 2 dof per sample)."""
    dz = jnp.asarray(dz)
    psi = jnp.asarray(psi)
    a, b = psi[..., 0, 0], psi[..., 0, 1]
    c, d = psi[..., 1, 0], psi[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.full_like(det, 1e-30), det)
    e0, e1 = dz[..., 0], dz[..., 1]
    return (d * e0 * e0 - (b + c) * e0 * e1 + a * e1 * e1) / det


def nees(est_pose, true_pose, cov3):
    """Per-step NEES of the robot block: ``e^T P^{-1} e`` with the heading
    error wrapped. ``est_pose``/``true_pose``: (..., 3) ``[th, x, y]``;
    ``cov3``: (..., 3, 3) robot-block covariance."""
    e = jnp.asarray(est_pose) - jnp.asarray(true_pose)
    e = e.at[..., 0].set(se2.normalize_angle(e[..., 0]))
    # closed-form 3x3 solve, not jnp.linalg.solve on a tiny system inside
    # scan (see ops/smallalg.py)
    sol = solve3(jnp.asarray(cov3), e)
    return jnp.sum(e * sol, axis=-1)
