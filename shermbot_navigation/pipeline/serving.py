"""Single-robot serving at large map sizes: the deferred whole-tick kernels.

The reference's serving loop (``nuslam/src/slam.cpp:231-365`` driving
``slam_library.cpp:263-282``) processes each tick's M measurements as M
sequential dense Kalman updates. At serving scale (D = 3+2N ~ 4096,
Sigma = 67 MB f32) every update is a full read+write of Sigma, so the tick
moves ~(M+1) x 2 x 4D^2 bytes, and no schedule of that per-update form can
get under it while Sigma round-trips per update.

This module routes serving through the machinery that solves the same
problem for the config-4 workload (``parallel/blocked_ekf`` +
``ops/pallas/grid_update``): the measurement scan runs over the O(N)
strips only (replay algebra keeps it sequentially consistent), and the
landmark grid is touched by ONE rank-2M pass per tick instead of one
rank-2 pass per update — the deferred tick at map=1, batch=1.

Use ``ServingEngine`` for a stateful single-robot loop, or
``make_serving_step`` + ``state_from_dense`` to embed the functional step
in your own jitted program. A converged dense map migrates in with
``state_from_dense`` (exact block re-layout, no approximation).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models.ekf_slam import EKFConfig, EKFState
from ..parallel import bigmap, blocked_ekf
from ..parallel.mesh import make_mesh


def state_from_dense(config: EKFConfig, st: EKFState
                     ) -> blocked_ekf.BlockedState:
    """Re-layout a dense :class:`EKFState` into the blocked/comp-plane
    serving state (batch dim 1). Exact: every covariance entry lands in
    its block (``plane[p, q, n, m] = cov[3+2n+p, 3+2m+q]``)."""
    N = config.num_landmarks
    D = 3 + 2 * N
    mean = st.mean[:D]
    cov = st.cov[:D, :D]
    cov_mm = jnp.transpose(cov[3:, 3:].reshape(N, 2, N, 2), (1, 3, 0, 2))
    diag4 = jnp.diagonal(cov_mm, axis1=-2, axis2=-1).reshape(4, N)
    return blocked_ekf.BlockedState(
        mean_r=mean[:3][None],
        mean_m=mean[3:].reshape(N, 2)[None],
        cov_rr=cov[:3, :3][None],
        cov_rm=cov[:3, 3:].reshape(3, N, 2)[None],
        cov_mm=cov_mm[None],
        diag4=diag4[None],
        n_seen=st.n_seen[None],
        seen=st.seen[None],
    )


def state_to_dense(config: EKFConfig, bst: blocked_ekf.BlockedState
                   ) -> EKFState:
    """Inverse of :func:`state_from_dense` (batch element 0) — for tests
    and for migrating a served map back to the dense engine."""
    N = config.num_landmarks
    D = config.dim
    mean = jnp.zeros((D,), bst.mean_r.dtype)
    mean = mean.at[:3].set(bst.mean_r[0])
    mean = mean.at[3:3 + 2 * N].set(bst.mean_m[0].reshape(-1))
    cov = jnp.zeros((D, D), bst.cov_rr.dtype)
    cov = cov.at[:3, :3].set(bst.cov_rr[0])
    rm = bst.cov_rm[0].reshape(3, 2 * N)
    cov = cov.at[:3, 3:3 + 2 * N].set(rm)
    cov = cov.at[3:3 + 2 * N, :3].set(rm.T)
    mm = jnp.transpose(bst.cov_mm[0], (2, 0, 3, 1)).reshape(2 * N, 2 * N)
    cov = cov.at[3:3 + 2 * N, 3:3 + 2 * N].set(mm)
    return EKFState(mean=mean, cov=cov, n_seen=bst.n_seen[0],
                    seen=bst.seen[0])


def make_serving_step(config: EKFConfig, max_meas: int, known: bool = True,
                      dtype=jnp.float32, grid_kernel: bool | None = None,
                      kernel_interpret: bool = False, donate: bool = True):
    """Build the jitted single-robot serving tick on one device.

    Returns ``tick(state, twist (3,), zs (M, 2), valid (M,), ids (M,),
    Q, R) -> state`` for ``known=True`` (``ids`` absent for unknown
    association — the reference's Mahalanobis first-hit gating). The
    grid pass auto-routes exactly like the config-4 production path
    (``bigmap._resolve_grid_kernel``): on a GPU in f32 for power-of-two
    maps of at least ``bigmap.GRID_KERNEL_MIN_N`` landmarks it is the
    one-read-one-write Pallas kernel; otherwise the XLA deferred schedule
    (identical semantics either way). ``donate=True`` reuses the input grid's
    allocation — serving states are linear chains.
    """
    mesh = make_mesh(jax.devices()[:1], data=1)
    gridk = bigmap._resolve_grid_kernel(grid_kernel, config, mesh, dtype)
    mk = (blocked_ekf.make_sharded_deferred_step if known
          else blocked_ekf.make_sharded_deferred_unknown_step)
    step = mk(config, mesh, 1, max_meas, grid_kernel=gridk,
              kernel_interpret=kernel_interpret)

    if known:
        @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
        def tick(state, twist, zs, valid, ids, Q, R):
            return step(state, twist[None], zs[None], valid[None],
                        ids[None], Q, R)
    else:
        @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
        def tick(state, twist, zs, valid, Q, R):
            return step(state, twist[None], zs[None], valid[None], Q, R)
    return tick


class ServingEngine:
    """Stateful single-robot serving loop (the device counterpart of the
    C++ ``HostEngine`` serving path — use that one when no GPU is attached;
    use this one when the map is too large for dense O(D^2)-per-update
    serving). Holds a blocked state and applies deferred ticks.

    ``measurements`` shorter than ``max_meas`` are padded with
    ``valid=False`` slots (static shapes; the step compiles once)."""

    def __init__(self, config: EKFConfig, max_meas: int, Q, R,
                 known: bool = True, robot_pose=None, dense_state=None,
                 dtype=jnp.float32, **kw):
        self.config = config
        self.max_meas = max_meas
        self.known = known
        self._Q = jnp.asarray(Q, dtype)
        self._R = jnp.asarray(R, dtype)
        if dense_state is not None:
            self.state = state_from_dense(config, dense_state)
        else:
            self.state = blocked_ekf.init(config, 1, robot_pose=robot_pose,
                                          dtype=dtype)
        self._tick = make_serving_step(config, max_meas, known=known,
                                       dtype=dtype, **kw)
        self._dtype = dtype

    def tick(self, twist, zs, valid=None, ids=None):
        M = self.max_meas
        zs = jnp.asarray(zs, self._dtype).reshape(-1, 2)
        m = zs.shape[0]
        if m > M:
            raise ValueError(f"{m} measurements > max_meas {M}")
        pad = M - m
        if valid is None:
            valid = jnp.ones((m,), bool)
        zs = jnp.pad(zs, ((0, pad), (0, 0)))
        valid = jnp.pad(jnp.asarray(valid, bool), (0, pad))
        tw = jnp.asarray(twist, self._dtype)
        if self.known:
            if ids is None:
                raise ValueError("known-association serving needs ids")
            ids = jnp.pad(jnp.asarray(ids, jnp.int32), (0, pad))
            self.state = self._tick(self.state, tw, zs, valid, ids,
                                    self._Q, self._R)
        else:
            self.state = self._tick(self.state, tw, zs, valid,
                                    self._Q, self._R)
        return self.state

    @property
    def pose(self):
        return self.state.mean_r[0]

    @property
    def n_seen(self):
        return int(self.state.n_seen[0])
