"""Large synthetic-map workload (BASELINE config 4): thousands of landmarks,
blocked covariance, sharded over the ('data', 'map') mesh.

The workload: B robots random-walk over a big landmark field; every tick
each robot observes ``M`` landmarks (a precomputed visit schedule sweeping
the whole map, known association — the scheme BASELINE.json's config 4
measures) and the blocked EKF performs predict + M sequential updates with
the map dimension sharded over 'map' and the batch over 'data'.

Ground truth is generated analytically (no tube-world needed at this scale);
measurement generation happens inside the same jitted step so nothing
round-trips the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from ..models.ekf_slam import EKFConfig, cartesian2polar
from ..ops import se2
from . import blocked_ekf
from .mesh import make_mesh


class BigMapWorkload(NamedTuple):
    landmarks: jnp.ndarray   # (N, 2) true positions
    cmd: jnp.ndarray         # (T, 3) command twists
    schedule: jnp.ndarray    # (T, M) landmark ids observed per tick


def make_workload(N: int, T: int, M: int, key, spacing: float = 2.0,
                  dtype=jnp.float32) -> BigMapWorkload:
    """Grid of N landmarks; a looping robot; a schedule that sweeps ids so
    every landmark is initialized and revisited."""
    import math
    side = math.ceil(math.sqrt(N))
    ii = jnp.arange(N)
    lms = jnp.stack([(ii % side - side / 2) * spacing,
                     (ii // side - side / 2) * spacing], axis=-1).astype(dtype)
    w = 2 * jnp.pi / max(T, 1)
    cmd = jnp.broadcast_to(
        jnp.array([w, 0.1, 0.0], dtype), (T, 3))
    # sweep: tick t observes ids [t*M .. t*M+M) mod N, then revisits
    t_idx = jnp.arange(T)[:, None]
    schedule = (t_idx * M + jnp.arange(M)[None, :]) % N
    return BigMapWorkload(landmarks=lms, cmd=cmd,
                          schedule=schedule.astype(jnp.int32))


def _true_pose(cmd, t, dtype):
    """Closed-form pose after t constant-twist ticks (arc)."""
    w, v = cmd[0, 0], cmd[0, 1]
    th = w * t
    r = v / w
    x = r * jnp.sin(th)
    y = r * (1.0 - jnp.cos(th))
    return jnp.stack([th, x, y]).astype(dtype)


def kernel_platform(mesh: Mesh) -> bool:
    """Whether the mesh's devices run the compiled Pallas kernels: True on
    a GPU, False on the CPU (the XLA schedule; tests run the kernels in
    interpret mode by asking for them). Any other platform is an error
    rather than a guess."""
    platform = mesh.devices.flat[0].platform
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(f"no kernel routing for platform {platform!r}")


# Smallest map the grid kernel is auto-routed for. On an H100 it cut the
# config-4 tick 1.7-1.9x at N=8192 and 16384, while single-robot serving
# at N=2048 (a 67 MB grid, host dispatch every tick) was not faster in
# two runs (PERF.md).
GRID_KERNEL_MIN_N = 8192


def _resolve_grid_kernel(grid_kernel, cfg: EKFConfig, mesh: Mesh,
                         dtype) -> bool:
    """``None`` -> auto: the fused Pallas grid pass on a GPU for f32,
    a single 'map' shard and power-of-two maps of at least
    ``GRID_KERNEL_MIN_N`` landmarks; the XLA schedule otherwise.
    ``True``/``False`` force the choice (the step raises if the kernel is
    asked for on shapes it does not take)."""
    if grid_kernel is not None:
        return bool(grid_kernel)
    if not kernel_platform(mesh):
        return False
    if dtype != jnp.float32 or mesh.shape["map"] != 1:
        return False
    from ..ops.pallas.grid_update import grid_shapes_supported
    N = cfg.num_landmarks
    return N >= GRID_KERNEL_MIN_N and grid_shapes_supported(N, N)


def make_runner(cfg: EKFConfig, mesh: Mesh, batch: int, M: int,
                deferred: bool = True, grid_kernel: bool | None = None,
                dtype=jnp.float32, donate: bool = False,
                meas_unroll: bool = False):
    """Build ``run(state, workload, Q, R, t0, ticks) -> state`` jitted over
    the mesh: generates measurements on device and applies the sharded
    blocked step ``ticks`` times via lax.scan.

    ``deferred=True`` (default) uses the rank-2M grid update — one full
    landmark-grid pass per tick instead of per measurement, identical
    semantics (test_blocked_ekf::test_deferred_matches_sequential).
    ``grid_kernel=None`` auto-routes the Pallas grid pass (see
    :func:`_resolve_grid_kernel`). ``donate=True`` donates the input state's buffers to the call — the
    out-Sigma reuses the in-Sigma allocation instead of doubling peak HBM
    (1.07 GB apiece at N=8192); the input state is dead after the call, so
    only linear ``state = run(state, ...)`` call chains may enable it."""
    if deferred:
        step = blocked_ekf.make_sharded_deferred_step(
            cfg, mesh, batch, M,
            grid_kernel=_resolve_grid_kernel(grid_kernel, cfg, mesh, dtype),
            meas_unroll=meas_unroll)
    else:
        step = blocked_ekf.make_sharded_step(cfg, mesh, batch, M)

    @functools.partial(jax.jit, static_argnames=("ticks",),
                       donate_argnums=(0,) if donate else ())
    def run(state, wl: BigMapWorkload, Q, R, t0, ticks: int):
        dtype = state.mean_r.dtype

        def body(carry, t):
            st = carry
            # the EKF predicts from pose(t) to pose(t+1) before updating, so
            # this tick's measurements are taken at pose(t+1)
            pose = _true_pose(wl.cmd, t.astype(dtype) + 1.0, dtype)
            ids = wl.schedule[t % wl.schedule.shape[0]]       # (M,)
            lm = wl.landmarks[ids]                            # (M, 2)
            dx = lm[:, 0] - pose[1]
            dy = lm[:, 1] - pose[2]
            zs = cartesian2polar(dx, dy)
            zs = zs.at[:, 1].set(se2.normalize_angle(zs[:, 1] - pose[0]))
            zsb = jnp.broadcast_to(zs, (batch, M, 2))
            idsb = jnp.broadcast_to(ids, (batch, M))
            valid = jnp.ones((batch, M), bool)
            tw = jnp.broadcast_to(wl.cmd[t % wl.cmd.shape[0]], (batch, 3))
            st = step(st, tw, zsb, valid, idsb, Q, R)
            return st, None

        state, _ = jax.lax.scan(body, state, t0 + jnp.arange(ticks))
        return state

    return run


def make_unknown_runner(cfg: EKFConfig, mesh: Mesh, batch: int, M: int,
                        deferred: bool = True,
                        grid_kernel: bool | None = None, dtype=jnp.float32,
                        donate: bool = False, meas_unroll: bool = False):
    """Like :func:`make_runner` but with UNKNOWN association: every
    measurement is gated by the blockwise-distributed Mahalanobis first-hit
    scan instead of carrying its landmark id — the config-4 workload at the
    reference's association semantics. ``deferred=True`` uses the rank-2M
    one-grid-pass-per-tick step (gate decisions identical in exact
    arithmetic; association scores against the carried diagonal strip).
    ``grid_kernel`` as in :func:`make_runner`."""
    if deferred:
        step = blocked_ekf.make_sharded_deferred_unknown_step(
            cfg, mesh, batch, M,
            grid_kernel=_resolve_grid_kernel(grid_kernel, cfg, mesh, dtype),
            meas_unroll=meas_unroll)
    else:
        step = blocked_ekf.make_sharded_unknown_step(cfg, mesh, batch, M)

    @functools.partial(jax.jit, static_argnames=("ticks",),
                       donate_argnums=(0,) if donate else ())
    def run(state, wl: BigMapWorkload, Q, R, t0, ticks: int):
        dtype = state.mean_r.dtype

        def body(carry, t):
            st = carry
            pose = _true_pose(wl.cmd, t.astype(dtype) + 1.0, dtype)
            ids = wl.schedule[t % wl.schedule.shape[0]]
            lm = wl.landmarks[ids]
            dx = lm[:, 0] - pose[1]
            dy = lm[:, 1] - pose[2]
            zs = cartesian2polar(dx, dy)
            zs = zs.at[:, 1].set(se2.normalize_angle(zs[:, 1] - pose[0]))
            zsb = jnp.broadcast_to(zs, (batch, M, 2))
            valid = jnp.ones((batch, M), bool)
            tw = jnp.broadcast_to(wl.cmd[t % wl.cmd.shape[0]], (batch, 3))
            st = step(st, tw, zsb, valid, Q, R)
            return st, None

        state, _ = jax.lax.scan(body, state, t0 + jnp.arange(ticks))
        return state

    return run


def run_bigmap(N: int = 2048, T: int = 32, M: int = 8, batch: int = 1,
               mesh: Mesh | None = None, dtype=jnp.float32):
    """End-to-end config-4 run; returns (final BlockedState, workload)."""
    if mesh is None:
        mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = make_workload(N, T, M, jax.random.PRNGKey(0), dtype=dtype)
    runner = make_runner(cfg, mesh, batch, M, donate=True)
    state = blocked_ekf.init(cfg, batch, dtype=dtype)
    specs = blocked_ekf.state_sharding(mesh)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)
    Q = jnp.diag(jnp.array([1e-4, 1e-4, 1e-4], dtype))
    R = jnp.diag(jnp.array([1e-3, 1e-3], dtype))
    state = runner(state, wl, Q, R, jnp.int32(0), T)
    return state, wl
