"""Vectorized tube-world simulator: the ground-truth world as one pure
``step(params, state, cmd, key) -> (state, obs)`` function.

JAX re-design of the reference ``tube_world`` ROS node
(``nuturtlesim/src/tube_world.cpp``): the 50 Hz process + topic graph becomes
a jit/scan-able state transition. One call reproduces one reference tick
(``main_loop`` body, tube_world.cpp:473-544):

1. command twist + N(0, twist_noise) on (dth, dx)     (twist_callback, :177-189)
2. tube collision check -> tangential nudge           (check_collision, :371-389)
3. twist -> wheel velocities; commanded wheel angles += u*dt   (:516-525)
4. TRUE configuration update from slip-perturbed wheel angles  (:528-529)
5. observations from the updated true pose:
   - relative landmark markers with range gate + tube_var offset
     (set_rel_markers, :270-329)
   - simulated 360-ray lidar scan (simulate_lidar_scanner, :405-471)

The wheel-slip model is reproduced *exactly*, including its quirk: the true
wheel angle each tick is ``commanded_angle + u * eta`` with
``eta ~ N((slip_min+slip_max)/2, slip_max - mean)`` (tube_world.cpp:480-483,
528-529) — i.e. the noise enters as a *differenced* random offset on the
wheel angle, not as a multiplicative slip on the increment. See PARITY.md.

The lidar is computed as a full broadcast over (tubes x rays) instead of the
reference's per-tube +/-27deg rasterized cone — no scalar loops, one fused
XLA program. Two quirks of the reference lidar are gated behind
``reference_lidar_quirks`` (default False -> geometrically correct):
- the cone center formula ``atan2(2*yt - yr, 2*xt - xr)`` (tube_world.cpp:428)
  points away from the true robot->tube bearing when the robot is far from
  the origin, hiding tubes that should be visible;
- rays with exactly-zero world-frame dy produce NaN (``dy/fabs(dy)``,
  tube_world.cpp:444-449) and never hit;
- ray angles are integer world-frame degrees offset by the robot heading
  truncated toward zero (``int(rad2deg(th))``, tube_world.cpp:459).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import diff_drive as dd
from ..ops import se2


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static world configuration.

    ``compute_scan`` / ``compute_fake_sensor`` gate the observation channels:
    XLA cannot dead-code-eliminate unused ``lax.scan`` outputs, so a scenario
    that never consumes the lidar must not compute it (5x360 ray casts per
    SLAM tick otherwise burn for nothing).
    """

    num_rays: int = 360                 # scan_params.yaml: sample_num
    reference_lidar_quirks: bool = False
    collision_nudge: float = 1.0 / 50.0  # tube_world.cpp:387 "tangent/50"
    compute_scan: bool = True
    compute_fake_sensor: bool = True
    # "reference": true wheel angle = commanded + u*eta (tube_world.cpp:528
    #   quirk — the noise TELESCOPES, so odometry error stays bounded at
    #   ~u*eta regardless of trajectory length; PARITY.md P7).
    # "multiplicative": per-tick wheel increment scaled by eta — physical
    #   slip whose odometry error accumulates (for quality evaluation).
    slip_mode: str = "reference"


class WorldParams(NamedTuple):
    """Runtime world parameters (ref ``tube_world_params.yaml`` +
    ``scan_params.yaml`` + ``diff_params.yaml``)."""

    tube_locs: jnp.ndarray    # (K, 2) tube centers in the world frame
    tube_rad: jnp.ndarray     # 0.0381
    robot_rad: jnp.ndarray    # 0.08
    max_range: jnp.ndarray    # fake-sensor visibility gate, 1.0
    tube_var: jnp.ndarray     # constant offset added to relative markers, 0.001
    twist_noise: jnp.ndarray  # stddev on commanded (dth, dx), 0.0
    slip_min: jnp.ndarray     # 0.9
    slip_max: jnp.ndarray     # 1.0
    scan_min: jnp.ndarray     # 0.05
    scan_max: jnp.ndarray     # 1.0
    scan_noise: jnp.ndarray   # our extension (ref declares noise_level, never uses it)
    sensor_dropout: jnp.ndarray  # fault injection: P(drop a visible marker)
    scan_dropout: jnp.ndarray    # fault injection: P(drop a lidar ray)
    wheel_base: jnp.ndarray   # 0.16
    wheel_rad: jnp.ndarray    # 0.033


def default_params(tube_locs=None, dtype=jnp.float32, **overrides) -> WorldParams:
    """The reference's stock world (6 tubes, tube_world_params.yaml:1-16)."""
    if tube_locs is None:
        tube_locs = [[0.5, 0.5], [-0.5, -0.5], [1.0, 1.0],
                     [-1.0, -1.0], [-0.75, 0.75], [0.75, -0.75]]
    vals = dict(
        tube_locs=jnp.asarray(tube_locs, dtype),
        tube_rad=0.0381, robot_rad=0.08, max_range=1.0, tube_var=0.001,
        twist_noise=0.0, slip_min=0.9, slip_max=1.0,
        scan_min=0.05, scan_max=1.0, scan_noise=0.0,
        sensor_dropout=0.0, scan_dropout=0.0,
        wheel_base=0.16, wheel_rad=0.033,
    )
    vals.update(overrides)
    return WorldParams(**{
        k: (v if k == "tube_locs" else jnp.asarray(v, dtype))
        for k, v in vals.items()
    })


class WorldState(NamedTuple):
    """Simulator state.

    ``drive`` holds the TRUE robot configuration (slip-perturbed wheels);
    ``cmd_wheels`` is the commanded/published wheel angle pair — the
    reference's ``joint_msg.position`` (tube_world.cpp:522-525), which is
    what odometry consumers see.
    """

    drive: dd.DiffDriveState
    cmd_wheels: jnp.ndarray  # (2,)


class Observation(NamedTuple):
    """Everything the reference publishes per tick, as arrays."""

    joint_states: jnp.ndarray   # (2,) commanded wheel angles  -> /joint_states
    fake_sensor: jnp.ndarray    # (K, 2) tube positions in robot frame -> /fake_sensor
    fake_sensor_valid: jnp.ndarray  # (K,) bool: within max_range
    scan: jnp.ndarray           # (num_rays,) ranges -> /scan
    true_pose: jnp.ndarray      # (3,) [th, x, y] ground truth -> map->turtle TF


def init_state(params: WorldParams, dtype=jnp.float32) -> WorldState:
    return WorldState(
        drive=dd.init_state(dtype=dtype),
        cmd_wheels=jnp.zeros((2,), dtype),
    )


def _resolve_collisions(config: WorldConfig, params: WorldParams, drive):
    """Slide along the tangent on tube contact (ref check_collision,
    tube_world.cpp:371-389). Vectorized over tubes: contributions from all
    colliding tubes sum (the reference applies them sequentially; identical
    unless the robot touches two tubes in one tick — impossible with the
    stock layouts)."""
    pose = drive.pose
    delta = params.tube_locs - pose[1:3][None, :]       # (K, 2) robot->tube
    dist = jnp.linalg.norm(delta, axis=-1)
    dist = jnp.maximum(dist, 1e-9)
    hit = dist <= (params.tube_rad + params.robot_rad)
    move = jnp.stack([delta[:, 1], -delta[:, 0]], axis=-1) / dist[:, None]
    nudge = jnp.sum(
        jnp.where(hit[:, None], move * config.collision_nudge, 0.0), axis=0)
    return dd.nudge(drive, nudge[0], nudge[1])


def _fake_sensor(params: WorldParams, pose):
    """Relative landmark markers (ref set_rel_markers, tube_world.cpp:270-329):
    tube positions in the robot frame plus the constant ``tube_var`` offset,
    gated by euclidean distance <= max_range."""
    T_wt = se2.from_pose(pose)
    rel = se2.apply(se2.inv(T_wt), params.tube_locs)     # (K, 2)
    rel = rel + params.tube_var                           # constant offset, :311-312
    dist = jnp.linalg.norm(params.tube_locs - pose[1:3][None, :], axis=-1)
    return rel, dist <= params.max_range


def _lidar(config: WorldConfig, params: WorldParams, pose, key):
    """Simulated 360-ray scan (ref simulate_lidar_scanner,
    tube_world.cpp:405-471) as one (rays x tubes) broadcast.

    Ray-circle intersection in tube-centered coordinates: with the robot at
    p1 and unit ray direction u, solve ``|p1 + t u| = tube_rad`` for the
    smallest positive t. Misses and backward hits return scan_max + 1
    (the reference's out-of-range sentinel, :410/:462-468).
    """
    th, x, y = pose[0], pose[1], pose[2]
    n = config.num_rays
    bins = jnp.arange(n, dtype=pose.dtype)

    if config.reference_lidar_quirks:
        # integer world-frame ray angles offset by trunc(deg(th)) (:459-460)
        ray_deg = bins + jnp.trunc(se2.rad2deg(th))
        ang = se2.deg2rad(ray_deg)
    else:
        ang = th + 2.0 * jnp.pi * bins / n

    ux, uy = jnp.cos(ang), jnp.sin(ang)                 # (n,)

    # robot position relative to each tube: (K, 2)
    p1 = pose[1:3][None, :] - params.tube_locs
    # quadratic: t^2 + 2 t (p1.u) + |p1|^2 - r^2 = 0, broadcast (n, K)
    b = p1[None, :, 0] * ux[:, None] + p1[None, :, 1] * uy[:, None]
    c = jnp.sum(p1 * p1, axis=-1)[None, :] - params.tube_rad ** 2
    disc = b * b - c
    safe_sqrt = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - safe_sqrt
    t2 = -b + safe_sqrt

    if config.reference_lidar_quirks:
        # The reference intersects the infinite LINE, not the forward ray
        # (:444-453): both intersection points' absolute distances from the
        # robot compete, so rays pointing AWAY from a tube still register
        # hits. Near-tangent band |r^2 dr^2 - det^2| < 1e-5 (dr = scan_max)
        # takes the perpendicular-foot distance |b| instead (:439-442).
        eps = 1e-5 / (params.scan_max * params.scan_max)
        tangent = jnp.abs(disc) < eps
        t = jnp.minimum(jnp.abs(t1), jnp.abs(t2))
        t = jnp.where(tangent, jnp.abs(b), t)
        miss = disc <= -eps
        # cone gate with the reference's (buggy) center formula (:428):
        # tube_angle = round(deg(atan2(2*yt - yr, 2*xt - xr))), window [-27, 26]
        t_ang = jnp.arctan2(2.0 * params.tube_locs[:, 1] - y,
                            2.0 * params.tube_locs[:, 0] - x)
        t_deg = se2.rad2deg(t_ang)
        # C round(): half away from zero
        t_deg = jnp.sign(t_deg) * jnp.floor(jnp.abs(t_deg) + 0.5)
        ray_deg_grid = (bins + jnp.trunc(se2.rad2deg(th)))[:, None]
        ddeg = jnp.mod(ray_deg_grid - t_deg[None, :] + 180.0, 360.0) - 180.0
        in_cone = (ddeg >= -27.0) & (ddeg <= 26.0)
        # dy == 0 NaN quirk (:444-449): sin(deg2rad(i)) is exactly zero only
        # at integer degree i == 0, i.e. ray_deg = 0 mod 360; such rays NaN
        # out in the two-point branch but still hit in the tangent branch.
        nan_ray = (jnp.mod(ray_deg_grid, 360.0) == 0.0)
        miss = miss | ~in_cone | (nan_ray & ~tangent)
    else:
        t = jnp.where(t1 > 0.0, t1, t2)                 # nearest forward hit
        miss = (disc < 0.0) | (t <= 0.0)

    t = jnp.where(miss, params.scan_max + 1.0, t)
    ranges = jnp.min(t, axis=1)                          # z-buffer over tubes

    noisy = ranges + params.scan_noise * jax.random.normal(
        key, ranges.shape, dtype=ranges.dtype)
    ranges = jnp.where(ranges > params.scan_max, ranges, noisy)
    return ranges


def step_dynamics(config: WorldConfig, params: WorldParams,
                  state: WorldState, cmd_twist, dt, key) -> WorldState:
    """Advance the world one tick WITHOUT computing observations —
    the hot path when only the last substep's topics are consumed
    (ref: 50 Hz sim feeding 10 Hz consumers means 4/5 of published
    observations are never read; we skip producing them entirely)."""
    kt, ks = jax.random.split(key, 2)
    dtype = state.cmd_wheels.dtype

    # 1. twist noise (twist_callback, :177-189): N(0, twist_noise) on dth, dx
    noise = params.twist_noise * jax.random.normal(kt, (2,), dtype)
    tw = jnp.asarray(cmd_twist, dtype)
    tw = tw.at[0].add(noise[0]).at[1].add(noise[1])

    # 2. collision resolve against the pre-update true pose (:513)
    drive = _resolve_collisions(config, params, state.drive)

    # 3. wheel velocities and commanded wheel angles (:516-525)
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)
    u = dd.twist_to_wheels(dparams, tw)
    cmd_wheels = state.cmd_wheels + u * dt

    # 4. true update from slip-perturbed wheel angles (:480-483, :528-529)
    slip_mean = (params.slip_min + params.slip_max) / 2.0
    slip_var = params.slip_max - slip_mean
    eta = slip_mean + slip_var * jax.random.normal(ks, (2,), dtype)
    if config.slip_mode == "multiplicative":
        # physical slip: this tick's true increment is scaled by eta
        drive = dd.step(dparams, drive, drive.wheels + u * dt * eta)
    else:
        drive = dd.step(dparams, drive, cmd_wheels + u * eta)

    return WorldState(drive=drive, cmd_wheels=cmd_wheels)


def observe(config: WorldConfig, params: WorldParams, state: WorldState,
            key) -> Observation:
    """Produce the tick's observations from the current true pose
    (set_rel_markers + simulate_lidar_scanner). Channels gated by
    ``config.compute_*`` return zeros when off."""
    dtype = state.cmd_wheels.dtype
    pose = state.drive.pose
    K = params.tube_locs.shape[0]
    k_lidar, k_drop_m, k_drop_s = jax.random.split(key, 3)

    if config.compute_fake_sensor:
        rel, rel_valid = _fake_sensor(params, pose)
        # fault injection: random marker dropout (our extension; the ref has
        # only algorithmic robustness, SURVEY.md section 5)
        keep = jax.random.uniform(k_drop_m, (K,)) >= params.sensor_dropout
        rel_valid = rel_valid & keep
    else:
        rel = jnp.zeros((K, 2), dtype)
        rel_valid = jnp.zeros((K,), bool)

    if config.compute_scan:
        scan = _lidar(config, params, pose, k_lidar)
        keep = (jax.random.uniform(k_drop_s, (config.num_rays,))
                >= params.scan_dropout)
        scan = jnp.where(keep, scan, params.scan_max + 1.0)
    else:
        scan = jnp.zeros((config.num_rays,), dtype)

    return Observation(
        joint_states=state.cmd_wheels,
        fake_sensor=rel,
        fake_sensor_valid=rel_valid,
        scan=scan,
        true_pose=pose,
    )


def step(config: WorldConfig, params: WorldParams, state: WorldState,
         cmd_twist, dt, key) -> Tuple[WorldState, Observation]:
    """One simulator tick with observations. ``cmd_twist`` is
    ``[dth, dx, dy]`` (the /cmd_vel equivalent; dy ignored by the diff
    drive), ``dt`` the tick period (1/50 s at the reference rate,
    tube_world.cpp:67)."""
    kd, ko = jax.random.split(key, 2)
    new_state = step_dynamics(config, params, state, cmd_twist, dt, kd)
    return new_state, observe(config, params, new_state, ko)


def rollout(config: WorldConfig, params: WorldParams, state: WorldState,
            cmd_twists, dt, key):
    """Scan :func:`step` over a (T, 3) command sequence -> (final state,
    stacked Observations). The whole trajectory compiles to one XLA loop."""
    T = cmd_twists.shape[0]
    keys = jax.random.split(key, T)

    def body(st, inp):
        cmd, k = inp
        st, obs = step(config, params, st, cmd, dt, k)
        return st, obs

    return jax.lax.scan(body, state, (jnp.asarray(cmd_twists), keys))
