"""The in-process pipeline driver: sim -> (perception) -> odometry -> EKF.

Replaces the reference's launch graphs (SURVEY.md D4) — ``tube_world.launch``,
``landmark_detect.launch``, ``unknown_data_assoc.launch`` — with one jitted
``slam_tick`` and a ``lax.scan`` rollout. The ROS topic graph becomes arrays
passed between fused stages; the 50 Hz sim / 10 Hz SLAM rate split becomes
``sim_substeps`` inner steps per tick (ref tube_world.cpp:67, slam.cpp:67).

Wiring per tick (mirrors ``unknown_data_assoc.launch``: odometer is folded
into the slam node, slam.cpp:264-265):

1. run ``sim_substeps`` tube-world steps holding the command twist;
2. odometry: wheel deltas from the *commanded* joint states -> twist ->
   DiffDrive update (ref slam.cpp:231-265);
3. measurements: either the fake sensor markers (configs 1-2; ref
   ``/fake_sensor``) or the full lidar -> clustering -> circle-fit stage
   (config 3; ref ``/scan`` -> landmarks node -> ``/real_sensor``);
4. EKF predict + sequential measurement updates (ref slam.cpp:269-318).

Everything in one ``jax.jit``; batch over many worlds with ``vmap`` for
throughput benchmarking (the DP axis of SURVEY.md section 2.5).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import ekf_slam as ekf
from ..ops import diff_drive as dd
from ..ops import se2
from ..ops.landmark_detection import detect_landmarks
from ..sim import tube_world as tw
from .config import ScenarioConfig


class PipelineState(NamedTuple):
    world: tw.WorldState
    odom: dd.DiffDriveState
    filt: ekf.EKFState
    key: jnp.ndarray


class TickOutput(NamedTuple):
    true_pose: jnp.ndarray   # (3,) [th, x, y] ground truth
    odom_pose: jnp.ndarray   # (3,) odometry-only estimate
    slam_pose: jnp.ndarray   # (3,) EKF estimate
    n_seen: jnp.ndarray      # () landmarks initialized so far
    nees: jnp.ndarray        # () robot-block NEES


def init_pipeline(scn: ScenarioConfig, dtype=jnp.float32,
                  seed=None) -> PipelineState:
    params = scn.world_params(dtype)
    return PipelineState(
        world=tw.init_state(params, dtype),
        odom=dd.init_state(dtype=dtype),
        filt=ekf.init(scn.ekf_config(), jnp.zeros(3, dtype), dtype=dtype),
        key=jax.random.PRNGKey(scn.seed if seed is None else seed),
    )


def command_twist(scn: ScenarioConfig, t, dtype=jnp.float32):
    """Teleop replacement: the command twist at SLAM tick ``t``.

    ``("circle", w, v)``: constant arc (the canonical loop drive the
    reference's gifs show). Twists are [dth, dx, dy] velocities (rad/s, m/s).
    """
    kind = scn.command[0]
    if kind == "circle":
        w, v = scn.command[1], scn.command[2]
        z = jnp.zeros_like(jnp.asarray(t, dtype))
        return jnp.stack([jnp.full_like(z, w), jnp.full_like(z, v), z],
                         axis=-1)
    raise ValueError(f"unknown command kind {kind!r}")


class SenseState(NamedTuple):
    """Everything except the filter: sim world, odometry, PRNG key."""

    world: tw.WorldState
    odom: dd.DiffDriveState
    key: jnp.ndarray


def sense_tick(scn: ScenarioConfig, params: tw.WorldParams,
               state: SenseState, cmd):
    """The non-filter part of one SLAM tick: ``sim_substeps`` 50 Hz sim
    steps + odometry + the measurement stage (fake sensor or the full
    lidar -> cluster -> circle-fit chain). Pure; jit/vmap/scan-friendly.
    Returns ``(new SenseState, twist, zs (M, 2), valid (M,), obs)``."""
    wcfg = scn.world_config()

    # --- simulator substeps (tube_world at 50 Hz). Only the LAST substep's
    # observations are consumed at 10 Hz (latest-topic sampling), so the
    # inner scan advances dynamics only and observations are produced once.
    key, k_obs, *subkeys = jax.random.split(state.key, scn.sim_substeps + 2)

    def sim_body(wst, k):
        return tw.step_dynamics(wcfg, params, wst, cmd, scn.dt, k), None

    # unroll: a handful of iterations of straight-line code beats a nested
    # device loop inside the outer tick scan
    world, _ = jax.lax.scan(sim_body, state.world, jnp.stack(subkeys),
                            unroll=True)
    obs = tw.observe(wcfg, params, world, k_obs)

    # --- odometry from commanded joint states (ref slam.cpp:264-265)
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)
    twist = dd.wheels_to_twist(dparams, obs.joint_states - state.odom.wheels)
    odom = dd.step(dparams, state.odom, obs.joint_states)

    # --- measurements
    if scn.use_lidar:
        det = detect_landmarks(
            obs.scan, params.scan_min, params.scan_max,
            max_clusters=scn.max_clusters,
            max_points=scn.max_cluster_points)
        positions, valid = det.positions, det.valid
    else:
        positions, valid = obs.fake_sensor, obs.fake_sensor_valid

    zs = ekf.cartesian2polar(positions[..., 0], positions[..., 1])
    return SenseState(world=world, odom=odom, key=key), twist, zs, valid, obs


def slam_tick(scn: ScenarioConfig, params: tw.WorldParams, Q, R,
              state: PipelineState, cmd) -> tuple:
    """One 10 Hz SLAM tick (= ``sim_substeps`` 50 Hz sim ticks + odometry +
    EKF). Pure; jit/vmap/scan-friendly."""
    ecfg = scn.ekf_config()

    sense, twist, zs, valid, obs = sense_tick(
        scn, params, SenseState(state.world, state.odom, state.key), cmd)
    world, odom, key = sense.world, sense.odom, sense.key

    # --- EKF tick
    if scn.known_association:
        ids = jnp.arange(zs.shape[0], dtype=jnp.int32)
        filt = ekf.known_association_step(
            ecfg, state.filt, twist, zs, valid, ids, Q, R)
    else:
        filt = ekf.step(ecfg, state.filt, twist, zs, valid, Q, R)

    # --- outputs
    slam_pose = filt.mean[:3]
    from .metrics import nees as nees_fn
    out = TickOutput(
        true_pose=obs.true_pose,
        odom_pose=odom.pose,
        slam_pose=slam_pose,
        n_seen=filt.n_seen,
        nees=nees_fn(slam_pose, obs.true_pose, filt.cov[:3, :3]),
    )
    return PipelineState(world=world, odom=odom, filt=filt, key=key), out


def rollout(scn: ScenarioConfig, params: tw.WorldParams, Q, R,
            state: PipelineState, steps=None):
    """Scan ``slam_tick`` over the scenario's command schedule. Returns
    (final PipelineState, stacked TickOutput)."""
    T = scn.steps if steps is None else steps
    dtype = state.odom.pose.dtype
    cmds = command_twist(scn, jnp.arange(T), dtype)

    def body(st, cmd):
        return slam_tick(scn, params, Q, R, st, cmd)

    return jax.lax.scan(body, state, cmds)


@functools.partial(jax.jit, static_argnums=(0, 2))
def run_scenario(scn: ScenarioConfig, key, dtype=jnp.float32):
    """End-to-end jitted scenario run (single sequence). Returns stacked
    TickOutputs; metrics computed by the caller."""
    params = scn.world_params(dtype)
    Q, R = scn.noise_matrices(dtype)
    state = init_pipeline(scn, dtype)._replace(key=key)
    _, outs = rollout(scn, params, Q, R, state)
    return outs


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def run_scenario_batch(scn: ScenarioConfig, keys, steps=None,
                       dtype=jnp.float32):
    """DP-batched scenario run: vmap over ``keys`` -> (B, T, ...) outputs.
    This is the throughput benchmark entry: B independent worlds advance in
    lockstep, turning the tiny per-tick linear algebra into batched matmuls
    on the device."""
    params = scn.world_params(dtype)
    Q, R = scn.noise_matrices(dtype)

    def one(key):
        state = init_pipeline(scn, dtype)._replace(key=key)
        _, outs = rollout(scn, params, Q, R, state, steps=steps)
        return outs

    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def run_scenario_batch_lanes(scn: ScenarioConfig, keys, steps=None,
                             dtype=jnp.float32):
    """DP-batched scenario run on the BATCH-ON-LANES engine
    (``models.ekf_batch``): the sim/perception stage stays vmapped
    (its arrays are already well-shaped), but the filter runs the
    explicitly batch-trailing dense EKF — covariances ``(D, D, B)``
    instead of vmap's ``(B, D, D)``, so the batch dim is the minor,
    contiguous axis instead of 27-wide trailing dims (BENCH_NOTES
    pathology 9 applied to the batch axis).
    Semantics identical to :func:`run_scenario_batch`; returns the same
    (B, T, ...) ``TickOutput``."""
    from ..models import ekf_batch
    from .metrics import nees as nees_fn

    params = scn.world_params(dtype)
    Q, R = scn.noise_matrices(dtype)
    ecfg = scn.ekf_config()
    T = scn.steps if steps is None else steps
    B = keys.shape[0]
    cmds = command_twist(scn, jnp.arange(T), dtype)

    def init_sense(key):
        st = init_pipeline(scn, dtype)._replace(key=key)
        return SenseState(st.world, st.odom, st.key)

    sense0 = jax.vmap(init_sense)(keys)
    filt0 = ekf_batch.init(ecfg, B, dtype=dtype)

    def body(carry, cmd):
        sense, filt = carry
        sense, twist, zs, valid, obs = jax.vmap(
            lambda s: sense_tick(scn, params, s, cmd))(sense)
        if scn.known_association:
            ids = jnp.broadcast_to(
                jnp.arange(zs.shape[1], dtype=jnp.int32)[None, :],
                zs.shape[:2])
            filt = ekf_batch.known_association_step(
                ecfg, filt, twist, zs, valid, ids, Q, R)
        else:
            filt = ekf_batch.step(ecfg, filt, twist, zs, valid, Q, R)
        slam_pose = filt.mean[:3].T                         # (B, 3)
        cov_rr = jnp.transpose(filt.cov[:3, :3], (2, 0, 1))  # (B, 3, 3)
        out = TickOutput(
            true_pose=obs.true_pose,
            odom_pose=sense.odom.pose,
            slam_pose=slam_pose,
            n_seen=filt.n_seen,
            nees=jax.vmap(nees_fn)(slam_pose, obs.true_pose, cov_rr),
        )
        return (sense, filt), out

    _, outs = jax.lax.scan(body, (sense0, filt0), cmds)
    # scan stacks (T, B, ...); match run_scenario_batch's (B, T, ...)
    return jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), outs)
