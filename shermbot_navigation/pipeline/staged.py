"""Pipeline-parallel (PP) staging of the SLAM tick across a device mesh.

The reference runs its pipeline as THREE OS processes wired by topics —
tube_world -> landmarks -> slam (``unknown_data_assoc.launch:4-21``,
``landmarks.cpp:60-118`` as the middle stage) — so simulation/perception of
tick t overlaps the filter of tick t-1, at the cost of one tick of topic
latency. This module is the JAX analog (SURVEY.md section 2.5 PP
row): a 2-stage split over a ``'pp'`` mesh axis,

- stage 0 (producer): tube-world substeps + lidar perception (the
  tube_world + landmarks nodes);
- stage 1 (consumer): odometry + EKF (the slam node, which does its own
  odometry — ref slam.cpp:264-265);

with a double-buffered handoff: the consumer processes the packet the
producer emitted on the PREVIOUS tick while the producer works on the next
one — exactly the reference's one-cycle topic latency, reproduced rather
than hidden.

Mechanically each stage body sits inside ``lax.cond(stage == k, ...)``
under ``shard_map``: the predicate is device-dependent (``axis_index``),
so XLA emits a real HLO conditional and each device executes ONLY its
stage's branch at runtime — MPMD staging inside one SPMD program. The only
cross-stage communication is one ``ppermute`` of the observation packet
(a few hundred bytes) per tick, OUTSIDE the conditionals (collectives must
be unconditional or the non-participating device deadlocks them).

Whether this beats the fused single-program tick is an empirical question
benchmarked by ``benchmarks/bench_staged.py`` and recorded in
BENCH_NOTES.md — the fused program needs no collective and lets XLA
overlap stages at instruction granularity, while staging buys concurrency
at tick granularity but pays the permute + conditional overhead and leaves
each device idle during the other stage's critical path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models import ekf_slam as ekf
from ..ops import diff_drive as dd
from ..ops.landmark_detection import detect_landmarks
from ..sim import tube_world as tw
from .config import ScenarioConfig
from .driver import TickOutput, command_twist, init_pipeline
from .metrics import nees as nees_fn


class Packet(NamedTuple):
    """The producer->consumer handoff — the arrays replacing the reference's
    ``/joint_states`` + ``/real_sensor`` (or ``/fake_sensor``) topics."""

    joint_states: jnp.ndarray   # (2,) wheel angles
    positions: jnp.ndarray      # (C, 2) robot-frame landmark detections
    valid: jnp.ndarray          # (C,) detection mask
    true_pose: jnp.ndarray      # (3,) ground truth AT PRODUCTION TIME


def _empty_packet(scn: ScenarioConfig, dtype) -> Packet:
    C = scn.max_clusters if scn.use_lidar else len(scn.tubes)
    return Packet(joint_states=jnp.zeros((2,), dtype),
                  positions=jnp.zeros((C, 2), dtype),
                  valid=jnp.zeros((C,), bool),
                  true_pose=jnp.zeros((3,), dtype))


def _make_stages(scn: ScenarioConfig, params, Q, R):
    """The two stage bodies, shared by the staged program and its
    sequential oracle so equality tests compare identical math."""
    wcfg = scn.world_config()
    ecfg = scn.ekf_config()
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)

    def produce(world, key, cmd) -> tuple:
        """Sim substeps + perception -> (new world, packet)."""
        k_obs, *subkeys = jax.random.split(key, scn.sim_substeps + 1)

        def sim_body(wst, k):
            return tw.step_dynamics(wcfg, params, wst, cmd, scn.dt, k), None

        world, _ = jax.lax.scan(sim_body, world, jnp.stack(subkeys),
                                unroll=True)
        obs = tw.observe(wcfg, params, world, k_obs)
        if scn.use_lidar:
            det = detect_landmarks(
                obs.scan, params.scan_min, params.scan_max,
                max_clusters=scn.max_clusters,
                max_points=scn.max_cluster_points)
            positions, valid = det.positions, det.valid
        else:
            positions, valid = obs.fake_sensor, obs.fake_sensor_valid
        return world, Packet(joint_states=obs.joint_states,
                             positions=positions, valid=valid,
                             true_pose=obs.true_pose)

    def consume(odom, filt, pkt: Packet) -> tuple:
        """Odometry + EKF on a (one-tick-old) packet -> (odom, filt, out)."""
        twist = dd.wheels_to_twist(dparams, pkt.joint_states - odom.wheels)
        odom = dd.step(dparams, odom, pkt.joint_states)
        zs = ekf.cartesian2polar(pkt.positions[..., 0], pkt.positions[..., 1])
        if scn.known_association:
            ids = jnp.arange(pkt.positions.shape[0], dtype=jnp.int32)
            filt = ekf.known_association_step(
                ecfg, filt, twist, zs, pkt.valid, ids, Q, R)
        else:
            filt = ekf.step(ecfg, filt, twist, zs, pkt.valid, Q, R)
        slam_pose = filt.mean[:3]
        out = TickOutput(
            true_pose=pkt.true_pose,        # pose at packet production time
            odom_pose=odom.pose,
            slam_pose=slam_pose,
            n_seen=filt.n_seen,
            nees=nees_fn(slam_pose, pkt.true_pose, filt.cov[:3, :3]),
        )
        return odom, filt, out

    return produce, consume


def make_staged_rollout(scn: ScenarioConfig, mesh: Mesh, dtype=jnp.float32):
    """Build the jitted 2-device staged rollout: ``fn(key, T) -> TickOutput
    (T, ...)``. ``mesh`` must have a ``'pp'`` axis of size 2."""
    if mesh.shape["pp"] != 2:
        raise ValueError("PP staging is a 2-stage split: need pp=2")
    params = scn.world_params(dtype)
    Q, R = scn.noise_matrices(dtype)
    produce, consume = _make_stages(scn, params, Q, R)

    def shard_fn(world, odom, filt, keys, cmds):
        # local leaves carry a leading 'pp' axis of size 1 — strip it
        strip = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
        world, odom, filt = strip(world), strip(odom), strip(filt)
        key = keys[0]
        stage = jax.lax.axis_index("pp")
        pkt0 = _empty_packet(scn, dtype)
        zero_out = TickOutput(
            true_pose=jnp.zeros(3, dtype), odom_pose=jnp.zeros(3, dtype),
            slam_pose=jnp.zeros(3, dtype), n_seen=jnp.int32(0),
            nees=jnp.zeros((), dtype))

        def tick(carry, cmd):
            world, odom, filt, key, pkt = carry
            key, k_sub = jax.random.split(key)

            # stage 0 produces tick t's packet...
            world, new_pkt = jax.lax.cond(
                stage == 0,
                lambda a: produce(a[0], a[1], cmd),
                lambda a: (a[0], pkt0),
                (world, k_sub))
            # ...while stage 1 consumes tick t-1's packet (runs CONCURRENTLY
            # on the other device — independent HLO conditionals)
            odom, filt, out = jax.lax.cond(
                stage == 1,
                lambda a: consume(*a),
                lambda a: (a[0], a[1], zero_out),
                (odom, filt, pkt))
            # double-buffered handoff (the topic edge): producer -> consumer
            pkt = jax.lax.ppermute(new_pkt, "pp", [(0, 1)])
            return (world, odom, filt, key, pkt), out

        (_, _, filt, _, _), outs = jax.lax.scan(
            tick, (world, odom, filt, key, pkt0), cmds)
        # re-attach the 'pp' axis for the out spec
        return jax.tree_util.tree_map(lambda x: x[None], outs)

    state_specs = lambda t: jax.tree_util.tree_map(lambda _: P("pp"), t)
    proto = init_pipeline(scn, dtype)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(state_specs(proto.world), state_specs(proto.odom),
                  state_specs(proto.filt), P("pp"), P(None, None)),
        out_specs=jax.tree_util.tree_map(
            lambda _: P("pp", None), TickOutput(0, 0, 0, 0, 0)),
        check_vma=False)

    @functools.partial(jax.jit, static_argnames=("T",))
    def run(key, T: int):
        st = init_pipeline(scn, dtype)._replace(key=key)
        rep = lambda t: jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), t)
        keys = jnp.stack([key, jax.random.fold_in(key, 1)])
        cmds = command_twist(scn, jnp.arange(T), dtype)
        outs = fn(rep(st.world), rep(st.odom), rep(st.filt), keys, cmds)
        # stage 1 holds the real outputs (stage 0's rows are zeros)
        return jax.tree_util.tree_map(lambda x: x[1], outs)

    return run


def make_staged_reference(scn: ScenarioConfig, dtype=jnp.float32):
    """Sequential oracle with IDENTICAL 1-tick-latency semantics (same stage
    bodies, same packet delay, one device, no collectives) — pins the
    staged program's correctness in tests and isolates the cost of the
    latency semantics from the cost of distribution in the benchmark.
    Returns a reusable jitted ``fn(key, T) -> TickOutput``."""
    params = scn.world_params(dtype)
    Q, R = scn.noise_matrices(dtype)
    produce, consume = _make_stages(scn, params, Q, R)
    pkt0 = _empty_packet(scn, dtype)

    @functools.partial(jax.jit, static_argnames=("T",))
    def run(key, T: int):
        st = init_pipeline(scn, dtype)._replace(key=key)
        cmds = command_twist(scn, jnp.arange(T), dtype)

        def tick(carry, cmd):
            world, odom, filt, key, pkt = carry
            key, k_sub = jax.random.split(key)
            world, new_pkt = produce(world, k_sub, cmd)
            odom, filt, out = consume(odom, filt, pkt)
            return (world, odom, filt, key, new_pkt), out

        _, outs = jax.lax.scan(
            tick, (st.world, st.odom, st.filt, key, pkt0), cmds)
        return outs

    return run


def staged_reference(scn: ScenarioConfig, key, T: int, dtype=jnp.float32):
    """One-shot convenience wrapper over :func:`make_staged_reference`."""
    return make_staged_reference(scn, dtype)(key, T)
