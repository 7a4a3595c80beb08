"""Differential-drive kinematics as pure JAX ops.

JAX re-design of the reference ``DiffDrive`` class
(``rigid2d/include/rigid2d/diff_drive.hpp`` + ``rigid2d/src/diff_drive.cpp``).
Instead of a mutable class, the robot configuration is an immutable pytree
(:class:`DiffDriveState`) and every op is a pure function, so whole rollouts
compile to a single ``lax.scan`` and batch over leading axes with ``vmap``.

Conventions (match the reference):
- wheels: ``[left, right]``
- twists: ``[dth, dx, dy]`` with ``dy == 0`` for diff drive
- pose:   ``[th, x, y]`` (EKF state ordering, ref ``slam_library.cpp:50-56``)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import se2


class DiffDriveParams(NamedTuple):
    """Static geometry (ref ``diff_params.yaml``: wheel_base 0.16, wheel_radius 0.033)."""

    wheel_base: jnp.ndarray  # distance between wheels [m]
    wheel_rad: jnp.ndarray   # wheel radius [m]


class DiffDriveState(NamedTuple):
    """Robot configuration: pose ``[th, x, y]`` + wheel angles ``[thL, thR]``.

    Mirrors the private members of the reference ``DiffDrive``
    (``diff_drive.hpp:22-29``) as arrays so it vmaps/scans.
    """

    pose: jnp.ndarray    # [..., 3] = [th, x, y]
    wheels: jnp.ndarray  # [..., 2] = [thL, thR]


def init_state(th=0.0, x=0.0, y=0.0, thl=0.0, thr=0.0, dtype=jnp.float32):
    """Fresh configuration (ref ctor ``diff_drive.cpp:21-30``)."""
    return DiffDriveState(
        pose=jnp.array([th, x, y], dtype=dtype),
        wheels=jnp.array([thl, thr], dtype=dtype),
    )


def twist_to_wheels(params: DiffDriveParams, twist):
    """Body twist -> wheel velocities ``[uL, uR]``
    (ref ``convertTwist``, diff_drive.cpp:66-78)::

        uL = -(d/r)*dth + dx/r,   uR = +(d/r)*dth + dx/r,   d = base/2

    Note the reference ignores ``twist.dy`` entirely (non-holonomic).
    """
    twist = jnp.asarray(twist)
    d = params.wheel_base / 2.0
    r = params.wheel_rad
    omg, vbx = twist[..., 0], twist[..., 1]
    ul = -(d / r) * omg + vbx / r
    ur = (d / r) * omg + vbx / r
    return jnp.stack([ul, ur], axis=-1)


def wheels_to_twist(params: DiffDriveParams, dwheels):
    """Wheel-angle increments ``[dL, dR]`` -> body twist
    (ref ``getTwist``, diff_drive.cpp:80-110)::

        dth = (r/base)*(dR - dL),  dx = (r/2)*(dL + dR),  dy = 0
    """
    dwheels = jnp.asarray(dwheels)
    dl, dr = dwheels[..., 0], dwheels[..., 1]
    r = params.wheel_rad
    dth = (r / params.wheel_base) * (dr - dl)
    dx = (r / 2.0) * (dl + dr)
    return jnp.stack([dth, dx, jnp.zeros_like(dx)], axis=-1)


def step(params: DiffDriveParams, state: DiffDriveState, wheels_new) -> DiffDriveState:
    """Advance the configuration to new absolute wheel angles
    (ref ``DiffDrive::operator()``, diff_drive.cpp:111-146).

    Pipeline (identical to the reference): wheel deltas -> body twist ->
    ``integrate_twist`` -> displacement in the body frame -> rotate into the
    world frame with the adjoint of a pure rotation by the current heading ->
    accumulate.

    PARITY NOTE: the reference recovers the heading increment with
    ``atan(sin/cos)`` (diff_drive.cpp:131) which equals the twist's ``dth``
    whenever ``|dth| < pi/2`` (always true for per-tick wheel increments);
    we use ``dth`` directly. See PARITY.md.
    """
    wheels_new = jnp.asarray(wheels_new)
    tw = wheels_to_twist(params, wheels_new - state.wheels)
    Tbb = se2.integrate_twist(tw)
    # displacement in the body frame as a "twist" [dth, dx, dy]
    dqb = jnp.stack([tw[..., 0], Tbb[..., 2], Tbb[..., 3]], axis=-1)
    # rotate into the world frame: adjoint of pure rotation by current heading
    adj = se2.from_rotation(state.pose[..., 0])
    dq = se2.adjoint_twist(adj, dqb)
    return DiffDriveState(pose=state.pose + dq, wheels=wheels_new)


def nudge(state: DiffDriveState, dx, dy) -> DiffDriveState:
    """Shift the (x, y) location without touching heading or wheels
    (ref ``changeConfig``, diff_drive.cpp:154-159; used for collision slip).
    """
    delta = jnp.stack([jnp.zeros_like(jnp.asarray(dx)), jnp.asarray(dx), jnp.asarray(dy)], axis=-1)
    return state._replace(pose=state.pose + delta)


def teleport(state: DiffDriveState, th, x, y) -> DiffDriveState:
    """Reset the pose, zeroing the wheel angles (ref ``set_pose`` service
    semantics: a fresh ``DiffDrive`` at the requested pose,
    odometer.cpp:169-187).
    """
    pose = jnp.stack([jnp.asarray(th), jnp.asarray(x), jnp.asarray(y)], axis=-1)
    return DiffDriveState(pose=pose.astype(state.pose.dtype), wheels=jnp.zeros_like(state.wheels))
