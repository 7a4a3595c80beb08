"""Standalone odometry node equivalent.

JAX equivalent of the reference ``odometer`` node
(``rigid2d/src/odometer.cpp``): joint states -> twist -> configuration
update -> odometry message, plus the ``set_pose`` teleport service
(odometer.cpp:169-187, ``rigid2d/srv/set_pose.srv``). In-process the
pipeline driver folds this logic in (like the reference's slam node does,
slam.cpp:264-265); this module is the freestanding 100 Hz-node equivalent
for consumers that only want odometry.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..ops import diff_drive as dd


class OdometryOutput(NamedTuple):
    """The nav_msgs/Odometry payload (odometer.cpp:145-158): pose + the
    body twist that produced this update (reference packs [dx, dy, dth]
    into twist.linear x/y/z)."""

    pose: jnp.ndarray   # (3,) [th, x, y]
    twist: jnp.ndarray  # (3,) [dth, dx, dy] per update interval


def update(params: dd.DiffDriveParams, state: dd.DiffDriveState,
           joint_states) -> Tuple[dd.DiffDriveState, OdometryOutput]:
    """One joint-state callback (odometer.cpp:104-161)."""
    joint_states = jnp.asarray(joint_states)
    tw = dd.wheels_to_twist(params, joint_states - state.wheels)
    new = dd.step(params, state, joint_states)
    return new, OdometryOutput(pose=new.pose, twist=tw)


def set_pose(state: dd.DiffDriveState, th, x, y) -> dd.DiffDriveState:
    """The set_pose service: rebuild the odometry at the requested pose
    with zeroed wheels (odometer.cpp:169-187)."""
    return dd.teleport(state, th, x, y)
