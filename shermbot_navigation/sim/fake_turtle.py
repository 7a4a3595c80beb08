"""Minimal kinematic robot simulator — no noise, no world, no lidar.

JAX equivalent of the reference ``fake_turtle`` node
(``rigid2d/src/fake_turtle.cpp``): commanded twist -> wheel velocities ->
integrated wheel angles -> joint states, with the configuration updated from
the same (noiseless) wheel angles. The 1 Hz loop (ref fake_turtle.cpp:52)
becomes an explicit ``dt``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..ops import diff_drive as dd


class FakeTurtleState(NamedTuple):
    drive: dd.DiffDriveState


def init_state(dtype=jnp.float32) -> FakeTurtleState:
    return FakeTurtleState(drive=dd.init_state(dtype=dtype))


def step(params: dd.DiffDriveParams, state: FakeTurtleState, cmd_twist, dt
         ) -> Tuple[FakeTurtleState, jnp.ndarray]:
    """One tick: returns (state, joint_states) — the published wheel angles
    (ref fake_turtle.cpp:95-128)."""
    u = dd.twist_to_wheels(params, jnp.asarray(cmd_twist))
    wheels = state.drive.wheels + u * dt
    return FakeTurtleState(drive=dd.step(params, state.drive, wheels)), wheels
