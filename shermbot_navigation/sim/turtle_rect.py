"""Rectangle-trajectory bang-bang controller as a pure state machine.

JAX equivalent of the reference ``turtle_rect`` node
(``trect/src/turtle_rect.cpp``): the turtlesim FSM {Idle, bottomLine,
rightLine, topLine, leftLine, Rotate} with per-edge overshoot checks and
rotate-until-aligned transitions (ref :120-239) becomes a branchless
``controller_step(params, state, pose) -> (state, cmd_twist)`` driven by
``lax.switch``-free where-chains, so whole closed-loop rollouts jit and
batch.

The ``start`` service choreography (teleport + draw, ref :259-340) maps to
:func:`start`: it resets the FSM and returns the rectangle's corner
waypoints (the drawing is the caller's concern — we have no turtlesim pen).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..ops import se2

# FSM states (ref turtle_rect.cpp:55)
IDLE = 0
BOTTOM = 1
RIGHT = 2
TOP = 3
LEFT = 4
ROTATE = 5


class RectParams(NamedTuple):
    """Rectangle + speed limits (ref params max_xdot/max_wdot,
    turtle_rect.cpp:92-95; rectangle from the start service request)."""

    x: jnp.ndarray        # lower-left corner
    y: jnp.ndarray
    width: jnp.ndarray
    height: jnp.ndarray
    max_xdot: jnp.ndarray
    max_wdot: jnp.ndarray


class RectState(NamedTuple):
    fsm: jnp.ndarray       # () int32, one of the states above
    prev: jnp.ndarray      # () int32, state to resume after Rotate


def start(params: RectParams) -> Tuple[RectState, jnp.ndarray]:
    """Begin tracing the rectangle (ref start service, turtle_rect.cpp:259-340).
    Returns the initial FSM state and the (4, 2) corner waypoints (the
    reference draws these with the turtlesim pen)."""
    corners = jnp.stack([
        jnp.stack([params.x, params.y]),
        jnp.stack([params.x + params.width, params.y]),
        jnp.stack([params.x + params.width, params.y + params.height]),
        jnp.stack([params.x, params.y + params.height]),
    ])
    return RectState(fsm=jnp.int32(BOTTOM), prev=jnp.int32(BOTTOM)), corners


def _edge_targets(params: RectParams):
    """Per-edge (goal coordinate is x? , goal value, heading) tables."""
    x0, y0 = params.x, params.y
    x1, y1 = params.x + params.width, params.y + params.height
    # for state s (1..4): target position value, axis (0=x,1=y), heading
    goal_val = jnp.stack([jnp.zeros_like(x0), x1, y1, x0, y0])
    goal_axis = jnp.array([0, 0, 1, 0, 1])
    heading = jnp.stack([jnp.zeros_like(x0), jnp.zeros_like(x0),
                         jnp.full_like(x0, se2.PI / 2),
                         jnp.full_like(x0, se2.PI),
                         jnp.full_like(x0, -se2.PI / 2)])
    return goal_val, goal_axis, heading


def controller_step(params: RectParams, state: RectState, pose):
    """One control tick: pose ``[th, x, y]`` -> (new state, cmd ``[w, v]``).

    Bang-bang logic identical to the reference: drive the current edge at
    ``max_xdot`` until the goal coordinate is overshot (ref e.g. :141), then
    Rotate at ``max_wdot`` until the heading error magnitude < 0.01
    (ref :210), then resume the next edge; after the left edge, Idle.
    """
    pose = jnp.asarray(pose)
    th, x, y = pose[0], pose[1], pose[2]
    fsm = state.fsm

    goal_val, goal_axis, heading = _edge_targets(params)

    is_edge = (fsm >= BOTTOM) & (fsm <= LEFT)
    edge = jnp.clip(fsm, BOTTOM, LEFT)
    coord = jnp.where(goal_axis[edge] == 0, x, y)
    # direction of travel along the coordinate: +1 for bottom/right, -1 else
    sign = jnp.where((edge == BOTTOM) | (edge == RIGHT), 1.0, -1.0)
    reached = sign * (coord - goal_val[edge]) >= 0.0

    next_edge = jnp.where(edge == LEFT, IDLE, edge + 1)
    next_heading = heading[jnp.clip(next_edge, BOTTOM, LEFT)]
    herr = se2.normalize_angle(next_heading - th)

    # edge driving
    fsm_after_edge = jnp.where(reached,
                               jnp.where(next_edge == IDLE, IDLE, ROTATE),
                               edge)
    prev_after_edge = jnp.where(reached, next_edge, state.prev)

    # rotating toward the heading of state.prev
    rot_target = heading[jnp.clip(state.prev, BOTTOM, LEFT)]
    rot_err = se2.normalize_angle(rot_target - th)
    rot_done = jnp.abs(rot_err) < 0.01          # ref :210
    fsm_after_rot = jnp.where(rot_done, state.prev, ROTATE)

    new_fsm = jnp.where(fsm == ROTATE, fsm_after_rot,
                        jnp.where(is_edge, fsm_after_edge, IDLE))
    new_prev = jnp.where(fsm == ROTATE, state.prev,
                         jnp.where(is_edge, prev_after_edge, state.prev))

    v = jnp.where(is_edge & ~reached, params.max_xdot, 0.0)
    w = jnp.where(fsm == ROTATE,
                  jnp.sign(rot_err) * params.max_wdot, 0.0)
    cmd = jnp.stack([w, v, jnp.zeros_like(v)])
    return RectState(fsm=new_fsm.astype(jnp.int32),
                     prev=new_prev.astype(jnp.int32)), cmd
