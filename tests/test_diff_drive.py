"""Diff-drive kinematics tests (ports rigid2d/tests/diff_drive_tests.cpp
plus property checks)."""

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.ops import diff_drive as dd
from shermbot_navigation.ops import se2

PI = se2.PI


def params64(base=2.0, rad=1.0):
    return dd.DiffDriveParams(jnp.float64(base), jnp.float64(rad))


class TestReferenceCases:
    def test_straight_line_update(self):
        # ref diff_drive_tests.cpp:6-22: both wheels to pi/2 -> x = pi/2
        p = params64()
        s = dd.init_state(dtype=jnp.float64)
        s = dd.step(p, s, jnp.array([PI / 2, PI / 2], jnp.float64))
        np.testing.assert_allclose(s.pose, [0.0, PI / 2, 0.0], atol=1e-12)

    def test_wheel_velocities_pure_rotation(self):
        # ref diff_drive_tests.cpp:41-58
        p = params64()
        u = dd.twist_to_wheels(p, jnp.array([PI / 2, 0.0, 0.0], jnp.float64))
        np.testing.assert_allclose(u, [-PI / 2, PI / 2], atol=1e-12)

    def test_wheel_velocities_mixed(self):
        # ref diff_drive_tests.cpp:79-96
        p = params64()
        u = dd.twist_to_wheels(p, jnp.array([PI / 3, 1.5, 1.5], jnp.float64))
        np.testing.assert_allclose(u, [-PI / 3 + 1.5, PI / 3 + 1.5], atol=1e-12)


class TestProperties:
    def test_twist_wheels_roundtrip(self):
        p = dd.DiffDriveParams(jnp.float64(0.16), jnp.float64(0.033))
        rng = np.random.default_rng(0)
        for _ in range(10):
            tw = jnp.array([rng.uniform(-2, 2), rng.uniform(-1, 1), 0.0], jnp.float64)
            u = dd.twist_to_wheels(p, tw)
            back = dd.wheels_to_twist(p, u)  # unit time: velocities = increments
            np.testing.assert_allclose(back, tw, atol=1e-12)

    def test_arc_motion_closed_form(self):
        # pure rotation in place: equal and opposite wheel increments
        p = params64()
        s = dd.init_state(dtype=jnp.float64)
        s = dd.step(p, s, jnp.array([-PI / 4, PI / 4], jnp.float64))
        np.testing.assert_allclose(s.pose, [PI / 4, 0.0, 0.0], atol=1e-12)

    def test_quarter_circle_arc(self):
        # drive a quarter circle of radius 1 with base=2, rad=1:
        # body twist [dth, dx] = [pi/2, pi/2] -> ends at (1, 1) facing +y
        p = params64()
        tw = jnp.array([PI / 2, PI / 2, 0.0], jnp.float64)
        u = dd.twist_to_wheels(p, tw)
        s = dd.init_state(dtype=jnp.float64)
        s = dd.step(p, s, u)
        np.testing.assert_allclose(s.pose, [PI / 2, 1.0, 1.0], atol=1e-12)

    def test_many_small_steps_match_one_arc(self):
        # integrating N small steps along a constant twist == one big step
        p = dd.DiffDriveParams(jnp.float64(0.16), jnp.float64(0.033))
        tw = jnp.array([0.8, 0.3, 0.0], jnp.float64)
        u = dd.twist_to_wheels(p, tw)

        big = dd.step(p, dd.init_state(dtype=jnp.float64), u)

        n = 1000
        def body(s, _):
            s2 = dd.step(p, s, s.wheels + u / n)
            return s2, None
        small, _ = jax.lax.scan(body, dd.init_state(dtype=jnp.float64), None, length=n)
        np.testing.assert_allclose(small.pose, big.pose, atol=1e-9)

    def test_nudge_and_teleport(self):
        s = dd.init_state(0.5, 1.0, 2.0, 0.1, 0.2, dtype=jnp.float64)
        s2 = dd.nudge(s, 0.01, -0.02)
        np.testing.assert_allclose(s2.pose, [0.5, 1.01, 1.98], atol=1e-12)
        np.testing.assert_allclose(s2.wheels, s.wheels)
        s3 = dd.teleport(s, -1.0, 3.0, 4.0)
        np.testing.assert_allclose(s3.pose, [-1.0, 3.0, 4.0], atol=1e-12)
        np.testing.assert_allclose(s3.wheels, [0.0, 0.0])

    def test_vmap_batch(self):
        p = dd.DiffDriveParams(jnp.float64(0.16), jnp.float64(0.033))
        B = 8
        states = dd.DiffDriveState(
            pose=jnp.zeros((B, 3), jnp.float64), wheels=jnp.zeros((B, 2), jnp.float64)
        )
        targets = jnp.array(np.random.default_rng(4).uniform(-1, 1, (B, 2)))
        out = jax.vmap(lambda s, w: dd.step(p, s, w))(states, targets)
        for i in range(B):
            one = dd.step(
                p,
                dd.DiffDriveState(states.pose[i], states.wheels[i]),
                targets[i],
            )
            np.testing.assert_allclose(out.pose[i], one.pose, atol=1e-12)
