"""Tube-world simulator tests: semantics of the slip quirk, collisions,
sensors, and the dynamics/observe split."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.sim import tube_world as tw


def mk(dtype=jnp.float64, **over):
    params = tw.default_params(dtype=dtype, **over)
    return tw.WorldConfig(), params, tw.init_state(params, dtype)


class TestStep:
    def test_step_equals_dynamics_plus_observe(self):
        cfg, params, st = mk()
        key = jax.random.PRNGKey(0)
        cmd = jnp.array([0.2, 0.1, 0.0], jnp.float64)
        st1, obs1 = tw.step(cfg, params, st, cmd, 0.02, key)
        kd, ko = jax.random.split(key, 2)
        st2 = tw.step_dynamics(cfg, params, st, cmd, 0.02, kd)
        obs2 = tw.observe(cfg, params, st2, ko)
        np.testing.assert_allclose(st1.drive.pose, st2.drive.pose)
        np.testing.assert_allclose(obs1.fake_sensor, obs2.fake_sensor)
        np.testing.assert_allclose(obs1.scan, obs2.scan)

    def test_slip_kick(self):
        """slip=[1,1]: true wheels = commanded + u exactly (the reference
        quirk) -> after the first tick truth leads odometry by ~1 s of
        motion, thereafter both advance identically (PARITY.md P7)."""
        cfg, params, st = mk(slip_min=1.0, slip_max=1.0, twist_noise=0.0,
                             tube_locs=[[50.0, 50.0]])
        cmd = jnp.array([0.0, 0.1, 0.0], jnp.float64)
        key = jax.random.PRNGKey(1)
        st1 = tw.step_dynamics(cfg, params, st, cmd, 0.02, key)
        # commanded wheel advance: u*dt; true advance: u*dt + u
        u = 0.1 / float(params.wheel_rad)
        np.testing.assert_allclose(st1.cmd_wheels, [u * 0.02] * 2, atol=1e-12)
        np.testing.assert_allclose(st1.drive.wheels, [u * 1.02] * 2,
                                   atol=1e-12)
        np.testing.assert_allclose(st1.drive.pose[1], 0.1 * 1.02, atol=1e-12)

    def test_no_slip_matches_commanded(self):
        cfg, params, st = mk(slip_min=0.0, slip_max=0.0,
                             tube_locs=[[50.0, 50.0]])
        cmd = jnp.array([0.3, 0.1, 0.0], jnp.float64)
        st1 = tw.step_dynamics(cfg, params, st, cmd, 0.02,
                               jax.random.PRNGKey(2))
        np.testing.assert_allclose(st1.drive.wheels, st1.cmd_wheels,
                                   atol=1e-12)


class TestCollision:
    def test_tangential_slide(self):
        # robot at origin, tube just ahead within contact distance
        cfg, params, st = mk(tube_locs=[[0.1, 0.0]])
        st = st._replace()  # robot at origin; dist 0.1 < 0.0381+0.08
        cmd = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        st1 = tw.step_dynamics(cfg, params, st, cmd, 0.02,
                               jax.random.PRNGKey(0))
        # nudge along tangent: move = (dy, -dx)/dist / 50 = (0, -1)/50
        np.testing.assert_allclose(st1.drive.pose[2], -0.02, atol=1e-9)

    def test_no_collision_far(self):
        cfg, params, st = mk(tube_locs=[[1.0, 0.0]])
        st1 = tw.step_dynamics(cfg, params, st,
                               jnp.zeros(3, jnp.float64), 0.02,
                               jax.random.PRNGKey(0))
        np.testing.assert_allclose(st1.drive.pose, [0, 0, 0], atol=1e-12)


class TestSensors:
    def test_fake_sensor_geometry(self):
        cfg, params, st = mk(tube_locs=[[0.5, 0.0], [0.0, 2.0]],
                             tube_var=0.0)
        # rotate robot 90 deg: tube at (0.5, 0) appears at (0, -0.5)
        drive = st.drive._replace(
            pose=jnp.array([np.pi / 2, 0.0, 0.0], jnp.float64))
        obs = tw.observe(cfg, params, st._replace(drive=drive),
                         jax.random.PRNGKey(0))
        np.testing.assert_allclose(obs.fake_sensor[0], [0.0, -0.5],
                                   atol=1e-12)
        assert bool(obs.fake_sensor_valid[0])
        assert not bool(obs.fake_sensor_valid[1])  # 2 m > max_range 1 m

    def test_tube_var_constant_offset(self):
        cfg, params, st = mk(tube_locs=[[0.5, 0.0]], tube_var=0.001)
        obs = tw.observe(cfg, params, st, jax.random.PRNGKey(0))
        np.testing.assert_allclose(obs.fake_sensor[0], [0.501, 0.001],
                                   atol=1e-12)

    def test_lidar_hits_tube(self):
        cfg, params, st = mk(tube_locs=[[0.5, 0.0]])
        obs = tw.observe(cfg, params, st, jax.random.PRNGKey(0))
        scan = np.asarray(obs.scan)
        # ray 0 points at the tube: range = 0.5 - tube_rad
        np.testing.assert_allclose(scan[0], 0.5 - 0.0381, atol=1e-6)
        # rays pointing away miss
        assert scan[180] > float(params.scan_max)

    def test_lidar_heading_rotates_scan(self):
        cfg, params, st = mk(tube_locs=[[0.5, 0.0]])
        drive = st.drive._replace(
            pose=jnp.array([np.pi / 2, 0.0, 0.0], jnp.float64))
        obs = tw.observe(cfg, params, st._replace(drive=drive),
                         jax.random.PRNGKey(0))
        scan = np.asarray(obs.scan)
        # tube now at bearing -90 deg in the body frame -> bin 270
        np.testing.assert_allclose(scan[270], 0.5 - 0.0381, atol=1e-6)
        assert scan[0] > float(params.scan_max)

    def test_observation_gating(self):
        cfg, params, st = mk()
        cfg_off = dataclasses.replace(cfg, compute_scan=False,
                                      compute_fake_sensor=False)
        obs = tw.observe(cfg_off, params, st, jax.random.PRNGKey(0))
        assert float(jnp.sum(jnp.abs(obs.scan))) == 0.0
        assert not bool(obs.fake_sensor_valid.any())

    def test_perception_closes_loop_with_sim(self):
        """Sim lidar -> detector recovers the tube position."""
        from shermbot_navigation.ops.landmark_detection import (
            detect_landmarks)
        cfg, params, st = mk(tube_locs=[[0.4, 0.2], [-0.3, -0.5]])
        obs = tw.observe(cfg, params, st, jax.random.PRNGKey(0))
        det = detect_landmarks(obs.scan, params.scan_min, params.scan_max)
        got = np.asarray(det.positions[det.valid])
        assert got.shape[0] == 2
        want = np.array([[0.4, 0.2], [-0.3, -0.5]])
        for w in want:
            assert np.min(np.linalg.norm(got - w, axis=1)) < 5e-3


class TestSlipModes:
    def test_reference_slip_telescopes(self):
        """PARITY P7: reference slip noise telescopes — true-vs-commanded
        wheel difference equals u*eta of the LAST tick only, so odometry
        error stays bounded regardless of trajectory length."""
        import dataclasses
        cfg, params, st = mk(slip_min=0.9, slip_max=1.0,
                             tube_locs=[[50.0, 50.0]])
        cmd = jnp.array([0.0, 0.1, 0.0], jnp.float64)
        key = jax.random.PRNGKey(3)
        for _ in range(50):
            key, k = jax.random.split(key)
            st = tw.step_dynamics(cfg, params, st, cmd, 0.02, k)
        u = 0.1 / float(params.wheel_rad)
        gap = float(st.drive.wheels[0] - st.cmd_wheels[0])
        assert 0.8 * u <= gap <= 1.2 * u  # ~one eta sample, NOT 50 accumulated

    def test_multiplicative_slip_accumulates(self):
        import dataclasses
        cfg, params, st = mk(slip_min=0.9, slip_max=0.9,
                             tube_locs=[[50.0, 50.0]])
        cfg = dataclasses.replace(cfg, slip_mode="multiplicative")
        cmd = jnp.array([0.0, 0.1, 0.0], jnp.float64)
        key = jax.random.PRNGKey(3)
        for _ in range(50):
            key, k = jax.random.split(key)
            st = tw.step_dynamics(cfg, params, st, cmd, 0.02, k)
        # eta = 0.9 exactly: true wheels = 0.9 * commanded, growing gap
        np.testing.assert_allclose(
            np.asarray(st.drive.wheels), 0.9 * np.asarray(st.cmd_wheels),
            rtol=1e-9)
