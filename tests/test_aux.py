"""Auxiliary subsystem tests: checkpoint/resume, odometry node, robot
description, tracing harness, viz artifacts, fault injection, YAML config."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.ops import diff_drive as dd
from shermbot_navigation.pipeline import checkpoint, odometry
from shermbot_navigation.pipeline.config import ScenarioConfig, from_yaml, get_scenario
from shermbot_navigation.utils.robot import TURTLEBOT3_BURGER
from shermbot_navigation.utils.tracing import MetricsLog, time_fn


class TestCheckpoint:
    def test_roundtrip_pipeline_state(self, tmp_path):
        from shermbot_navigation.pipeline.driver import init_pipeline
        scn = get_scenario("stock6")
        st = init_pipeline(scn, jnp.float32)
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(path, st, step=42)
        st2, step = checkpoint.load(path, st)
        assert step == 42
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(st2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_resume_determinism(self, tmp_path):
        """run 20 ticks straight == run 10, checkpoint, load, run 10."""
        from shermbot_navigation.pipeline.driver import (
            init_pipeline, slam_tick)
        scn = dataclasses.replace(get_scenario("stock6"), steps=20)
        params = scn.world_params(jnp.float32)
        Q, R = scn.noise_matrices(jnp.float32)
        cmd = jnp.array([0.3, 0.08, 0.0], jnp.float32)
        tick = jax.jit(lambda s: slam_tick(scn, params, Q, R, s, cmd)[0])

        a = init_pipeline(scn, jnp.float32)
        for _ in range(20):
            a = tick(a)

        b = init_pipeline(scn, jnp.float32)
        for _ in range(10):
            b = tick(b)
        path = str(tmp_path / "mid.npz")
        checkpoint.save(path, b, step=10)
        b2, step = checkpoint.load(path, b)
        for _ in range(10):
            b2 = tick(b2)
        np.testing.assert_array_equal(np.asarray(a.filt.mean),
                                      np.asarray(b2.filt.mean))

    def test_structure_mismatch_raises(self, tmp_path):
        st = ekf.init(ekf.EKFConfig(num_landmarks=3), jnp.zeros(3))
        path = str(tmp_path / "c.npz")
        checkpoint.save(path, st)
        other = ekf.init(ekf.EKFConfig(num_landmarks=4), jnp.zeros(3))
        try:
            checkpoint.load(path, other)
            assert False, "should have raised"
        except ValueError:
            pass


class TestOdometry:
    def test_update_and_set_pose(self):
        p = TURTLEBOT3_BURGER.diff_drive_params(jnp.float64)
        st = dd.init_state(dtype=jnp.float64)
        st, out = odometry.update(p, st, jnp.array([1.0, 1.0], jnp.float64))
        # equal wheels -> straight line x = r * dwheel
        np.testing.assert_allclose(out.pose[1], 0.033, atol=1e-12)
        np.testing.assert_allclose(out.twist[1], 0.033, atol=1e-12)
        st = odometry.set_pose(st, 0.5, 1.0, 2.0)
        np.testing.assert_allclose(st.pose, [0.5, 1.0, 2.0], atol=1e-12)
        np.testing.assert_allclose(st.wheels, [0.0, 0.0])


class TestConfig:
    def test_yaml_roundtrip(self, tmp_path):
        path = tmp_path / "scn.yaml"
        path.write_text(
            "name: mytest\nsteps: 12\ntubes: [[0.5, 0.5], [-0.5, 0.5]]\n"
            "num_landmarks: 2\nknown_association: true\n")
        scn = from_yaml(str(path))
        assert scn.name == "mytest"
        assert scn.steps == 12
        assert scn.tubes == ((0.5, 0.5), (-0.5, 0.5))

    def test_unknown_key_raises(self, tmp_path):
        path = tmp_path / "bad.yaml"
        path.write_text("name: x\nnot_a_key: 1\n")
        try:
            from_yaml(str(path))
            assert False
        except ValueError as e:
            assert "not_a_key" in str(e)


class TestFaultInjection:
    def test_sensor_dropout(self):
        from shermbot_navigation.sim import tube_world as tw
        params = tw.default_params(dtype=jnp.float64, sensor_dropout=1.0,
                                   max_range=10.0)
        cfg = tw.WorldConfig()
        st = tw.init_state(params, jnp.float64)
        obs = tw.observe(cfg, params, st, jax.random.PRNGKey(0))
        assert not bool(obs.fake_sensor_valid.any())

    def test_scan_dropout(self):
        from shermbot_navigation.sim import tube_world as tw
        params = tw.default_params(dtype=jnp.float64, scan_dropout=1.0)
        cfg = tw.WorldConfig()
        st = tw.init_state(params, jnp.float64)
        obs = tw.observe(cfg, params, st, jax.random.PRNGKey(0))
        assert float(obs.scan.min()) > float(params.scan_max)


class TestTracing:
    def test_time_fn(self):
        f = jax.jit(lambda x: x * 2 + 1)
        out = time_fn(f, jnp.ones((16, 16)), iters=3)
        assert out["best_s"] > 0
        assert out["best_s"] <= out["median_s"] + 1e-9

    def test_metrics_log(self, tmp_path):
        import json
        path = str(tmp_path / "m.jsonl")
        log = MetricsLog(path)
        log.log(step=1, ate=jnp.float32(0.5))
        log.log(step=2, ate=0.25, note="hello")
        log.close()
        lines = [json.loads(l) for l in open(path)]
        assert lines[0]["step"] == 1
        assert abs(lines[0]["ate"] - 0.5) < 1e-9
        assert lines[1]["note"] == "hello"


class TestViz:
    def test_plot_and_csv(self, tmp_path):
        from shermbot_navigation.pipeline import viz
        from shermbot_navigation.pipeline.driver import TickOutput
        T = 10
        outs = TickOutput(
            true_pose=jnp.zeros((T, 3)), odom_pose=jnp.ones((T, 3)) * 0.1,
            slam_pose=jnp.ones((T, 3)) * 0.2,
            n_seen=jnp.arange(T), nees=jnp.ones(T))
        png = str(tmp_path / "run.png")
        viz.plot_run(png, outs, tube_locs=[[0.5, 0.5]],
                     est_landmarks=[[0.4, 0.4]])
        assert os.path.getsize(png) > 1000
        csvp = str(tmp_path / "run.csv")
        viz.write_trajectory_csv(csvp, outs)
        assert len(open(csvp).readlines()) == T + 1

    def test_scan_figure(self, tmp_path):
        from shermbot_navigation.pipeline import viz
        png = str(tmp_path / "scan.png")
        scan = np.full(360, 2.0)
        scan[10:20] = 0.5
        viz.scan_figure(png, scan, detections=[[0.5, 0.1]],
                        valid=[True])
        assert os.path.getsize(png) > 1000


class TestTurtleRect:
    def test_traces_rectangle(self):
        """Closed-loop: drive the fake turtle with the FSM controller and
        check it visits all four corners."""
        from shermbot_navigation.sim import fake_turtle, turtle_rect
        dtype = jnp.float64
        p = TURTLEBOT3_BURGER.diff_drive_params(dtype)
        rp = turtle_rect.RectParams(
            x=jnp.asarray(0.0, dtype), y=jnp.asarray(0.0, dtype),
            width=jnp.asarray(0.5, dtype), height=jnp.asarray(0.3, dtype),
            max_xdot=jnp.asarray(0.2, dtype),
            max_wdot=jnp.asarray(1.0, dtype))
        ctrl, corners = turtle_rect.start(rp)
        ft = fake_turtle.init_state(dtype)
        dt = 0.02

        @jax.jit
        def step(ctrl, ft):
            ctrl, cmd = turtle_rect.controller_step(rp, ctrl, ft.drive.pose)
            ft, _ = fake_turtle.step(p, ft, cmd, dt)
            return ctrl, ft

        traj = []
        for _ in range(3000):
            ctrl, ft = step(ctrl, ft)
            traj.append(np.asarray(ft.drive.pose[1:]))
        traj = np.stack(traj)
        for c in np.asarray(corners):
            assert np.min(np.linalg.norm(traj - c, axis=1)) < 0.08, c
        assert int(ctrl.fsm) == turtle_rect.IDLE
