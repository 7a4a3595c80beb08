"""The native C++ host engine (ctypes bindings) vs the CLI and the JAX engine.

The in-process engine (shermbot_navigation.native) must be the same
program as the ``baseline`` CLI (shared engine.cpp) and must agree with the
JAX pipeline under PARITY.md semantics — these tests pin the bindings, the
refactor, and the cross-engine contracts.
"""

import csv
import os
import subprocess

import numpy as np
import pytest

from shermbot_navigation.native import (HostEngine, detect_landmarks,
                                            ensure_built, simulate_lidar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_DIR = os.path.join(REPO, "native", "baseline")
BASELINE_BIN = os.path.join(BASELINE_DIR, "baseline")


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_built()
    if not os.path.exists(BASELINE_BIN):
        subprocess.run(["make"], cwd=BASELINE_DIR, check=True,
                       capture_output=True)


class TestHostEngine:
    def test_scenario_run_matches_cli(self, tmp_path):
        """In-process trajectory == CLI trajectory (same deterministic
        program, two entry points)."""
        traj_csv = str(tmp_path / "t.csv")
        subprocess.run(
            [BASELINE_BIN, "--scenario", "loop5_known", "--deterministic",
             "--traj", traj_csv],
            check=True, capture_output=True)
        rows = list(csv.DictReader(open(traj_csv)))

        eng = HostEngine("loop5_known", deterministic=True)
        import math
        w60 = 2 * math.pi / 60.0
        traj = eng.run(600, w60, 0.052, record=True)

        cli = np.array([
            [float(r["true_th"]), float(r["true_x"]), float(r["true_y"]),
             float(r["odom_th"]), float(r["odom_x"]), float(r["odom_y"]),
             float(r["slam_th"]), float(r["slam_x"]), float(r["slam_y"])]
            for r in rows])
        np.testing.assert_allclose(traj, cli, rtol=0, atol=1e-9)
        assert abs(eng.ate - 0.051976) < 1e-5  # BENCH_NOTES headline ATE

    def test_state_accessors(self):
        eng = HostEngine("loop5_known", deterministic=True)
        assert eng.state_dim == 3 + 2 * 5
        n = 0
        for _ in range(20):
            n = eng.tick(0.1, 0.05)
        assert n >= 1  # tick returns landmarks seen so far
        st = eng.state
        assert st.shape == (13,)
        cov = eng.cov
        assert cov.shape == (13, 13)
        # seen landmark blocks must have finite, small covariance;
        # unseen keep the INT_MAX prior
        assert cov[3, 3] < 1.0
        p = eng.poses
        assert set(p) == {"truth", "odom", "slam"}

    def test_custom_world_matches_named_scenario(self):
        """create_custom with stock6's parameters == create('stock6')."""
        tubes = np.array([[0.5, 0.5], [-0.5, -0.5], [1.0, 1.0],
                          [-1.0, -1.0], [-0.75, 0.75], [0.75, -0.75]])
        a = HostEngine("stock6", deterministic=True)
        b = HostEngine(tubes=tubes, capacity=6, known_assoc=False,
                       use_lidar=False, max_range=1.0, tube_var=0.001,
                       twist_noise=0.0, slip_min=0.9, slip_max=1.0,
                       deterministic=True)
        for _ in range(50):
            a.tick(0.5, 0.1)
            b.tick(0.5, 0.1)
        np.testing.assert_allclose(a.state, b.state, atol=0)

    def test_unknown_scenario_raises(self):
        with pytest.raises(ValueError):
            HostEngine("no_such_scenario")


class TestCrossEnginePerception:
    def test_native_lidar_matches_jax_sim(self):
        """Native lidar == the JAX simulator's default (correct-geometry)
        lidar at the same pose."""
        import jax
        import jax.numpy as jnp
        from shermbot_navigation.sim import tube_world

        tubes = np.array([[0.6, 0.1], [-0.3, 0.5], [0.0, -0.7]])
        pose = (0.3, 0.05, -0.1)
        native = simulate_lidar(tubes, pose)

        config = tube_world.WorldConfig()
        params = tube_world.default_params(tube_locs=tubes,
                                           dtype=jnp.float64)
        ranges = tube_world._lidar(config, params,
                                   jnp.asarray(pose, jnp.float64),
                                   jax.random.PRNGKey(0))
        np.testing.assert_allclose(native, np.asarray(ranges), atol=1e-9)

    def test_native_detection_matches_jax(self):
        """scan -> detections agree across engines (discrete decisions +
        fitted centers)."""
        import jax.numpy as jnp
        from shermbot_navigation.ops.landmark_detection import (
            detect_landmarks as jax_detect)

        tubes = np.array([[0.6, 0.1], [-0.3, 0.5], [0.0, -0.7]])
        scan = simulate_lidar(tubes, (0.2, 0.0, 0.0))

        native = detect_landmarks(scan)
        det = jax_detect(jnp.asarray(scan, jnp.float64), 0.05, 1.0)
        jx = np.asarray(det.positions)[np.asarray(det.valid)]
        assert native.shape == jx.shape
        np.testing.assert_allclose(native, jx, atol=1e-8)
        assert len(native) >= 1
