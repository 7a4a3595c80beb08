"""NaN-tripwire (checkify) + buffer-donation tests — SURVEY §5 sanitizers
row. The reference has nothing here (single-threaded C++, -Wall only); the
failure class is ours: f32 conditioning cliffs NaN'd 50k-scale runs
(BENCH_NOTES pathologies 6-7), and jit propagates NaN silently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify
from jax.sharding import NamedSharding

from shermbot_navigation.models.ekf_slam import EKFConfig
from shermbot_navigation.parallel import bigmap, blocked_ekf
from shermbot_navigation.parallel.mesh import make_mesh
from shermbot_navigation.pipeline import metrics
from shermbot_navigation.pipeline.config import get_scenario
from shermbot_navigation.pipeline.driver import run_scenario
from shermbot_navigation.utils import guards


def test_checked_scenario_clean_run_matches_unchecked():
    """The tripwire is an observer: a healthy scenario runs through
    run_scenario_checked without raising and produces the same trajectory
    as the raw driver."""
    scn = get_scenario("loop5_known")
    key = jax.random.PRNGKey(0)
    outs_checked = guards.run_scenario_checked(scn, key)
    outs_raw = run_scenario(scn, key)
    np.testing.assert_array_equal(np.asarray(outs_checked.slam_pose),
                                  np.asarray(outs_raw.slam_pose))
    ate = float(metrics.ate(outs_checked.slam_pose[:, 1:],
                            outs_checked.true_pose[:, 1:]))
    assert ate < 0.06


def test_checked_scenario_nan_noise_trips_and_names_field():
    """Negative control: a NaN planted in the process-noise config poisons
    the covariance on the first predict; the tripwire must raise and name
    the EKF field instead of letting the rollout complete with NaN."""
    scn = get_scenario("loop5_known")
    scn = dataclasses.replace(scn, q_diag=(float("nan"), 0.1, 0.1))
    with pytest.raises(checkify.JaxRuntimeError, match="ekf\\."):
        guards.run_scenario_checked(scn, jax.random.PRNGKey(0))


def test_checked_blocked_tick_clean_and_poisoned():
    """The blocked-EKF tripwire passes a healthy sharded tick and names the
    poisoned field (cov_mm) when the input state carries a NaN."""
    N, M, B = 32, 4, 1
    mesh = make_mesh(jax.devices()[:2], data=1, map_=2)
    cfg = EKFConfig(num_landmarks=N)
    step = blocked_ekf.make_sharded_step(cfg, mesh, B, M)
    tick = guards.checked_blocked_tick(step)

    state = blocked_ekf.init(cfg, B, dtype=jnp.float32)
    specs = blocked_ekf.state_sharding(mesh)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    tw = jnp.zeros((B, 3), jnp.float32)
    zs = jnp.ones((B, M, 2), jnp.float32) * 0.5
    valid = jnp.ones((B, M), bool)
    ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (B, M))

    err, out = tick(state, tw, zs, valid, ids, Q, R)
    err.throw()                                    # clean: no raise
    assert int(out.n_seen[0]) == M

    bad = state._replace(mean_r=state.mean_r.at[0, 0].set(jnp.nan))
    err, _ = tick(bad, tw, zs, valid, ids, Q, R)
    with pytest.raises(checkify.JaxRuntimeError, match="mean_r"):
        err.throw()


def test_donated_runner_reuses_covariance_buffer():
    """donate=True makes the runner's out-Sigma reuse the in-Sigma
    allocation: the input cov_mm buffer address reappears in the output and
    the input state is invalidated — peak HBM stays ~1x the grid instead of
    2x (1.07 GB apiece at N=8192; run here at N=2048 on CPU, the aliasing
    proof is scale-independent)."""
    N, M, T = 2048, 4, 2
    mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0))
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    specs = blocked_ekf.state_sharding(mesh)

    runner = bigmap.make_runner(cfg, mesh, 1, M, deferred=True,
                                grid_kernel=False, donate=True)
    state = blocked_ekf.init(cfg, 1, dtype=jnp.float32)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)
    in_ptr = state.cov_mm.unsafe_buffer_pointer()

    out = runner(state, wl, Q, R, jnp.int32(0), T)
    assert np.isfinite(np.asarray(out.mean_r)).all()
    # the donated input is dead...
    assert state.cov_mm.is_deleted()
    # ...and its allocation was actually reused for the result grid
    assert out.cov_mm.unsafe_buffer_pointer() == in_ptr
