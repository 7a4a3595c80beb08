"""Distributed unknown-association EKF vs the dense single-array filter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.parallel import blocked_ekf, mesh as mesh_lib

from test_blocked_ekf import dense_to_blocked

N = 8
M = 3
B = 2


@pytest.mark.parametrize("map_devices", [1, 2, 4])
def test_unknown_matches_dense(map_devices):
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], dtype))
    R = jnp.diag(jnp.array([0.001, 0.001], dtype))

    rng = np.random.default_rng(11)
    twists = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 5, 3)), dtype)
    # measurements around a few fixed world points so revisits MATCH and
    # fresh points spawn NEW landmarks, exercising every branch
    world_pts = rng.uniform(-1, 1, (5, 2))
    zs = np.zeros((B, 5, M, 2))
    for b in range(B):
        for t in range(5):
            for k in range(M):
                p = world_pts[(t + k) % 5] + rng.normal(0, 1e-4, 2)
                zs[b, t, k] = [np.hypot(*p), np.arctan2(p[1], p[0])]
    zs = jnp.asarray(zs, dtype)
    valid = jnp.asarray(rng.uniform(size=(B, 5, M)) < 0.9)

    # dense oracle
    dense_states = []
    for b in range(B):
        st = ekf.init(cfg, jnp.zeros(3, dtype), dtype=dtype)
        for t in range(5):
            st = ekf.step(cfg, st, twists[b, t], zs[b, t], valid[b, t], Q, R)
        dense_states.append(st)

    mesh = mesh_lib.make_mesh(jax.devices()[: 2 * map_devices], data=2)
    step = blocked_ekf.make_sharded_unknown_step(cfg, mesh, B, M)
    bst = blocked_ekf.init(cfg, B, dtype=dtype)
    specs = blocked_ekf.state_sharding(mesh)
    bst = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst, specs)
    for t in range(5):
        bst = step(bst, twists[:, t], zs[:, t], valid[:, t], Q, R)

    for b in range(B):
        d = dense_states[b]
        mean_r, mean_m, cov_rr, cov_rm, cov_mm = dense_to_blocked(d)
        assert int(bst.n_seen[b]) == int(d.n_seen), (
            int(bst.n_seen[b]), int(d.n_seen))
        np.testing.assert_allclose(bst.mean_r[b], mean_r, atol=1e-8)
        ns = int(d.n_seen)
        np.testing.assert_allclose(bst.mean_m[b][:ns], mean_m[:ns],
                                   atol=1e-8)
        np.testing.assert_allclose(bst.cov_rr[b], cov_rr, atol=1e-8)
        np.testing.assert_allclose(bst.cov_rm[b][:, :ns], cov_rm[:, :ns],
                                   atol=1e-8)


def test_unknown_runner_sweeps_map():
    """The config-4 unknown-association runner (bigmap.make_unknown_runner)
    initializes most of the map through the distributed first-hit gate and
    stays finite — ties the sharded association to the sweep workload
    end-to-end (the config-4 bench path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel import bigmap, blocked_ekf
    from shermbot_navigation.parallel.mesh import make_mesh

    N, M, T = 256, 8, 40
    mesh = make_mesh(jax.devices()[:2], data=1, map_=2)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0))
    runner = bigmap.make_unknown_runner(cfg, mesh, 1, M)
    state = blocked_ekf.init(cfg, 1)
    specs = blocked_ekf.state_sharding(mesh)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    out = runner(state, wl, Q, R, jnp.int32(0), T)
    n_seen = int(out.n_seen[0])
    assert 100 < n_seen <= N          # most of the sweep got initialized
    assert np.isfinite(np.asarray(out.mean_m)).all()
    assert np.isfinite(np.asarray(out.cov_rr)).all()


@pytest.mark.parametrize("map_devices", [1, 4])
def test_deferred_unknown_matches_sequential(map_devices):
    """Deferred rank-2M unknown-association tick == the per-measurement
    sequential sharded tick: same first-hit gate decisions (association
    scores against the carried diagonal strip), same init/update/skip
    outcomes, fp-tolerance-equal state."""
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], dtype))
    R = jnp.diag(jnp.array([0.001, 0.001], dtype))

    rng = np.random.default_rng(23)
    twists = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 5, 3)), dtype)
    world_pts = rng.uniform(-1, 1, (5, 2))
    zs = np.zeros((B, 5, M, 2))
    for b in range(B):
        for t in range(5):
            for k in range(M):
                p = world_pts[(t + k) % 5] + rng.normal(0, 1e-4, 2)
                zs[b, t, k] = [np.hypot(*p), np.arctan2(p[1], p[0])]
    zs = jnp.asarray(zs, dtype)
    valid = jnp.asarray(rng.uniform(size=(B, 5, M)) < 0.9)

    mesh = mesh_lib.make_mesh(jax.devices()[:map_devices], data=1)
    results = []
    for maker in (blocked_ekf.make_sharded_unknown_step,
                  blocked_ekf.make_sharded_deferred_unknown_step):
        step = maker(cfg, mesh, B, M)
        bst = blocked_ekf.init(cfg, B, dtype=dtype)
        specs = blocked_ekf.state_sharding(mesh)
        bst = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst,
            specs)
        for t in range(5):
            bst = step(bst, twists[:, t], zs[:, t], valid[:, t], Q, R)
        results.append(jax.tree_util.tree_map(np.asarray, bst))

    a, b = results
    np.testing.assert_array_equal(a.n_seen, b.n_seen)
    np.testing.assert_array_equal(a.seen, b.seen)
    np.testing.assert_allclose(a.mean_r, b.mean_r, atol=1e-10)
    np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-10)
    np.testing.assert_allclose(a.cov_rr, b.cov_rr, atol=1e-9)
    np.testing.assert_allclose(a.cov_rm, b.cov_rm, atol=1e-9)
    for bb in range(B):
        ns = int(a.n_seen[bb])
        np.testing.assert_allclose(a.cov_mm[bb][:, :, :ns, :ns],
                                   b.cov_mm[bb][:, :, :ns, :ns], atol=1e-8)


def test_deferred_unknown_f32_association_decisions():
    """f32 (the config-4 production dtype): the deferred tick's gate
    decisions match the sequential tick over a long rollout. The two paths
    are identical only in exact arithmetic (the reconstructed grid column
    and carried diagonal round differently), so this uses gate-robust
    inputs — well-separated world points, tight measurement noise — where
    a sub-ulp score difference cannot flip a first-hit decision, and
    asserts the DECISIONS (n_seen / seen / which slots updated) plus
    f32-tolerance state equality."""
    dtype = jnp.float32
    cfg = ekf.EKFConfig(num_landmarks=16)
    Q = jnp.diag(jnp.array([1e-4, 1e-4, 1e-4], dtype))
    R = jnp.diag(jnp.array([1e-3, 1e-3], dtype))

    rng = np.random.default_rng(42)
    T = 20
    twists = jnp.asarray(rng.uniform(-0.02, 0.02, (1, T, 3)), dtype)
    # 10 world points >= 1.5 m apart: revisits score far below match_gate,
    # fresh points far above new_gate — decisively outside the gray zone
    world_pts = np.stack([3.0 * np.cos(np.arange(10) * 0.63) + 5,
                          3.0 * np.sin(np.arange(10) * 0.63)], axis=-1)
    zs = np.zeros((1, T, M, 2))
    for t in range(T):
        for k in range(M):
            p = world_pts[(t + k) % 10] + rng.normal(0, 1e-5, 2)
            zs[0, t, k] = [np.hypot(*p), np.arctan2(p[1], p[0])]
    zs = jnp.asarray(zs, dtype)
    valid = jnp.ones((1, T, M), bool)

    mesh = mesh_lib.make_mesh(jax.devices()[:4], data=1)
    results = []
    for maker in (blocked_ekf.make_sharded_unknown_step,
                  blocked_ekf.make_sharded_deferred_unknown_step):
        step = maker(cfg, mesh, 1, M)
        bst = blocked_ekf.init(cfg, 1, dtype=dtype)
        specs = blocked_ekf.state_sharding(mesh)
        bst = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst,
            specs)
        seen_hist = []
        for t in range(T):
            bst = step(bst, twists[:, t], zs[:, t], valid[:, t], Q, R)
            seen_hist.append(np.asarray(bst.seen).copy())
        results.append((jax.tree_util.tree_map(np.asarray, bst), seen_hist))

    (a, hist_a), (b, hist_b) = results
    # decision equality at every tick, not just the end
    for t in range(T):
        np.testing.assert_array_equal(hist_a[t], hist_b[t])
    np.testing.assert_array_equal(a.n_seen, b.n_seen)
    assert 6 <= int(a.n_seen[0]) <= 10   # most points initialized
    np.testing.assert_allclose(a.mean_r, b.mean_r, atol=1e-5)
    np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-5)
    np.testing.assert_allclose(a.cov_rr, b.cov_rr, atol=1e-5)
