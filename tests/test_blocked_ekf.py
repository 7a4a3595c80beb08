"""Blocked/sharded EKF vs the single-array reference implementation.

The multi-chip contract (SURVEY.md section 4): the same jitted program on a
1-device and an 8-device mesh must agree with the dense single-chip filter
to float tolerance. Runs on the 8 virtual CPU devices from conftest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.parallel import blocked_ekf, mesh as mesh_lib

N = 8          # landmark capacity (divisible by the map axis)
M = 3          # measurements per tick
B = 2          # batch


def dense_to_blocked(st: ekf.EKFState, batch_idx=None) -> tuple:
    """Split a dense EKFState into blocked parts (single batch element)."""
    D = st.mean.shape[0]
    n = (D - 3) // 2
    mean_r = st.mean[:3]
    mean_m = st.mean[3:].reshape(n, 2)
    cov_rr = st.cov[:3, :3]
    cov_rm = st.cov[:3, 3:].reshape(3, n, 2)
    # comp planes: plane[p, q, n, m] = cov[3+2n+p, 3+2m+q]
    cov_mm = jnp.transpose(st.cov[3:, 3:].reshape(n, 2, n, 2), (1, 3, 0, 2))
    return mean_r, mean_m, cov_rr, cov_rm, cov_mm


def make_inputs(seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    twists = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 4, 3)), dtype)
    # measurements: ranges 0.3-1.0, bearings +-pi
    zs = jnp.asarray(
        np.stack([rng.uniform(0.3, 1.0, (B, 4, M)),
                  rng.uniform(-3, 3, (B, 4, M))], axis=-1), dtype)
    valid = jnp.asarray(rng.uniform(size=(B, 4, M)) < 0.9)
    # ids initialize slots in order (slot t first referenced at tick t) —
    # like the fake_sensor wiring. Random ids would create "counted as seen
    # but never initialized" slots whose INT_MAX-prior updates are too
    # ill-conditioned to compare across computation orders.
    ids = np.zeros((B, 4, M), np.int32)
    for t in range(4):
        for k in range(M):
            ids[:, t, k] = (t + k) % 4
    return twists, zs, valid, jnp.asarray(ids)


@pytest.mark.parametrize("map_devices", [1, 2, 4])
def test_blocked_matches_dense_known_assoc(map_devices):
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], dtype))
    R = jnp.diag(jnp.array([0.001, 0.001], dtype))
    twists, zs, valid, ids = make_inputs(dtype=dtype)

    # dense oracle, per batch element, 4 sequential ticks
    dense_states = []
    for b in range(B):
        st = ekf.init(cfg, jnp.zeros(3, dtype), dtype=dtype)
        for t in range(4):
            st = ekf.known_association_step(
                cfg, st, twists[b, t], zs[b, t], valid[b, t], ids[b, t], Q, R)
        dense_states.append(st)

    # blocked sharded path
    devices = jax.devices()[: 2 * map_devices]
    mesh = mesh_lib.make_mesh(devices, data=2)
    step = blocked_ekf.make_sharded_step(cfg, mesh, B, M)
    bst = blocked_ekf.init(cfg, B, dtype=dtype)
    specs = blocked_ekf.state_sharding(mesh)
    bst = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst, specs)
    for t in range(4):
        bst = step(bst, twists[:, t], zs[:, t], valid[:, t], ids[:, t], Q, R)

    for b in range(B):
        mean_r, mean_m, cov_rr, cov_rm, cov_mm = dense_to_blocked(
            dense_states[b])
        np.testing.assert_allclose(bst.mean_r[b], mean_r, atol=1e-9)
        np.testing.assert_allclose(bst.mean_m[b], mean_m, atol=1e-9)
        np.testing.assert_allclose(bst.cov_rr[b], cov_rr, atol=1e-8)
        np.testing.assert_allclose(bst.cov_rm[b], cov_rm, atol=1e-8)
        assert int(bst.n_seen[b]) == int(dense_states[b].n_seen)
        # landmark grid: compare only seen blocks (unseen keep the huge
        # prior whose exact handling differs by path)
        ns = int(bst.n_seen[b])
        np.testing.assert_allclose(
            bst.cov_mm[b][:, :, :ns, :ns], cov_mm[:, :, :ns, :ns], atol=1e-8)


def test_one_vs_many_devices_bitwise():
    """The sharded program on 1 map device vs 4 map devices: same results."""
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], dtype))
    R = jnp.diag(jnp.array([0.001, 0.001], dtype))
    twists, zs, valid, ids = make_inputs(seed=3, dtype=dtype)

    results = []
    for map_devices in (1, 4):
        mesh = mesh_lib.make_mesh(jax.devices()[:map_devices], data=1)
        step = blocked_ekf.make_sharded_step(cfg, mesh, B, M)
        bst = blocked_ekf.init(cfg, B, dtype=dtype)
        specs = blocked_ekf.state_sharding(mesh)
        bst = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst, specs)
        for t in range(4):
            bst = step(bst, twists[:, t], zs[:, t], valid[:, t], ids[:, t],
                       Q, R)
        results.append(jax.tree_util.tree_map(np.asarray, bst))

    a, b = results
    np.testing.assert_allclose(a.mean_r, b.mean_r, atol=1e-12)
    np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-12)
    np.testing.assert_allclose(a.cov_rm, b.cov_rm, atol=1e-11)


@pytest.mark.parametrize("map_devices", [1, 4])
def test_deferred_matches_sequential(map_devices):
    """The deferred rank-2M grid update (one grid pass per tick) must equal
    the per-measurement sequential step — same inits/updates/skips, same
    sequential ordering semantics, only fp summation order differs."""
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], dtype))
    R = jnp.diag(jnp.array([0.001, 0.001], dtype))
    twists, zs, valid, ids = make_inputs(seed=5, dtype=dtype)

    mesh = mesh_lib.make_mesh(jax.devices()[:map_devices], data=1)
    results = []
    for maker in (blocked_ekf.make_sharded_step,
                  blocked_ekf.make_sharded_deferred_step):
        step = maker(cfg, mesh, B, M)
        bst = blocked_ekf.init(cfg, B, dtype=dtype)
        specs = blocked_ekf.state_sharding(mesh)
        bst = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), bst,
            specs)
        for t in range(4):
            bst = step(bst, twists[:, t], zs[:, t], valid[:, t], ids[:, t],
                       Q, R)
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
