"""Serving path (pipeline/serving.py) vs the dense engine.

The serving tick is the deferred blocked step at map=1/batch=1; its
semantics must match the dense engine's sequential tick
(``models.ekf_slam.known_association_step`` / ``step``) — the same
contract the blocked-engine parity tests pin, re-pinned here through the
serving API including the dense->blocked state migration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.pipeline import serving

N = 16
M = 4
Q3 = jnp.diag(jnp.array([0.01, 0.01, 0.01], jnp.float64))
R2 = jnp.diag(jnp.array([0.001, 0.001], jnp.float64))


def _inputs(T, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    twists = jnp.asarray(rng.uniform(-0.05, 0.05, (T, 3)), dtype)
    zs = jnp.asarray(np.stack([rng.uniform(0.3, 1.0, (T, M)),
                               rng.uniform(-3, 3, (T, M))], axis=-1), dtype)
    valid = jnp.asarray(rng.uniform(size=(T, M)) < 0.9)
    ids = np.zeros((T, M), np.int32)
    for t in range(T):
        for k in range(M):
            ids[t, k] = (t + k) % 8
    return twists, zs, valid, jnp.asarray(ids)


def _converged_dense(cfg, n_init, dtype, seed=1):
    """A dense state with n_init landmarks initialized (a served map)."""
    rng = np.random.default_rng(seed)
    st = ekf.init(cfg, jnp.array([0.1, 0.2, -0.1], dtype), dtype=dtype)
    for t in range(n_init):
        z = jnp.asarray(rng.uniform([0.3, -3], [1.0, 3]), dtype)
        st, _ = ekf.step_measurement(
            cfg, st, z, jnp.bool_(True), jnp.bool_(False),
            jnp.asarray(R2, dtype))
    return st


def test_state_roundtrip_bitwise():
    cfg = ekf.EKFConfig(num_landmarks=N)
    st = _converged_dense(cfg, 5, jnp.float64)
    back = serving.state_to_dense(
        cfg, serving.state_from_dense(cfg, st))
    np.testing.assert_array_equal(np.asarray(back.mean), np.asarray(st.mean))
    np.testing.assert_array_equal(np.asarray(back.cov), np.asarray(st.cov))
    assert int(back.n_seen) == int(st.n_seen)
    np.testing.assert_array_equal(np.asarray(back.seen), np.asarray(st.seen))


@pytest.mark.parametrize("known", [True, False])
def test_serving_matches_dense(known):
    dtype = jnp.float64
    cfg = ekf.EKFConfig(num_landmarks=N)
    T = 4
    twists, zs, valid, ids = _inputs(T, dtype=dtype)

    dense = _converged_dense(cfg, 3, dtype)
    srv = serving.state_from_dense(cfg, dense)
    tick = serving.make_serving_step(cfg, M, known=known, dtype=dtype,
                                     donate=False)
    for t in range(T):
        if known:
            dense = ekf.known_association_step(
                cfg, dense, twists[t], zs[t], valid[t], ids[t], Q3, R2)
            srv = tick(srv, twists[t], zs[t], valid[t], ids[t], Q3, R2)
        else:
            dense = ekf.step(cfg, dense, twists[t], zs[t], valid[t], Q3, R2)
            srv = tick(srv, twists[t], zs[t], valid[t], Q3, R2)
    got = serving.state_to_dense(cfg, srv)
    assert int(got.n_seen) == int(dense.n_seen)
    np.testing.assert_array_equal(np.asarray(got.seen),
                                  np.asarray(dense.seen))
    np.testing.assert_allclose(got.mean, dense.mean, atol=1e-8)
    k = 3 + 2 * int(dense.n_seen)
    np.testing.assert_allclose(got.cov[:k, :k], dense.cov[:k, :k],
                               atol=1e-6)


def test_serving_kernel_interpret_matches_dense():
    """The exact kernel-routed code path (the grid kernel in interpret
    mode) through the serving API."""
    dtype = jnp.float32
    cfg = ekf.EKFConfig(num_landmarks=N)
    T = 3
    twists, zs, valid, ids = _inputs(T, dtype=dtype)
    dense = _converged_dense(cfg, 3, dtype)
    srv = serving.state_from_dense(cfg, dense)
    tick = serving.make_serving_step(
        cfg, M, known=True, dtype=dtype, donate=False,
        grid_kernel=True, kernel_interpret=True)
    for t in range(T):
        dense = ekf.known_association_step(
            cfg, dense, twists[t].astype(dtype), zs[t].astype(dtype),
            valid[t], ids[t], Q3.astype(dtype), R2.astype(dtype))
        srv = tick(srv, twists[t].astype(dtype), zs[t].astype(dtype),
                   valid[t], ids[t], Q3.astype(dtype), R2.astype(dtype))
    got = serving.state_to_dense(cfg, srv)
    assert int(got.n_seen) == int(dense.n_seen)
    np.testing.assert_allclose(got.mean, dense.mean, atol=2e-4)


def test_serving_engine_stateful_pads_measurements():
    cfg = ekf.EKFConfig(num_landmarks=N)
    eng = serving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2, known=True,
                                robot_pose=jnp.zeros(3), dtype=jnp.float64,
                                donate=False)
    # 2 real measurements into a max_meas=4 tick
    eng.tick(jnp.zeros(3), [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    assert eng.n_seen == 2
    assert np.isfinite(np.asarray(eng.pose)).all()
