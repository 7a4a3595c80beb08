"""Batch-on-lanes engine (models/ekf_batch.py) vs the vmapped dense engine.

The batch-trailing engine is a pure LAYOUT change (BENCH_NOTES pathology
9 applied to the batch axis); its math is the same broadcast-arithmetic
decomposition. These tests pin: (a) f64 numeric parity of every phase
against vmap of the dense engine over random states; (b) f32
end-to-end trajectory agreement through the scenario driver (the actual
production wiring, run_scenario_batch_lanes vs run_scenario_batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shermbot_navigation.models import ekf_batch, ekf_slam as ekf

N = 8
B = 16
Q3 = jnp.diag(jnp.array([0.01, 0.01, 0.01], jnp.float64))
R2 = jnp.diag(jnp.array([0.001, 0.001], jnp.float64))


def _states(seed=0, dtype=jnp.float64, n_seen=4):
    """B random dense states (vmapped tree) + the batch-trailing copy."""
    rng = np.random.default_rng(seed)
    cfg = ekf.EKFConfig(num_landmarks=N)
    D = cfg.dim
    means, covs = [], []
    for b in range(B):
        st = ekf.init(cfg, rng.uniform(-1, 1, 3).astype(np.float64))
        mean = np.array(st.mean)
        for j in range(n_seen):
            mean[3 + 2 * j: 5 + 2 * j] = rng.uniform(-2, 2, 2)
        k = 3 + 2 * n_seen
        A = rng.normal(size=(k, k)) * 0.05
        cov = np.array(st.cov)
        cov[:k, :k] = A @ A.T + 0.01 * np.eye(k)
        means.append(mean)
        covs.append(cov)
    vst = ekf.EKFState(
        mean=jnp.asarray(np.stack(means), dtype),
        cov=jnp.asarray(np.stack(covs), dtype),
        n_seen=jnp.full((B,), n_seen, jnp.int32),
        seen=jnp.broadcast_to(jnp.arange(N) < n_seen, (B, N)))
    return cfg, vst, ekf_batch.from_vmapped(vst)


def test_roundtrip_bitwise():
    _, vst, bst = _states()
    back = ekf_batch.to_vmapped(bst)
    for a, b in zip(back, vst):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_predict_parity():
    cfg, vst, bst = _states()
    rng = np.random.default_rng(1)
    tw = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 3)), jnp.float64)
    want = jax.vmap(lambda s, t: ekf.predict(cfg, s, t, Q3))(vst, tw)
    got = ekf_batch.to_vmapped(ekf_batch.predict(cfg, bst, tw, Q3))
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-12)
    np.testing.assert_allclose(got.cov, want.cov, atol=1e-12)


def test_update_parity():
    cfg, vst, bst = _states()
    rng = np.random.default_rng(2)
    j = jnp.asarray(rng.integers(0, 4, B), jnp.int32)
    z = jnp.asarray(rng.uniform([0.3, -2], [1.5, 2], (B, 2)), jnp.float64)
    want = jax.vmap(lambda s, zz, jj: ekf.update(cfg, s, zz, jj, R2))(
        vst, z, j)
    got = ekf_batch.to_vmapped(ekf_batch.update(cfg, bst, z, j, R2))
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-10)
    np.testing.assert_allclose(got.cov, want.cov, atol=1e-10)


def test_associate_parity():
    cfg, vst, bst = _states()
    rng = np.random.default_rng(3)
    z = jnp.asarray(rng.uniform([0.3, -2], [1.5, 2], (B, 2)), jnp.float64)
    want = jax.vmap(lambda s, zz: ekf.associate(cfg, s, zz, R2))(vst, z)
    got = ekf_batch.associate(cfg, bst, z, R2)
    np.testing.assert_array_equal(np.asarray(got.outcome),
                                  np.asarray(want.outcome))
    np.testing.assert_array_equal(np.asarray(got.index),
                                  np.asarray(want.index))
    gd = np.asarray(got.distances.T)
    wd = np.asarray(want.distances)
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-9)


def test_init_cov_parity():
    cfg, vst, bst = _states()
    rng = np.random.default_rng(4)
    j = jnp.full((B,), 5, jnp.int32)      # first unseen slot
    z = jnp.asarray(rng.uniform([0.3, -2], [1.5, 2], (B, 2)), jnp.float64)
    want = jax.vmap(
        lambda s, zz, jj: ekf._analytic_init_cov(
            ekf.init_landmark(cfg, s, zz, jj), zz, jj, R2))(vst, z, j)
    st_init = ekf_batch.init_landmark(cfg, bst, z, j)
    got = jnp.transpose(
        ekf_batch._analytic_init_cov(st_init, z, j, R2), (2, 0, 1))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("known", [True, False])
def test_tick_parity(known):
    cfg, vst, bst = _states()
    rng = np.random.default_rng(5)
    M = 3
    T = 3
    for t in range(T):
        tw = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 3)), jnp.float64)
        zs = jnp.asarray(np.stack(
            [rng.uniform(0.3, 1.2, (B, M)), rng.uniform(-3, 3, (B, M))],
            axis=-1), jnp.float64)
        valid = jnp.asarray(rng.uniform(size=(B, M)) < 0.9)
        if known:
            ids = jnp.asarray(rng.integers(0, N, (B, M)), jnp.int32)
            vst = jax.vmap(
                lambda s, a, b, c, d: ekf.known_association_step(
                    cfg, s, a, b, c, d, Q3, R2))(vst, tw, zs, valid, ids)
            bst = ekf_batch.known_association_step(
                cfg, bst, tw, zs, valid, ids, Q3, R2)
        else:
            vst = jax.vmap(
                lambda s, a, b, c: ekf.step(cfg, s, a, b, c, Q3, R2))(
                vst, tw, zs, valid)
            bst = ekf_batch.step(cfg, bst, tw, zs, valid, Q3, R2)
    got = ekf_batch.to_vmapped(bst)
    np.testing.assert_array_equal(np.asarray(got.n_seen),
                                  np.asarray(vst.n_seen))
    np.testing.assert_array_equal(np.asarray(got.seen), np.asarray(vst.seen))
    np.testing.assert_allclose(got.mean, vst.mean, atol=1e-8)
    np.testing.assert_allclose(got.cov, vst.cov, atol=1e-6)


def test_gated_off_world_stays_finite_f32():
    """A gated-OFF world whose slot is an unseen INT_MAX-prior landmark
    sitting ~on top of the robot produces an f32-OVERFLOWING psi
    (det = inf - inf = NaN) in the unused update branch. The select form
    must discard that junk. (Pin for the fused-gating negative, BENCH_NOTES
    pathology 17: gating the update by MULTIPLICATION propagated the
    NaN*0; the branch-select form is the production lowering.)"""
    cfg = ekf.EKFConfig(num_landmarks=2)
    B = 2
    st = ekf_batch.init(cfg, B, dtype=jnp.float32)
    tw = jnp.zeros((B, 3), jnp.float32)
    zs = jnp.full((B, 1, 2), 0.5, jnp.float32)
    ids = jnp.zeros((B, 1), jnp.int32)
    valid = jnp.array([[True], [False]])      # world 1 fully gated off
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    out = ekf_batch.known_association_step(cfg, st, tw, zs, valid, ids,
                                           Q, R)
    assert np.isfinite(np.asarray(out.mean)).all()
    assert np.isfinite(np.asarray(out.cov)).all()
    assert int(out.n_seen[1]) == 0


@pytest.mark.parametrize("scenario", ["course12_noisy", "loop5_known"])
def test_driver_lanes_matches_vmapped(scenario):
    """End-to-end through the production wiring: run_scenario_batch_lanes
    == run_scenario_batch on the same keys (f64 so association decisions
    cannot flip on layout-order ulps)."""
    from shermbot_navigation.pipeline import driver
    from shermbot_navigation.pipeline.config import get_scenario

    scn = get_scenario(scenario)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    a = driver.run_scenario_batch(scn, keys, 40, jnp.float64)
    b = driver.run_scenario_batch_lanes(scn, keys, 40, jnp.float64)
    np.testing.assert_array_equal(np.asarray(a.n_seen), np.asarray(b.n_seen))
    np.testing.assert_allclose(a.true_pose, b.true_pose, atol=1e-12)
    np.testing.assert_allclose(a.slam_pose, b.slam_pose, atol=1e-8)
    np.testing.assert_allclose(a.nees, b.nees, rtol=1e-5, atol=1e-6)
