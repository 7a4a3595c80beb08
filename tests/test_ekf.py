"""EKF-SLAM core tests.

The reference has NO tests for its EKF (SURVEY.md section 4), so the pyramid
here is: (a) the structure-exploiting O(D^2) covariance path vs a literal
dense O(D^3) oracle that mirrors the reference math line-for-line;
(b) association first-hit semantics (SURVEY.md section 2.4); (c) filter
consistency (landmark converges, covariance contracts) on a simulated loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.ops import se2

CFG64 = ekf.EKFConfig(num_landmarks=6, analytic_init=False, symmetrize=False)
Q3 = jnp.diag(jnp.array([0.1, 0.1, 0.1], jnp.float64))   # ref slam_params.yaml
R2 = jnp.diag(jnp.array([0.001, 0.001], jnp.float64))


def mkstate(cfg=CFG64, pose=(0.1, 0.5, -0.2), n_seen=3, seed=0,
            dtype=jnp.float64):
    """A state with `n_seen` initialized landmarks and a realistic covariance."""
    rng = np.random.default_rng(seed)
    st = ekf.init(cfg, jnp.array(pose, dtype), dtype=dtype)
    D = cfg.dim
    mean = np.array(st.mean)
    for j in range(n_seen):
        mean[3 + 2 * j: 5 + 2 * j] = rng.uniform(-2, 2, 2)
    # realistic SPD covariance on the seen block, huge prior elsewhere
    k = 3 + 2 * n_seen
    Amat = rng.normal(size=(k, k)) * 0.05
    spd = Amat @ Amat.T + 0.01 * np.eye(k)
    cov = np.array(st.cov)
    cov[:k, :k] = spd
    return ekf.EKFState(
        mean=jnp.asarray(mean, dtype), cov=jnp.asarray(cov, dtype),
        n_seen=jnp.int32(n_seen),
        seen=jnp.arange(cfg.num_landmarks) < n_seen)


class TestPredict:
    def test_sparse_matches_dense(self):
        st = mkstate()
        tw = jnp.array([0.05, 0.1, 0.0], jnp.float64)
        a = ekf.predict(CFG64, st, tw, Q3)
        b = ekf.predict_dense(CFG64, st, tw, Q3)
        np.testing.assert_allclose(a.mean, b.mean, atol=1e-12)
        np.testing.assert_allclose(a.cov, b.cov, rtol=1e-12, atol=1e-9)

    def test_sparse_matches_dense_zero_omega(self):
        st = mkstate()
        tw = jnp.array([0.0, 0.1, 0.0], jnp.float64)
        a = ekf.predict(CFG64, st, tw, Q3)
        b = ekf.predict_dense(CFG64, st, tw, Q3)
        np.testing.assert_allclose(a.cov, b.cov, rtol=1e-12, atol=1e-9)
        # straight-line motion model: dx = v cos(th), dy = v sin(th)
        th = float(st.mean[0])
        np.testing.assert_allclose(
            a.mean[1] - st.mean[1], 0.1 * np.cos(th), atol=1e-12)

    def test_motion_continuity_near_zero_omega(self):
        st = mkstate()
        a = ekf.predict(CFG64, st, jnp.array([1e-9, 0.1, 0.0], jnp.float64), Q3)
        b = ekf.predict(CFG64, st, jnp.array([0.0, 0.1, 0.0], jnp.float64), Q3)
        np.testing.assert_allclose(a.mean, b.mean, atol=1e-9)

    def test_arc_model_matches_reference_formula(self):
        # ref predictEstimate (slam_library.cpp:84-88):
        # dx = -(v/w) sin(th) + (v/w) sin(th+w), dy = (v/w) cos(th) - (v/w) cos(th+w)
        st = mkstate()
        th = float(st.mean[0])
        v, w = 0.13, 0.4
        a = ekf.predict(CFG64, st, jnp.array([w, v, 0.0], jnp.float64), Q3)
        np.testing.assert_allclose(float(a.mean[0] - st.mean[0]), w, atol=1e-12)
        np.testing.assert_allclose(
            float(a.mean[1] - st.mean[1]),
            -(v / w) * np.sin(th) + (v / w) * np.sin(th + w), atol=1e-12)
        np.testing.assert_allclose(
            float(a.mean[2] - st.mean[2]),
            (v / w) * np.cos(th) - (v / w) * np.cos(th + w), atol=1e-12)


class TestUpdate:
    def test_sparse_matches_dense(self):
        st = mkstate()
        for j in range(3):
            z = ekf.predicted_measurement(st, jnp.int32(j))
            z = z + jnp.array([0.01, -0.02], jnp.float64)
            a = ekf.update(CFG64, st, z, jnp.int32(j), R2)
            b = ekf.update_dense(CFG64, st, z, jnp.int32(j), R2)
            np.testing.assert_allclose(a.mean, b.mean, atol=1e-10)
            np.testing.assert_allclose(a.cov, b.cov, rtol=1e-9, atol=1e-9)

    def test_perfect_measurement_no_mean_shift(self):
        st = mkstate()
        z = ekf.predicted_measurement(st, jnp.int32(1))
        a = ekf.update(CFG64, st, z, jnp.int32(1), R2)
        np.testing.assert_allclose(a.mean, st.mean, atol=1e-9)

    def test_covariance_contracts(self):
        st = mkstate()
        z = ekf.predicted_measurement(st, jnp.int32(0))
        a = ekf.update(CFG64, st, z, jnp.int32(0), R2)
        k = 3 + 2 * 3
        assert float(jnp.trace(a.cov[:k, :k])) < float(jnp.trace(st.cov[:k, :k]))

    def test_theta_normalized(self):
        st = mkstate(pose=(3.1, 0.0, 0.0))
        z = ekf.predicted_measurement(st, jnp.int32(0)) + jnp.array(
            [0.0, 0.5], jnp.float64)
        a = ekf.update(CFG64, st, z, jnp.int32(0), R2)
        assert -np.pi <= float(a.mean[0]) <= np.pi


class TestAnalyticInit:
    def test_matches_infinite_prior_limit(self):
        """Analytic first-observation covariance == INT_MAX-prior + update,
        in float64 where the huge prior is still numerically survivable."""
        cfg_ref = ekf.EKFConfig(num_landmarks=6, analytic_init=False,
                                symmetrize=False, init_cov=1e10)
        cfg_ana = ekf.EKFConfig(num_landmarks=6, analytic_init=True,
                                symmetrize=False, init_cov=1e10)
        st = mkstate(cfg_ref, n_seen=2)
        z = jnp.array([0.8, 0.3], jnp.float64)
        j = jnp.int32(2)

        # reference path: write mean, run update against the huge prior
        ref = ekf.init_landmark(cfg_ref, st, z, j)
        ref = ref._replace(n_seen=jnp.int32(3), seen=ref.seen.at[2].set(True))
        ref = ekf.update(cfg_ref, ref, z, j, R2)

        # analytic path: write mean + analytic covariance (the measurement is
        # already folded in — no extra update, see step_measurement)
        ana = ekf.init_landmark(cfg_ana, st, z, j)
        ana = ana._replace(cov=ekf._analytic_init_cov(ana, z, j, R2),
                           n_seen=jnp.int32(3), seen=ana.seen.at[2].set(True))

        np.testing.assert_allclose(ana.mean, ref.mean, atol=1e-6)
        k = 3 + 2 * 3
        np.testing.assert_allclose(ana.cov[:k, :k], ref.cov[:k, :k],
                                   rtol=1e-4, atol=1e-6)


class TestMaskArithInit:
    def test_masked_write_matches_slice_write_bitwise(self):
        """The small-D mask-arithmetic covariance overwrite (r04 — no
        scatters, no selects, no convs) must equal plain slice writes
        BITWISE: every written entry is a product with exact 1.0/0.0,
        every untouched entry is cov * 1.0 * 1.0. Sweep all slots."""
        cfg = ekf.EKFConfig(num_landmarks=6)
        st = mkstate(cfg, n_seen=4)
        z = jnp.array([0.8, 0.3], st.mean.dtype)
        for jj in range(6):
            j = jnp.int32(jj)
            got = ekf._analytic_init_cov(st, z, j, R2)
            # slice-write oracle with the same cross/block ingredients
            mean, cov = st.mean, st.cov
            a = z[1] + mean[0]
            r = z[0]
            Gx = jnp.stack(
                [jnp.stack([-r * jnp.sin(a), jnp.ones_like(r),
                            jnp.zeros_like(r)]),
                 jnp.stack([r * jnp.cos(a), jnp.zeros_like(r),
                            jnp.ones_like(r)])])
            Gz = jnp.stack(
                [jnp.stack([jnp.cos(a), -r * jnp.sin(a)]),
                 jnp.stack([jnp.sin(a), r * jnp.cos(a)])])
            P = ekf.PRECISION
            R_ = jnp.asarray(R2, cov.dtype)
            cross = jnp.matmul(Gx, cov[:3, :], precision=P)
            block = (jnp.matmul(jnp.matmul(Gx, cov[:3, :3], precision=P),
                                Gx.T, precision=P)
                     + jnp.matmul(jnp.matmul(Gz, R_, precision=P), Gz.T,
                                  precision=P))
            idx = 3 + 2 * jj
            want = np.array(cov)
            want[idx:idx + 2, :] = np.asarray(cross)
            want[:, idx:idx + 2] = np.asarray(cross).T
            want[idx:idx + 2, idx:idx + 2] = np.asarray(block)
            np.testing.assert_array_equal(np.asarray(got), want)


class TestAssociate:
    def test_empty_map_new(self):
        st = mkstate(n_seen=0)
        res = ekf.associate(CFG64, st, jnp.array([1.0, 0.0], jnp.float64), R2)
        assert int(res.outcome) == ekf.ASSOC_NEW
        assert int(res.index) == 0

    def test_match_existing(self):
        st = mkstate(n_seen=3)
        z = ekf.predicted_measurement(st, jnp.int32(1))
        res = ekf.associate(CFG64, st, z, R2)
        assert int(res.outcome) == ekf.ASSOC_MATCH
        assert int(res.index) == 1

    def test_gray_area_skips(self):
        """Deterministic gray-zone fixture: the Mahalanobis distance is
        exactly quadratic in a range-only perturbation (psi depends only on
        the state), so probing with a unit perturbation and rescaling lands
        the distance at exactly 1.0 — provably inside (0.01, 60)."""
        st = mkstate(n_seen=3)
        z0 = ekf.predicted_measurement(st, jnp.int32(0))
        probe = z0 + jnp.array([1.0, 0.0], jnp.float64)
        d_unit = float(ekf.associate(CFG64, st, probe, R2).distances[0])
        alpha = np.sqrt(1.0 / d_unit)
        z = z0 + jnp.array([alpha, 0.0], jnp.float64)
        res = ekf.associate(CFG64, st, z, R2)
        d0 = float(res.distances[0])
        assert 0.01 < d0 < 60.0, f"fixture missed the gray zone: d0={d0}"
        np.testing.assert_allclose(d0, 1.0, rtol=1e-9)
        assert int(res.outcome) == ekf.ASSOC_SKIP

    def test_far_measurement_new(self):
        st = mkstate(n_seen=3)
        z = jnp.array([50.0, 1.0], jnp.float64)  # far from everything
        res = ekf.associate(CFG64, st, z, R2)
        assert int(res.outcome) == ekf.ASSOC_NEW
        assert int(res.index) == 3

    def test_first_hit_order(self):
        """Landmark 0 provably in the gray zone while landmark 1 matches
        exactly: first-hit semantics must SKIP (lm0 is scanned first), even
        though nearest-neighbor gating would match lm1."""
        st = mkstate(n_seen=3)

        def fixture(delta):
            # lm1 at lm0 + delta*[1,0]; z exact for lm1 -> d1 == 0
            mean = np.asarray(st.mean).copy()
            mean[5:7] = mean[3:5] + np.array([delta, 0.0])
            st2 = st._replace(mean=jnp.asarray(mean))
            z = ekf.predicted_measurement(st2, jnp.int32(1))
            return st2, z, float(ekf.associate(CFG64, st2, z, R2).distances[0])

        # d0 ~ delta^2 for small offsets; a few rescales land d0 at ~1.0.
        delta = 0.05
        for _ in range(3):
            _, _, d0 = fixture(delta)
            delta *= np.sqrt(1.0 / d0)
        st2, z, d0 = fixture(delta)
        res = ekf.associate(CFG64, st2, z, R2)
        d = np.asarray(res.distances)
        assert 0.01 < d[0] < 60.0, f"fixture missed the gray zone: {d[0]}"
        assert d[1] < 0.01                         # lm1 would match...
        assert int(res.outcome) == ekf.ASSOC_SKIP  # ...but lm0 hits first

        # contrast: nearest-neighbor quality mode matches lm1
        cfg_nn = dataclasses.replace(CFG64, assoc_mode="nearest")
        res_nn = ekf.associate(cfg_nn, st2, z, R2)
        assert int(res_nn.outcome) == ekf.ASSOC_MATCH
        assert int(res_nn.index) == 1

    def test_singular_psi_yields_finite_distances(self):
        """A singular psi at a seen slot must NOT produce NaN distances
        (advisor r04: the componentized Mahalanobis divided by the raw
        determinant; 0/0 NaN poisons min/argmin in nearest mode and
        suppresses real matches at other slots). Degenerate fixture: zero
        covariance + zero R makes every psi exactly singular."""
        for mode in ("first_hit", "nearest"):
            cfg = dataclasses.replace(CFG64, assoc_mode=mode)
            st = mkstate(n_seen=3)
            st = st._replace(cov=jnp.zeros_like(st.cov))
            z = ekf.predicted_measurement(st, jnp.int32(1))
            res = ekf.associate(cfg, st, z, 0.0 * R2)
            d = np.asarray(res.distances)
            assert np.isfinite(d[:3]).all(), d
            assert int(res.outcome) != ekf.ASSOC_NEW  # match not suppressed

    def test_overflow(self):
        cfg = ekf.EKFConfig(num_landmarks=3, analytic_init=False,
                            symmetrize=False)
        st = mkstate(cfg, n_seen=3)
        z = jnp.array([50.0, 1.0], jnp.float64)
        res = ekf.associate(cfg, st, z, R2)
        assert int(res.outcome) == ekf.ASSOC_OVERFLOW


class TestStep:
    def test_full_tick_runs_and_is_finite(self):
        cfg = ekf.EKFConfig(num_landmarks=6)
        st = ekf.init(cfg, jnp.zeros(3, jnp.float64), dtype=jnp.float64)
        zs = jnp.array([[0.7, 0.5], [0.9, -1.0], [0.0, 0.0]], jnp.float64)
        valid = jnp.array([True, True, False])
        tw = jnp.array([0.02, 0.05, 0.0], jnp.float64)
        step = jax.jit(lambda s: ekf.step(cfg, s, tw, zs, valid, Q3, R2))
        st2 = step(st)
        assert int(st2.n_seen) == 2
        assert np.isfinite(np.asarray(st2.mean)).all()
        k = 3 + 2 * 2
        assert np.isfinite(np.asarray(st2.cov[:k, :k])).all()

    def test_known_assoc_capacity_guard(self):
        """An id at/beyond capacity stops the tick — later measurements in
        the same tick are dropped, like the reference's break
        (slam.cpp:301-316; engine.cpp:590). Over-provision: capacity 2,
        three measurement slots with ids [0, 2, 1]."""
        cfg = ekf.EKFConfig(num_landmarks=2)
        st = ekf.init(cfg, jnp.zeros(3, jnp.float64), dtype=jnp.float64)
        zs = jnp.array([[0.7, 0.5], [0.9, -1.0], [0.8, 0.2]], jnp.float64)
        valid = jnp.array([True, True, True])
        ids = jnp.array([0, 2, 1], jnp.int32)
        tw = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        st2 = ekf.known_association_step(cfg, st, tw, zs, valid, ids, Q3, R2)
        # id 0 processed; id 2 overflows and stops the tick; id 1 dropped
        assert int(st2.n_seen) == 1
        assert bool(st2.seen[0]) and not bool(st2.seen[1])
        # without the overflow id in between, all in-capacity ids process
        ids_ok = jnp.array([0, 1, 2], jnp.int32)
        st3 = ekf.known_association_step(cfg, st, tw, zs, valid, ids_ok, Q3,
                                         R2)
        assert int(st3.n_seen) == 2

    def test_known_assoc_negative_id_is_noop(self):
        """A NEGATIVE id must be a plain no-op like the blocked engine
        (blocked_ekf: ``v & (j >= 0) & (j < N)``) and the seq-scan kernel —
        NOT a masked write at idx = 3+2j = 1 overwriting the robot x/y
        lanes, and NOT a sticky stop (advisor r04)."""
        cfg = ekf.EKFConfig(num_landmarks=2)
        pose = jnp.array([0.1, 0.5, -0.2], jnp.float64)
        st = ekf.init(cfg, pose, dtype=jnp.float64)
        zs = jnp.array([[0.7, 0.5], [0.9, -1.0]], jnp.float64)
        valid = jnp.array([True, True])
        ids = jnp.array([-1, 0], jnp.int32)
        tw = jnp.zeros(3, jnp.float64)
        st2 = ekf.known_association_step(cfg, st, tw, zs, valid, ids,
                                         0.0 * Q3, R2)
        # id -1 ignored entirely; id 0 still processed (no sticky stop)
        assert int(st2.n_seen) == 1
        assert bool(st2.seen[0]) and not bool(st2.seen[1])
        # robot x/y untouched by the bad id (twist 0, Q 0, and the one
        # landmark init does not move the robot)
        np.testing.assert_allclose(np.asarray(st2.mean[1:3]),
                                   np.asarray(pose[1:3]), atol=1e-12)

    def test_landmark_convergence_known_assoc(self):
        """Drive a circle past two landmarks with noiseless measurements:
        estimated landmarks must converge to the truth."""
        cfg = ekf.EKFConfig(num_landmarks=4)
        dt64 = jnp.float64
        st = ekf.init(cfg, jnp.zeros(3, dt64), dtype=dt64)
        lms = np.array([[1.0, 0.3], [0.4, -0.6]])
        qs = jnp.diag(jnp.array([1e-4, 1e-4, 1e-4], dt64))
        rs = jnp.diag(jnp.array([1e-4, 1e-4], dt64))

        step = jax.jit(
            lambda s, tw, zs, ids: ekf.known_association_step(
                cfg, s, tw, zs, jnp.array([True, True]), ids, qs, rs))

        pose = np.zeros(3)  # [th, x, y]
        for t in range(200):
            w, v = 0.02, 0.01
            th = pose[0]
            pose = pose + np.array(
                [w, -(v / w) * np.sin(th) + (v / w) * np.sin(th + w),
                 (v / w) * np.cos(th) - (v / w) * np.cos(th + w)])
            zs, ids = [], []
            for j, lm in enumerate(lms):
                dx, dy = lm[0] - pose[1], lm[1] - pose[2]
                rng_ = np.hypot(dx, dy)
                brg = np.arctan2(dy, dx) - pose[0]
                brg = np.arctan2(np.sin(brg), np.cos(brg))
                zs.append([rng_, brg])
                ids.append(j)
            st = step(st, jnp.array([w, v, 0.0], dt64),
                      jnp.array(zs, dt64), jnp.array(ids, jnp.int32))

        est = np.asarray(st.mean[3:7]).reshape(2, 2)
        np.testing.assert_allclose(est, lms, atol=2e-2)
        # robot pose close to truth (heading compared with wrapping — the
        # filter normalizes theta into (-pi, pi], the sim accumulates raw)
        np.testing.assert_allclose(np.asarray(st.mean[1:3]), pose[1:], atol=2e-2)
        dth = float(st.mean[0]) - pose[0]
        assert abs(np.arctan2(np.sin(dth), np.cos(dth))) < 2e-2
