"""EKF filter-consistency tests: NEES and NIS against chi-square bounds.

SURVEY.md section 4 calls for "EKF consistency tests (NEES/NIS) on simulated
rollouts" — something the reference has no analog of (it has zero EKF tests).
The harness simulates a robot whose process/measurement noise EXACTLY matches
the filter's assumed model (additive N(0, Q) on the pose increment, N(0, R)
on range-bearing), so the filter should be statistically consistent:

- mean NEES over the rollout ~= 3   (robot block, 3 dof per step)
- mean NIS  over the rollout ~= 2   (one measurement, 2 dof)

Both are asserted inside bounds for the matched-noise run and OUTSIDE them
for two negative controls (deliberately wrong Q): an overconfident filter
(Q/100 -> errors exceed the covariance, NEES blows up) and an underconfident
one (Q*25 -> covariance too large, NEES collapses). The bounds are wider
than i.i.d. chi-square quantiles because per-step NEES samples are
time-correlated through the filter; calibrated values for this harness are
NEES 2.78 / NIS 1.94 at seed 0.
"""

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.pipeline import metrics

Q_TRUE = np.diag([1e-6, 4e-6, 4e-6])
R_TRUE = np.diag([1e-4, 1e-4])
LMS = np.array([[1.0, 0.3], [0.4, -0.6]])


def run_consistency(T=500, q_scale=1.0, seed=0):
    """Matched-noise rollout; returns (mean NEES, mean NIS)."""
    rng = np.random.default_rng(seed)
    cfg = ekf.EKFConfig(num_landmarks=2, wrap_innovation=True)
    Qf = jnp.asarray(Q_TRUE * q_scale)
    Rf = jnp.asarray(R_TRUE)
    st = ekf.init(cfg, jnp.zeros(3, jnp.float64), dtype=jnp.float64)
    pose = np.zeros(3)
    ids = jnp.array([0, 1], jnp.int32)
    valid = jnp.array([True, True])

    tick = jax.jit(lambda s, tw, zs: ekf.known_association_step(
        cfg, s, tw, zs, valid, ids, Qf, Rf))
    pred = jax.jit(lambda s, tw: ekf.predict(cfg, s, tw, Qf))
    innov = jax.jit(lambda s, z, j: ekf.innovation(cfg, s, z, j, Rf))

    w, v = 0.05, 0.02
    nees_vals, nis_vals = [], []
    for t in range(T):
        th = pose[0]
        inc = np.array([w, -(v / w) * np.sin(th) + (v / w) * np.sin(th + w),
                        (v / w) * np.cos(th) - (v / w) * np.cos(th + w)])
        pose = pose + inc + rng.multivariate_normal(np.zeros(3), Q_TRUE)
        zs = []
        for lm in LMS:
            dx, dy = lm[0] - pose[1], lm[1] - pose[2]
            b = np.arctan2(dy, dx) - pose[0]
            zs.append([np.hypot(dx, dy), np.arctan2(np.sin(b), np.cos(b))])
        zs = np.asarray(zs) + rng.multivariate_normal(
            np.zeros(2), R_TRUE, size=2)
        tw = jnp.array([w, v, 0.0], jnp.float64)

        if t > 1:  # skip the init transient (landmarks not yet converged)
            sp = pred(st, tw)
            dz, psi = innov(sp, jnp.asarray(zs[0]), jnp.int32(0))
            nis_vals.append(float(metrics.nis(dz, psi)))
        st = tick(st, tw, jnp.asarray(zs))
        if t > 1:
            true_pose = jnp.asarray(
                [np.arctan2(np.sin(pose[0]), np.cos(pose[0])),
                 pose[1], pose[2]])
            nees_vals.append(float(metrics.nees(
                st.mean[:3], true_pose, st.cov[:3, :3])))
    return float(np.mean(nees_vals)), float(np.mean(nis_vals))


class TestConsistency:
    def test_matched_noise_is_consistent(self):
        nees_m, nis_m = run_consistency(q_scale=1.0)
        assert 2.0 < nees_m < 4.2, f"mean NEES {nees_m} outside [2.0, 4.2]"
        assert 1.5 < nis_m < 2.6, f"mean NIS {nis_m} outside [1.5, 2.6]"

    def test_overconfident_filter_fails_consistency(self):
        """Negative control: Q/100 — the filter trusts its prediction far
        too much; errors dwarf the covariance and NEES/NIS blow past the
        consistent bounds. Guards against a vacuously-passing NEES."""
        nees_m, nis_m = run_consistency(q_scale=0.01)
        assert nees_m > 10.0, f"overconfident NEES {nees_m} not detected"
        assert nis_m > 2.6, f"overconfident NIS {nis_m} not detected"

    def test_underconfident_filter_fails_consistency(self):
        """Negative control: Q*25 — covariance inflated, NEES collapses
        below the consistent band."""
        nees_m, _ = run_consistency(q_scale=25.0)
        assert nees_m < 1.5, f"underconfident NEES {nees_m} not detected"
