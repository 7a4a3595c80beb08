"""Hand-derived numeric fixtures from the reference's published formulas.

Every other parity test diffs the JAX engine against the C++ host engine —
but the C++ engine is itself this repo's port of the reference math, so those
tests alone can't detect a shared misreading of the reference. The fixtures
here were computed BY HAND from the reference's formulas (exact closed
forms — fractions of small integers and pi), and BOTH engines are checked
against the numbers, anchoring the oracle itself:

- integrateTwist screw cases      (ref rigid2d.cpp:294-328, COR construction)
- EKF predict mean + covariance   (ref slam_library.cpp:71-148)
- measurement model zhat + H      (ref slam_library.cpp:150-186)
- one full Kalman update          (ref slam_library.cpp:263-282)

Single-step fixtures anchor the formulas; multi-step sequencing is pinned by
the engine-vs-engine trajectory parity tests (test_baseline_parity.py).
"""

import jax.numpy as jnp
import numpy as np

from shermbot_navigation.models import ekf_slam as ekf
from shermbot_navigation.native import host
from shermbot_navigation.ops import se2

F64 = jnp.float64
PI = np.pi


class TestIntegrateTwist:
    """ref integrateTwist (rigid2d.cpp:294-328).

    Hand derivation for twist (w, vx, vy): the center of rotation is at
    c = (-vy/w, vx/w) (the point whose rotational velocity cancels the
    linear velocity); the displacement is p' = c + R(w)(-c).
    """

    CASES = [
        # (twist, expected [theta, x, y]) — all hand-derived exact values
        # screw (pi/2, 1, 0): c=(0, 2/pi); p' = (0,2/pi) + R(pi/2)(0,-2/pi)
        #                      = (2/pi, 2/pi)
        ((PI / 2, 1.0, 0.0), (PI / 2, 2 / PI, 2 / PI)),
        # screw (pi, 0, 1):  c=(-1/pi, 0); p' = c + R(pi)(1/pi, 0) = (-2/pi, 0)
        ((PI, 0.0, 1.0), (PI, -2 / PI, 0.0)),
        # pure translation
        ((0.0, 0.3, -0.4), (0.0, 0.3, -0.4)),
        # pure rotation
        ((PI / 3, 0.0, 0.0), (PI / 3, 0.0, 0.0)),
    ]

    def test_jax(self):
        for tw, (th, x, y) in self.CASES:
            T = se2.integrate_twist(jnp.asarray(tw, F64))
            np.testing.assert_allclose(
                np.asarray(T), [np.cos(th), np.sin(th), x, y], atol=1e-12)

    def test_native(self):
        for tw, exp in self.CASES:
            got = host.integrate_twist(*tw)
            np.testing.assert_allclose(got, exp, atol=1e-12)


# ---------------------------------------------------------------------------
# EKF fixtures (n = 1 landmark, dim 5)
# ---------------------------------------------------------------------------

Q001 = np.diag([0.01, 0.01, 0.01])
R001 = np.diag([0.01, 0.01])

# --- predict fixture (ref slam_library.cpp:71-148) -------------------------
# State: th=0, x=y=0, landmark at (2, 3); Sigma = I5; Q = 0.01 I3.
# Twist (dth, dx) = (pi/2, pi/2)  =>  v/w = 1:
#   dq = [pi/2, (sin(pi/2)-sin 0), (cos 0 - cos(pi/2))] = [pi/2, 1, 1]
#   B10 = -(v/w)(cos 0 - cos(pi/2)) = -1;  B20 = (v/w)(sin(pi/2)-sin 0) = 1
# A = I + g e0^T with g = [0,-1,1,0,0];  A I A^T = I + g e0^T + e0 g^T + g g^T:
PREDICT_MEAN = np.array([PI / 2, 1.0, 1.0, 2.0, 3.0])
PREDICT_COV = np.array([
    [1.01, -1.0, 1.0, 0.0, 0.0],
    [-1.0, 2.01, -1.0, 0.0, 0.0],
    [1.0, -1.0, 2.01, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.0],
])

# --- zhat/H fixture (ref slam_library.cpp:150-186) --------------------------
# Robot (0,0,0), landmark (3,4): dx=3, dy=4, d=25, sqrt(d)=5.
ZH_MEAN = np.array([0.0, 0.0, 0.0, 3.0, 4.0])
ZH_ZHAT = np.array([5.0, np.arctan2(4.0, 3.0)])
ZH_H = np.array([
    [0.0, -3 / 5, -4 / 5, 3 / 5, 4 / 5],
    [-1.0, 4 / 25, -3 / 25, -4 / 25, 3 / 25],
])

# --- update fixture (ref slam_library.cpp:263-282) --------------------------
# Robot (0,0,0) with zero robot covariance, landmark 0 at (1, 0) with
# Sigma_mm = 0.04 I2, R = 0.01 I2.  zhat = [1, 0];  H row0 = [0,-1,0,1,0],
# row1 = [-1,0,-1,0,1].  Sigma H^T has single nonzeros 0.04 at (3,0),(4,1);
# psi = 0.05 I2;  K entries = 0.04/0.05 = 0.8 at (3,0),(4,1).
# z = [1.1, 0.1]  =>  dz = [0.1, 0.1]  =>  mean' = [0,0,0, 1.08, 0.08];
# (I-KH)Sigma = diag(0,0,0, 0.2*0.04, 0.2*0.04) = diag(..., 0.008, 0.008).
UPD_MEAN0 = np.array([0.0, 0.0, 0.0, 1.0, 0.0])
UPD_COV0 = np.diag([0.0, 0.0, 0.0, 0.04, 0.04])
UPD_Z = np.array([1.1, 0.1])
UPD_MEAN1 = np.array([0.0, 0.0, 0.0, 1.08, 0.08])
UPD_COV1 = np.diag([0.0, 0.0, 0.0, 0.008, 0.008])


class TestEKFFixturesJAX:
    CFG = ekf.EKFConfig(num_landmarks=1, analytic_init=False,
                        symmetrize=False)

    def _state(self, mean, cov):
        return ekf.EKFState(mean=jnp.asarray(mean, F64),
                            cov=jnp.asarray(cov, F64),
                            n_seen=jnp.int32(1),
                            seen=jnp.ones((1,), bool))

    def test_predict(self):
        st = self._state([0.0, 0.0, 0.0, 2.0, 3.0], np.eye(5))
        out = ekf.predict(self.CFG, st, jnp.asarray([PI / 2, PI / 2, 0], F64),
                          jnp.asarray(Q001, F64))
        np.testing.assert_allclose(out.mean, PREDICT_MEAN, atol=1e-12)
        np.testing.assert_allclose(out.cov, PREDICT_COV, atol=1e-12)

    def test_zhat_h(self):
        st = self._state(ZH_MEAN, np.eye(5))
        z_hat = ekf.predicted_measurement(st, jnp.int32(0))
        np.testing.assert_allclose(z_hat, ZH_ZHAT, atol=1e-12)
        dx, dy, d, sq = ekf._landmark_delta(st.mean, jnp.int32(0))
        H5 = ekf._h5(dx, dy, d, sq)  # compressed on [th, x, y, mx, my]
        np.testing.assert_allclose(H5, ZH_H, atol=1e-12)

    def test_update(self):
        st = self._state(UPD_MEAN0, UPD_COV0)
        out = ekf.update(self.CFG, st, jnp.asarray(UPD_Z, F64), jnp.int32(0),
                         jnp.asarray(R001, F64))
        np.testing.assert_allclose(out.mean, UPD_MEAN1, atol=1e-12)
        np.testing.assert_allclose(out.cov, UPD_COV1, atol=1e-12)


class TestEKFFixturesNative:
    def _ekf(self, mean, cov):
        e = host.NativeEKF(1, Q001, R001)
        e.mean = mean
        e.cov = cov
        e.set_seen(1)
        return e

    def test_predict(self):
        e = self._ekf([0.0, 0.0, 0.0, 2.0, 3.0], np.eye(5))
        e.predict(PI / 2, PI / 2)
        np.testing.assert_allclose(e.mean, PREDICT_MEAN, atol=1e-12)
        np.testing.assert_allclose(e.cov, PREDICT_COV, atol=1e-12)

    def test_zhat_h(self):
        e = self._ekf(ZH_MEAN, np.eye(5))
        z_hat, H = e.zhat_H(0)
        np.testing.assert_allclose(z_hat, ZH_ZHAT, atol=1e-12)
        np.testing.assert_allclose(H, ZH_H, atol=1e-12)

    def test_update(self):
        e = self._ekf(UPD_MEAN0, UPD_COV0)
        e.update(0, *UPD_Z)
        np.testing.assert_allclose(e.mean, UPD_MEAN1, atol=1e-12)
        np.testing.assert_allclose(e.cov, UPD_COV1, atol=1e-12)
