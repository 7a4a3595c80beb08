"""SE(2) core tests.

Ports the reference unit-test intent (``rigid2d/tests/tests.cpp``) plus
property tests against closed forms. Reference cases covered: constructors,
inverse (:228-239 there: Tab.inv), apply-to-vector, composition, adjoint
twist-frame change, integrateTwist pure-translation / pure-rotation / screw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shermbot_navigation.ops import se2

PI = se2.PI


def T(th, x, y):
    return se2.from_parts(jnp.array([x, y], jnp.float64), jnp.float64(th))


class TestAngles:
    def test_normalize_angle(self):
        for a in [0.0, PI, -PI, 3 * PI, PI / 4, -5 * PI / 2, 7.1, -123.4]:
            got = float(se2.normalize_angle(jnp.float64(a)))
            # idempotent, equivalent, in range
            assert abs(float(se2.normalize_angle(jnp.float64(got))) - got) < 1e-12
            assert abs(np.sin(got) - np.sin(a)) < 1e-9
            assert abs(np.cos(got) - np.cos(a)) < 1e-9
            assert -PI - 1e-12 <= got <= PI + 1e-12

    def test_deg_rad_roundtrip(self):
        assert abs(float(se2.deg2rad(se2.rad2deg(jnp.float64(2.1)))) - 2.1) < 1e-12
        assert abs(float(se2.deg2rad(jnp.float64(180.0))) - PI) < 1e-12


class TestTransform:
    def test_identity(self):
        v = jnp.array([1.5, -2.0], jnp.float64)
        np.testing.assert_allclose(se2.apply(se2.identity(jnp.float64), v), v)

    def test_apply_pure_rotation(self):
        # rotate (1, 0) by 90deg -> (0, 1)
        out = se2.apply(T(PI / 2, 0, 0), jnp.array([1.0, 0.0], jnp.float64))
        np.testing.assert_allclose(out, [0.0, 1.0], atol=1e-12)

    def test_apply_general(self):
        # reference test intent (tests.cpp:142-160): T(90deg, (2,2)) applied
        out = se2.apply(T(PI / 2, 2.0, 2.0), jnp.array([3.0, 3.0], jnp.float64))
        np.testing.assert_allclose(out, [-1.0, 5.0], atol=1e-12)

    def test_inverse(self):
        Tab = T(0.7, 1.2, -3.4)
        eye = se2.compose(Tab, se2.inv(Tab))
        np.testing.assert_allclose(eye, [1.0, 0.0, 0.0, 0.0], atol=1e-12)
        eye2 = se2.compose(se2.inv(Tab), Tab)
        np.testing.assert_allclose(eye2, [1.0, 0.0, 0.0, 0.0], atol=1e-12)

    def test_compose_matches_matrix(self):
        rng = np.random.default_rng(0)
        for _ in range(10):
            th1, x1, y1, th2, x2, y2 = rng.uniform(-3, 3, size=6)
            Tc = se2.compose(T(th1, x1, y1), T(th2, x2, y2))

            def mat(th, x, y):
                return np.array(
                    [[np.cos(th), -np.sin(th), x],
                     [np.sin(th), np.cos(th), y],
                     [0, 0, 1]]
                )

            M = mat(th1, x1, y1) @ mat(th2, x2, y2)
            np.testing.assert_allclose(Tc[0], M[0, 0], atol=1e-12)
            np.testing.assert_allclose(Tc[1], M[1, 0], atol=1e-12)
            np.testing.assert_allclose(Tc[2], M[0, 2], atol=1e-12)
            np.testing.assert_allclose(Tc[3], M[1, 2], atol=1e-12)

    def test_pose_roundtrip(self):
        pose = jnp.array([0.3, 1.0, -2.0], jnp.float64)
        np.testing.assert_allclose(se2.to_pose(se2.from_pose(pose)), pose, atol=1e-12)

    def test_batched(self):
        poses = jnp.array(np.random.default_rng(1).uniform(-2, 2, (16, 3)))
        Ts = se2.from_pose(poses)
        assert Ts.shape == (16, 4)
        vs = jnp.array(np.random.default_rng(2).uniform(-2, 2, (16, 2)))
        out = se2.apply(Ts, vs)
        for i in range(16):
            np.testing.assert_allclose(out[i], se2.apply(Ts[i], vs[i]), atol=1e-12)


class TestAdjoint:
    def test_twist_frame_change(self):
        # reference test intent (tests.cpp:180-198)
        Tab = T(PI / 2, 0.0, 1.0)
        tw = jnp.array([1.0, 1.0, 1.0], jnp.float64)  # [dth, dx, dy]
        out = se2.adjoint_twist(Tab, tw)
        # Vb = [w, vx, vy]; Va = [w, y*w + c*vx - s*vy, -x*w + s*vx + c*vy]
        np.testing.assert_allclose(out, [1.0, 1.0 + 0.0 - 1.0, 0.0 + 1.0 + 0.0],
                                   atol=1e-12)


class TestIntegrateTwist:
    def test_pure_translation(self):
        # ref tests.cpp:200-215
        tw = jnp.array([0.0, 2.0, 3.0], jnp.float64)
        out = se2.integrate_twist(tw)
        np.testing.assert_allclose(out, [1.0, 0.0, 2.0, 3.0], atol=1e-12)

    def test_pure_rotation(self):
        tw = jnp.array([PI / 2, 0.0, 0.0], jnp.float64)
        out = se2.integrate_twist(tw)
        np.testing.assert_allclose(out, [0.0, 1.0, 0.0, 0.0], atol=1e-12)

    def test_screw_matches_reference_construction(self):
        # The reference builds T_bb' = inv(T_sb) * T_ss' * T_sb with the COR
        # at (dy/dth, -dx/dth) (rigid2d.cpp:310-325). Check our closed form
        # against that construction in float64.
        rng = np.random.default_rng(3)
        for _ in range(20):
            dth = rng.uniform(-3, 3)
            dx, dy = rng.uniform(-2, 2, 2)
            if abs(dth) < 1e-3:
                continue
            cor = jnp.array([dy / dth, -dx / dth], jnp.float64)
            T_sb = se2.from_translation(cor)
            T_ss = se2.from_rotation(jnp.float64(dth))
            ref = se2.compose(se2.compose(se2.inv(T_sb), T_ss), T_sb)
            got = se2.integrate_twist(jnp.array([dth, dx, dy], jnp.float64))
            np.testing.assert_allclose(got, ref, atol=1e-10)

    def test_continuity_at_zero(self):
        # branchless formulation must be smooth through dth == 0
        for dth in [0.0, 1e-12, -1e-12, 1e-8, -1e-8, 1e-6]:
            out = se2.integrate_twist(jnp.array([dth, 1.0, 0.5], jnp.float64))
            np.testing.assert_allclose(out[2], 1.0, atol=1e-5)
            np.testing.assert_allclose(out[3], 0.5, atol=1e-5)
            assert np.isfinite(np.asarray(out)).all()

    def test_jit_and_grad(self):
        f = jax.jit(se2.integrate_twist)
        tw = jnp.array([0.1, 1.0, 0.0], jnp.float64)
        np.testing.assert_allclose(f(tw), se2.integrate_twist(tw), atol=1e-12)
        g = jax.jacfwd(se2.integrate_twist)(tw)
        assert np.isfinite(np.asarray(g)).all()
        # gradient finite exactly at dth = 0 too (the where-guard)
        g0 = jax.jacfwd(se2.integrate_twist)(jnp.array([0.0, 1.0, 0.0], jnp.float64))
        assert np.isfinite(np.asarray(g0)).all()
