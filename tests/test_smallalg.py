"""Closed-form small-matrix algebra vs numpy/LAPACK oracles."""

import jax.numpy as jnp
import numpy as np

from shermbot_navigation.ops import smallalg


def rand_spd(rng, n, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)


class TestSolves:
    def test_inv2(self):
        rng = np.random.default_rng(0)
        M = rand_spd(rng, 2, (32,))
        got = np.asarray(smallalg.inv2(jnp.asarray(M)))
        np.testing.assert_allclose(got, np.linalg.inv(M), rtol=1e-9,
                                   atol=1e-10)

    def test_solve3(self):
        rng = np.random.default_rng(1)
        M = rng.normal(size=(32, 3, 3)) + 2 * np.eye(3)
        v = rng.normal(size=(32, 3))
        got = np.asarray(smallalg.solve3(jnp.asarray(M), jnp.asarray(v)))
        want = np.linalg.solve(M, v[..., None])[..., 0]
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)

    def test_solve4(self):
        rng = np.random.default_rng(2)
        M = rng.normal(size=(32, 4, 4)) + 2 * np.eye(4)
        v = rng.normal(size=(32, 4))
        got = np.asarray(smallalg.solve4(jnp.asarray(M), jnp.asarray(v)))
        want = np.linalg.solve(M, v[..., None])[..., 0]
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)


class TestEigh4:
    def test_matches_lapack(self):
        rng = np.random.default_rng(3)
        M = rand_spd(rng, 4, (16,))
        lam, V = smallalg.eigh4_jacobi(jnp.asarray(M))
        lam_np, V_np = np.linalg.eigh(M)
        np.testing.assert_allclose(np.asarray(lam), lam_np, rtol=1e-8,
                                   atol=1e-9)
        # eigenvectors up to sign: check M V = V diag(lam)
        MV = np.einsum("bij,bjk->bik", M, np.asarray(V))
        VL = np.asarray(V) * np.asarray(lam)[:, None, :]
        np.testing.assert_allclose(MV, VL, rtol=1e-7, atol=1e-8)

    def test_near_degenerate(self):
        # repeated eigenvalues and near-rank-deficiency
        M = np.diag([1.0, 1.0, 1e-9, 2.0])
        lam, V = smallalg.eigh4_jacobi(jnp.asarray(M))
        np.testing.assert_allclose(np.sort(np.asarray(lam)),
                                   [1e-9, 1.0, 1.0, 2.0], atol=1e-10)
        MV = M @ np.asarray(V)
        VL = np.asarray(V) * np.asarray(lam)[None, :]
        np.testing.assert_allclose(MV, VL, atol=1e-9)
