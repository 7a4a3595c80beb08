"""Config-4 workload: blocked EKF on a large sharded map (virtual devices)."""

import jax
import jax.numpy as jnp
import numpy as np

from shermbot_navigation.models.ekf_slam import EKFConfig
from shermbot_navigation.parallel import bigmap, mesh as mesh_lib


def test_bigmap_runs_and_converges():
    mesh = mesh_lib.make_mesh(jax.devices()[:4], data=1)
    N, T, M = 64, 16, 4
    state, wl = bigmap.run_bigmap(N=N, T=T, M=M, batch=2, mesh=mesh,
                                  dtype=jnp.float64)
    assert int(state.n_seen[0]) == min(N, T * M)
    assert bool(jnp.isfinite(state.mean_r).all())
    # initialized landmarks should sit near their true positions (noiseless
    # measurements; only linearization error)
    seen = np.asarray(state.seen[0])
    est = np.asarray(state.mean_m[0])[seen]
    true = np.asarray(wl.landmarks)[seen]
    err = np.sqrt(np.mean(np.sum((est - true) ** 2, axis=-1)))
    assert err < 0.05, err


def test_bigmap_shard_invariance():
    """Same workload on 1 vs 4 map shards: identical results."""
    outs = []
    for n_dev in (1, 4):
        mesh = mesh_lib.make_mesh(jax.devices()[:n_dev], data=1)
        state, _ = bigmap.run_bigmap(N=32, T=8, M=4, batch=1, mesh=mesh,
                                     dtype=jnp.float64)
        outs.append(jax.tree_util.tree_map(np.asarray, state))
    a, b = outs
    np.testing.assert_allclose(a.mean_r, b.mean_r, atol=1e-10)
    np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-10)
    np.testing.assert_allclose(a.cov_rm, b.cov_rm, atol=1e-9)
