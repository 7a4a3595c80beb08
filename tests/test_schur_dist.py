"""Distributed Schur refinement vs the single-device implementation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from shermbot_navigation.models import schur
from shermbot_navigation.parallel import mesh as mesh_lib
from shermbot_navigation.parallel import schur_dist

from test_refinement import TestSchur as _Base


def _make_problem():
    helper = _Base()
    return helper._problem(T=24, N=16, dtype=jnp.float64, seed=7)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_matches_single(n_shards):
    prob, truth, lms = _make_problem()
    # single-device oracle
    single = schur.gauss_newton_step(prob, damping=1e-6, cg_iters=80)

    part = schur_dist.partition_problem(prob, n_shards)
    mesh = mesh_lib.make_mesh(jax.devices()[:n_shards], data=1, map_=n_shards)
    step = schur_dist.make_sharded_gn(
        mesh, T=part.poses.shape[0], N=part.landmarks.shape[0],
        M=part.obs_t.shape[0], cg_iters=80, damping=1e-6)
    out = step(part)

    np.testing.assert_allclose(out.poses, single.poses, atol=1e-8)
    np.testing.assert_allclose(out.landmarks, single.landmarks, atol=1e-8)


def test_sharded_reduces_error():
    prob, truth, lms = _make_problem()
    n_shards = 4
    part = schur_dist.partition_problem(prob, n_shards)
    mesh = mesh_lib.make_mesh(jax.devices()[:n_shards], data=1, map_=n_shards)
    step = schur_dist.make_sharded_gn(
        mesh, T=part.poses.shape[0], N=part.landmarks.shape[0],
        M=part.obs_t.shape[0], cg_iters=80)
    out = part
    for _ in range(6):
        out = step(out)
    e0 = np.sqrt(np.mean(np.sum(
        (np.asarray(prob.poses[:, 1:] - truth[:, 1:])) ** 2, -1)))
    e1 = np.sqrt(np.mean(np.sum(
        (np.asarray(out.poses[:, 1:] - truth[:, 1:])) ** 2, -1)))
    assert e1 < e0 * 0.5
    lm_err = np.sqrt(np.mean(np.sum(
        (np.asarray(out.landmarks - lms)) ** 2, -1)))
    assert lm_err < 0.01


def test_gauge_anchor_holds_exactly():
    """Regression: the gauge anchor enters H only (zero residual at every
    linearization point), so without explicit gauge projection the solution
    drifts along the near-free global-rotation mode over GN steps — at
    50k-landmark scale that drift cost ~0.5 m ATE. With gauge projection
    pose 0 must be restored bitwise after EVERY step."""
    prob, truth, lms = _make_problem()
    part = schur_dist.partition_problem(prob, 2)
    mesh = mesh_lib.make_mesh(jax.devices()[:2], data=1, map_=2)
    step = schur_dist.make_sharded_gn(
        mesh, T=part.poses.shape[0], N=part.landmarks.shape[0],
        M=part.obs_t.shape[0], cg_iters=40)
    p0 = np.asarray(part.poses[0])
    out = part
    for _ in range(4):
        out = step(out)
        np.testing.assert_allclose(np.asarray(out.poses[0]), p0,
                                   rtol=0, atol=1e-12)
