"""Pipeline-parallel staging (SURVEY section 2.5 PP row) vs its sequential
oracle.

The staged program splits the tick across a 2-device 'pp' mesh exactly like
the reference's 3-process topic pipeline (tube_world -> landmarks -> slam,
unknown_data_assoc.launch:4-21), including the pipeline's inherent one-tick
topic latency. Correctness contract: the 2-device staged rollout equals a
single-device sequential program with the same stage bodies and the same
packet delay."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from shermbot_navigation.pipeline import staged
from shermbot_navigation.pipeline.config import get_scenario


@pytest.mark.parametrize("scenario", ["lidar20_full", "loop5_known"])
def test_staged_matches_sequential_oracle(scenario):
    scn = get_scenario(scenario)
    key = jax.random.PRNGKey(3)
    T = 15
    ref = staged.staged_reference(scn, key, T)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    got = staged.make_staged_rollout(scn, mesh)(key, T)

    np.testing.assert_allclose(got.true_pose, ref.true_pose, atol=1e-6)
    np.testing.assert_allclose(got.odom_pose, ref.odom_pose, atol=1e-6)
    np.testing.assert_allclose(got.slam_pose, ref.slam_pose, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.n_seen),
                                  np.asarray(ref.n_seen))


def test_one_tick_topic_latency():
    """The consumer's first tick processes the EMPTY pre-pipeline packet
    (the reference slam node also idles until the first /real_sensor
    message arrives): no landmarks yet, and tick t's output pairs the SLAM
    estimate with the ground truth at packet-production time t-1."""
    scn = get_scenario("loop5_known")
    key = jax.random.PRNGKey(0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    out = staged.make_staged_rollout(scn, mesh)(key, 10)
    assert int(out.n_seen[0]) == 0          # empty packet consumed first
    assert int(out.n_seen[2]) > 0           # pipeline is flowing after that
    # true_pose[0] is the pre-pipeline zero packet's pose
    np.testing.assert_allclose(np.asarray(out.true_pose[0]), 0.0, atol=1e-9)
    # from tick 1 on, outputs carry real (delayed) ground truth
    assert float(jnp.abs(out.true_pose[2]).max()) > 0.0


def test_staged_estimates_track_truth():
    """End-to-end sanity at depth: the staged pipeline's SLAM estimate
    converges on the (delayed) truth like the fused driver does."""
    scn = get_scenario("loop5_known")
    key = jax.random.PRNGKey(1)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    out = staged.make_staged_rollout(scn, mesh)(key, 120)
    err = np.linalg.norm(
        np.asarray(out.slam_pose[20:, 1:]) - np.asarray(out.true_pose[20:, 1:]),
        axis=-1)
    assert np.isfinite(err).all()
    assert err.mean() < 0.25, err.mean()    # slip gauge offset dominates
