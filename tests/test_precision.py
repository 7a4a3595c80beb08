"""Every f32 contraction on the GPU entry points carries a precision.

On a GPU an f32 ``dot_general`` whose precision is DEFAULT runs in TF32
(10 mantissa bits), which the covariance algebra cannot take. The jaxpr is
the same on every backend, so walking it here on the CPU finds each such
product before the card does. Entry points are the paths ``chip_smoke.py``
drives, traced at small shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jex_core
from jax.sharding import NamedSharding

from shermbot_navigation.models.ekf_slam import EKFConfig
from shermbot_navigation.parallel import bigmap, blocked_ekf
from shermbot_navigation.parallel.mesh import make_mesh
from shermbot_navigation.pipeline import driver, serving
from shermbot_navigation.pipeline.config import get_scenario

HIGHEST = jax.lax.Precision.HIGHEST
F32_PRESETS = (jax.lax.DotAlgorithmPreset.F32_F32_F32,)


def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jex_core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex_core.Jaxpr):
                yield x


def _is_full_f32(precision) -> bool:
    if isinstance(precision, jax.lax.DotAlgorithmPreset):
        return precision in F32_PRESETS
    if precision is None:
        return False
    return all(p == HIGHEST for p in precision)


def low_precision_f32_dots(jaxpr) -> list:
    """Every f32 dot_general under ``jaxpr`` (recursing into scans, loops,
    conds, shard_maps and kernels) whose precision is not full f32."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dt = eqn.invars[0].aval.dtype
            if dt == jnp.float32 and not _is_full_f32(
                    eqn.params.get("precision")):
                bad.append(str(eqn.source_info.traceback).splitlines()[-1:]
                           if eqn.source_info.traceback else eqn)
        for sub in _subjaxprs(eqn.params):
            bad.extend(low_precision_f32_dots(sub))
    return bad


def _jaxpr(fn, *args):
    return jax.make_jaxpr(fn)(*args).jaxpr


def _keys(b):
    return jax.random.split(jax.random.PRNGKey(0), b)


def _bigmap_jaxpr(known: bool, grid: bool):
    N, M = 64, 4
    mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, 4, M, jax.random.PRNGKey(0))
    mk = bigmap.make_runner if known else bigmap.make_unknown_runner
    run = mk(cfg, mesh, 1, M, grid_kernel=grid)
    st = blocked_ekf.init(cfg, 1)
    st = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), st,
        blocked_ekf.state_sharding(mesh))
    Q = jnp.eye(3, dtype=jnp.float32) * 1e-4
    R = jnp.eye(2, dtype=jnp.float32) * 1e-3
    return _jaxpr(lambda s: run(s, wl, Q, R, jnp.int32(0), 2), st)


ENTRY_POINTS = {
    "batch_lanes_loop5": lambda: _jaxpr(
        lambda k: driver.run_scenario_batch_lanes(
            get_scenario("loop5_known"), k, 3), _keys(2)),
    "batch_lanes_lidar20": lambda: _jaxpr(
        lambda k: driver.run_scenario_batch_lanes(
            get_scenario("lidar20_full"), k, 3), _keys(2)),
    "run_scenario_course12": lambda: _jaxpr(
        lambda k: driver.run_scenario(get_scenario("course12_noisy"), k),
        jax.random.PRNGKey(0)),
    "run_scenario_lidar20": lambda: _jaxpr(
        lambda k: driver.run_scenario(get_scenario("lidar20_full"), k),
        jax.random.PRNGKey(0)),
    "bigmap_known_xla": lambda: _bigmap_jaxpr(True, False),
    "bigmap_unknown_kernel": lambda: _bigmap_jaxpr(False, True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_f32_dots_pin_precision(name):
    bad = low_precision_f32_dots(ENTRY_POINTS[name]())
    assert not bad, f"{name}: f32 dot_general without HIGHEST at {bad[:5]}"


def test_serving_step_f32_dots_pin_precision():
    cfg = EKFConfig(num_landmarks=64)
    tick = serving.make_serving_step(cfg, 4, known=False, donate=False)
    st = blocked_ekf.init(cfg, 1)
    args = (jnp.zeros(3, jnp.float32), jnp.ones((4, 2), jnp.float32),
            jnp.ones(4, bool), jnp.eye(3, dtype=jnp.float32),
            jnp.eye(2, dtype=jnp.float32))
    assert not low_precision_f32_dots(_jaxpr(tick, st, *args))


def test_megamap_refinement_f32_dots_pin_precision():
    from shermbot_navigation.parallel import megamap, schur_dist

    prob = megamap.synthesize(16, 8, 2)
    mesh = make_mesh(jax.devices()[:1], data=1)
    part = schur_dist.partition_problem(prob.bundle, 1)
    step = schur_dist.make_sharded_gn(mesh, T=8, N=16,
                                      M=part.obs_t.shape[0], cg_iters=4,
                                      gn_steps=1)
    assert not low_precision_f32_dots(_jaxpr(step, part))


def test_walker_flags_a_default_precision_product():
    """The walker itself: a bare f32 ``@`` inside a scan is found, the same
    product at HIGHEST is not, and f64 products are left alone."""
    a = jnp.ones((4, 4), jnp.float32)

    def bare(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=2)[0]

    def pinned(x):
        return jnp.matmul(x, x, precision=HIGHEST)

    assert len(low_precision_f32_dots(_jaxpr(bare, a))) == 1
    assert not low_precision_f32_dots(_jaxpr(pinned, a))
    assert not low_precision_f32_dots(
        _jaxpr(lambda x: x @ x, np.ones((4, 4), np.float64)))
