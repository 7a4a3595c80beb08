"""Multi-chip dry run: compile + execute the full sharded training step on an
n-device mesh with tiny shapes (driver contract: ``dryrun_multichip``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from ..models.ekf_slam import EKFConfig
from . import bigmap, blocked_ekf, mesh as mesh_lib


def run(n_devices: int) -> None:
    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} "
            f"(set XLA_FLAGS=--xla_force_host_platform_device_count={n_devices})")

    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    m = mesh_lib.make_mesh(devices, data=data)
    n_map = m.shape["map"]

    B = 2 * data            # batch sharded over 'data'
    N = 8 * n_map           # landmarks sharded over 'map'
    M = 3                   # measurements per tick
    cfg = EKFConfig(num_landmarks=N)

    step = blocked_ekf.make_sharded_step(cfg, m, B, M)
    state = blocked_ekf.init(cfg, B)
    # place the state according to its shardings
    specs = blocked_ekf.state_sharding(m)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(m, s)), state, specs)

    twist = jnp.broadcast_to(jnp.array([0.02, 0.05, 0.0], jnp.float32), (B, 3))
    zs = jnp.broadcast_to(
        jnp.array([[0.7, 0.1], [0.8, -0.4], [0.6, 1.0]], jnp.float32),
        (B, M, 2))
    valid = jnp.ones((B, M), bool)
    ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (B, M))
    Q = jnp.diag(jnp.array([0.1, 0.1, 0.1], jnp.float32))
    R = jnp.diag(jnp.array([0.001, 0.001], jnp.float32))

    out = step(state, twist, zs, valid, ids, Q, R)
    jax.block_until_ready(out)
    assert int(out.n_seen[0]) == M, f"expected {M} landmarks, {out.n_seen}"
    assert bool(jnp.isfinite(out.mean_r).all())

    # second step: updates against now-seen landmarks (exercises the
    # owner-broadcast + all_gather update path, not just init)
    out2 = step(out, twist, zs, valid, ids, Q, R)
    jax.block_until_ready(out2)
    assert bool(jnp.isfinite(out2.mean_r).all())
    assert bool(jnp.isfinite(out2.cov_rr).all())

    # deferred rank-2M grid update (the production config-4 step)
    dstep = blocked_ekf.make_sharded_deferred_step(cfg, m, B, M)
    outd = dstep(out, twist, zs, valid, ids, Q, R)
    jax.block_until_ready(outd)
    assert bool(jnp.isfinite(outd.mean_r).all())

    # unknown-association sharded tick (pmin first-hit gating)
    ustep = blocked_ekf.make_sharded_unknown_step(cfg, m, B, M)
    out3 = ustep(out2, twist, zs, valid, Q, R)
    jax.block_until_ready(out3)
    assert bool(jnp.isfinite(out3.mean_r).all())

    # deferred step through the FUSED GRID KERNEL: compiled on a GPU,
    # interpreted on the CPU. Needs power-of-two planes of >= 16 rows per
    # shard -> a separate capacity Nk stays tiny.
    interp = not bigmap.kernel_platform(m)
    Nk = 16 * n_map
    while Nk & (Nk - 1):
        Nk *= 2
    kcfg = EKFConfig(num_landmarks=Nk)
    kstep = blocked_ekf.make_sharded_deferred_step(
        kcfg, m, B, M, grid_kernel=True, kernel_interpret=interp)
    kstate = blocked_ekf.init(kcfg, B)
    kstate = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(m, s)), kstate, specs)
    outk = kstep(kstate, twist, zs, valid, ids, Q, R)
    jax.block_until_ready(outk)
    assert int(outk.n_seen[0]) == M
    assert bool(jnp.isfinite(outk.mean_r).all())

    # PP staged pipeline (the reference's tube_world -> landmarks -> slam
    # topic pipeline as a 2-stage 'pp' mesh; unknown_data_assoc.launch:4-21)
    from jax.sharding import Mesh as _Mesh

    import numpy as _np

    from ..pipeline.config import get_scenario
    from ..pipeline.staged import make_staged_rollout

    if len(devices) >= 2:
        pp_mesh = _Mesh(_np.array(devices[:2]), ("pp",))
        scn = get_scenario("loop5_known")
        outs = make_staged_rollout(scn, pp_mesh)(jax.random.PRNGKey(0), 8)
        jax.block_until_ready(outs)
        assert bool(jnp.isfinite(outs.slam_pose).all())
        assert int(outs.n_seen[-1]) > 0

    # config-5 path: pose-graph loop closure + distributed Schur refinement
    from . import megamap
    _, refined = megamap.run_megamap(
        N=4 * n_map, T=8, obs_per_pose=2, mesh=m, pg_iters=2, gn_iters=1,
        cg_iters=8)
    jax.block_until_ready(refined)
    assert bool(jnp.isfinite(refined.poses).all())

    # batch-on-lanes DP engine through the scenario driver (r05 production
    # path for configs 1-3) — incl. the segmented perception stage via the
    # lidar scenario
    from ..pipeline.config import get_scenario as _gs
    from ..pipeline.driver import run_scenario_batch_lanes
    for scn_name in ("loop5_known", "lidar20_full"):
        o = run_scenario_batch_lanes(_gs(scn_name),
                                     jax.random.split(jax.random.PRNGKey(1),
                                                      2), 6)
        jax.block_until_ready(o)
        assert bool(jnp.isfinite(o.slam_pose).all()), scn_name

    # single-robot serving tick (the deferred tick with the grid kernel;
    # pipeline/serving.py)
    from ..pipeline import serving as _srv
    stick = _srv.make_serving_step(kcfg, M, known=True, donate=False,
                                   grid_kernel=True,
                                   kernel_interpret=interp)
    sst = blocked_ekf.init(kcfg, 1)
    sst = stick(sst, twist[0], zs[0], valid[0], ids[0], Q, R)
    jax.block_until_ready(sst)
    assert int(sst.n_seen[0]) == M

    mode = "interpret" if interp else "compiled"
    print(f"dryrun_multichip OK: mesh={dict(m.shape)} B={B} N={N} M={M} "
          f"(blocked known/unknown EKF + deferred grid-kernel[{mode} "
          f"Nk={Nk}] + PP staged pipeline + pose graph + sharded Schur + "
          f"lanes DP engine [loop5+lidar] + serving tick[{mode} kernel])")
