#!/usr/bin/env python
"""Config-4 benchmark: blocked-covariance EKF ticks/s at N=2048 landmarks
(single device; the same program shards over a multi-device 'map' axis).

The C++ reference comparison point is its dense O(D^3) algebra: one
predict at D = 3+2N costs ~2*D^3 flops there, versus O(D) for the blocked
strip update here; an update costs O(D^3) there versus O(D^2) rank-2 here.
Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel import bigmap, blocked_ekf
    from shermbot_navigation.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding

    N = int(os.environ.get("BIGMAP_N", "2048"))
    unknown = bool(int(os.environ.get("BIGMAP_UNKNOWN", "0")))
    M = 8
    T = 50
    mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0))
    deferred = not bool(int(os.environ.get("BIGMAP_SEQUENTIAL", "0")))
    # grid kernel: unset -> auto (Pallas fused grid pass on a GPU); 0/1 force
    gk_env = os.environ.get("BIGMAP_GRID_KERNEL", "")
    grid_kernel = None if gk_env == "" else bool(int(gk_env))
    runner = (bigmap.make_unknown_runner if unknown
              else bigmap.make_runner)(cfg, mesh, 1, M, deferred=deferred,
                                       grid_kernel=grid_kernel)
    state = blocked_ekf.init(cfg, 1)
    specs = blocked_ekf.state_sharding(mesh)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))

    out = runner(state, wl, Q, R, jnp.int32(0), T)      # compile + warmup
    jax.block_until_ready(out)
    t0 = time.time()
    out = runner(out, wl, Q, R, jnp.int32(T), T)
    jax.block_until_ready(out)
    dt = time.time() - t0
    # per-tick work: 1 predict + M updates on a (3+2N)^2 covariance
    D = 3 + 2 * N
    bytes_per_update = 2 * 4 * D * D                   # read + write Sigma_mm
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "blocked_ekf_ticks_per_sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "association": "unknown" if unknown else "known",
        "step": "deferred" if deferred else "sequential",
        "grid_kernel": bigmap._resolve_grid_kernel(
            grid_kernel, cfg, mesh, jnp.float32) if deferred else False,
        "value": round(T / dt, 2),
        "unit": "ticks/s",
        "N_landmarks": N,
        "updates_per_sec": round(T * M / dt, 1),
        "effective_update_bw_GBps": round(
            T * M * bytes_per_update / dt / 1e9, 1),
        "seconds": round(dt, 3),
    }))


if __name__ == "__main__":
    main()
