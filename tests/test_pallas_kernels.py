"""The Triton grid-pass kernel vs its XLA oracle (interpret mode on CPU),
the oracle vs a dense f64 rank-2M reference, and the kernels' routing.
The compiled kernels are checked on the card by ``chip_smoke.py`` and by
the ``gpu``-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shermbot_navigation.ops.pallas.grid_update import (
    fused_grid_update, grid_shapes_supported)
from shermbot_navigation.parallel.blocked_ekf import reference_grid_update


class TestFusedGridUpdate:
    """The deferred grid-pass kernel vs its XLA oracle, including mixed
    init/update op histories (row/col overwrite replay + masked rank-2M)."""

    def _inputs(self, Nl, N, M, seed=0):
        rng = np.random.default_rng(seed)
        cov = rng.normal(size=(2, 2, Nl, N)).astype(np.float32)
        a = rng.normal(size=(2, Nl, 2 * M)).astype(np.float32)
        b = rng.normal(size=(2, 2 * M, N)).astype(np.float32)
        crow = rng.normal(size=(2, 2, M, N)).astype(np.float32)
        ccol = rng.normal(size=(2, 2, Nl, M)).astype(np.float32)
        # last-init op indices: mostly -1 (no init), some rows/cols init'd
        rowt = np.full(Nl, -1, np.int32)
        colt = np.full(N, -1, np.int32)
        rows = rng.choice(Nl, size=max(1, Nl // 4), replace=False)
        rowt[rows] = rng.integers(0, M, rows.size)
        cols = rng.choice(N, size=max(1, N // 4), replace=False)
        colt[cols] = rng.integers(0, M, cols.size)
        return (jnp.asarray(cov), jnp.asarray(a), jnp.asarray(b),
                jnp.asarray(crow), jnp.asarray(ccol),
                jnp.asarray(rowt), jnp.asarray(colt))

    # includes planes of several row and column tiles (TILE_ROWS=16,
    # TILE_COLS=512), M < 8 (K padded to 16) and M = 1
    @pytest.mark.parametrize("Nl,N,M", [(64, 64, 4), (32, 128, 8),
                                        (16, 32, 3), (128, 256, 1),
                                        (32, 32, 16), (64, 1024, 5),
                                        (16, 2048, 8), (256, 512, 2)])
    def test_matches_reference(self, Nl, N, M):
        args = self._inputs(Nl, N, M)
        got = fused_grid_update(*args, interpret=True)
        want = reference_grid_update(*args)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_no_ops_is_pure_subtract(self):
        args = self._inputs(64, 64, 4, seed=3)
        cov, a, b, crow, ccol, _, _ = args
        rowt = jnp.full((64,), -1, jnp.int32)
        colt = jnp.full((64,), -1, jnp.int32)
        got = fused_grid_update(cov, a, b, crow, ccol, rowt, colt,
                                interpret=True)
        want = cov - jnp.einsum("pnk,rkm->prnm", a, b,
                                precision=jax.lax.Precision.HIGHEST)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("Nl,N", [(48, 64), (64, 96), (8, 64)])
    def test_unsupported_planes_raise(self, Nl, N):
        """Non-power-of-two or sub-16 planes are refused, never padded or
        sent elsewhere silently."""
        assert not grid_shapes_supported(Nl, N)
        with pytest.raises(ValueError, match="power-of-two"):
            fused_grid_update(*self._inputs(Nl, N, 2), interpret=True)


class TestBatchedAndShardedGridKernel:
    """The grid kernel under vmap (several robots per 'data' shard) and
    under shard_map with the map split (the kernel per map shard, as the
    multi-device dry run compiles it on GPUs) equals the XLA schedule."""

    @pytest.mark.parametrize("B,data,map_", [(2, 1, 1), (1, 1, 2),
                                             (2, 2, 2)])
    def test_matches_xla(self, B, data, map_):
        from jax.sharding import NamedSharding
        from shermbot_navigation.models import ekf_slam as ekf
        from shermbot_navigation.parallel import (
            blocked_ekf, mesh as mesh_lib)

        N, M, T = 64, 3, 2
        dtype = jnp.float32
        cfg = ekf.EKFConfig(num_landmarks=N)
        Q = jnp.diag(jnp.array([1e-4] * 3, dtype))
        R = jnp.diag(jnp.array([1e-3] * 2, dtype))
        rng = np.random.default_rng(11)
        tw = jnp.asarray(rng.uniform(-0.05, 0.05, (T, B, 3)), dtype)
        zs = jnp.asarray(np.stack([rng.uniform(0.3, 1.0, (T, B, M)),
                                   rng.uniform(-3, 3, (T, B, M))], -1), dtype)
        valid = jnp.ones((B, M), bool)
        ids = jnp.asarray([[[(t * M + k) % N for k in range(M)]] * B
                           for t in range(T)], jnp.int32)
        mesh = mesh_lib.make_mesh(jax.devices()[:data * map_], data=data)
        specs = blocked_ekf.state_sharding(mesh)
        outs = []
        for kw in ({}, {"grid_kernel": True, "kernel_interpret": True}):
            step = blocked_ekf.make_sharded_deferred_step(cfg, mesh, B, M,
                                                          **kw)
            st = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                blocked_ekf.init(cfg, B, dtype=dtype), specs)
            for t in range(T):
                st = step(st, tw[t], zs[t], valid, ids[t], Q, R)
            outs.append(jax.tree_util.tree_map(np.asarray, st))
        a, b = outs
        np.testing.assert_array_equal(a.n_seen, b.n_seen)
        np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-6)
        np.testing.assert_allclose(a.cov_mm, b.cov_mm, atol=1e-5)


class TestGridKernelLowering:
    """The Triton lowering of the grid kernel (never run by the
    interpreter), checked on the CPU by lowering for 'cuda'."""

    @pytest.mark.parametrize("Nl,N,M", [(64, 64, 4), (16, 2048, 8),
                                        (2048, 2048, 8)])
    def test_lowers_for_cuda(self, Nl, N, M):
        f32 = jnp.float32
        args = (jnp.zeros((2, 2, Nl, N), f32), jnp.zeros((2, Nl, 2 * M), f32),
                jnp.zeros((2, 2 * M, N), f32), jnp.zeros((2, 2, M, N), f32),
                jnp.zeros((2, 2, Nl, M), f32), jnp.zeros(Nl, jnp.int32),
                jnp.zeros(N, jnp.int32))
        text = jax.jit(fused_grid_update).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "grid_update" in text


class TestReferenceGridUpdate:
    """``reference_grid_update`` (the XLA schedule on CPU and multi-shard
    meshes) against a dense f64 oracle: replay the tick's ops in order on
    the full (2Nl, 2N) block — init row/column overwrites, last op wins —
    and subtract each LATER update's rank-2 outer product."""

    @pytest.mark.parametrize("Nl,N,M,seed", [(8, 8, 3, 0), (6, 10, 4, 1)])
    def test_matches_dense_f64_replay(self, Nl, N, M, seed):
        rng = np.random.default_rng(seed)
        cov = rng.normal(size=(2, 2, Nl, N))
        K = rng.normal(size=(M, 2, 2, Nl))     # K[i, p, c, n]
        HS = rng.normal(size=(M, 2, 2, N))     # HS[i, r, c, m]
        cross = rng.normal(size=(M, 2, 2, N))  # init strip comps
        kinds = rng.choice([1, 2], size=M)     # 1 update, 2 init
        slots = rng.choice(min(Nl, N), size=M, replace=False)
        # dense oracle, op by op
        dense = cov.copy()
        for i in range(M):
            if kinds[i] == 2:
                g = slots[i]
                dense[:, :, g, :] = cross[i]                 # row g
                dense[:, :, :, g] = np.transpose(
                    cross[i][:, :, :Nl], (1, 0, 2))          # column g
                dense[:, :, g, g] = cross[i][:, :, g]
            else:
                dense -= np.einsum("pcn,rcm->prnm", K[i], HS[i])
        # the deferred form's operands
        iota = np.arange(M)
        is_init = kinds == 2
        rowt = np.array([max([i for i in range(M) if is_init[i]
                              and slots[i] == n], default=-1)
                         for n in range(Nl)], np.int32)
        colt = np.array([max([i for i in range(M) if is_init[i]
                              and slots[i] == m], default=-1)
                         for m in range(N)], np.int32)
        upd = (kinds == 1)[:, None]
        Kmask = K.reshape(M, 4, Nl) * (upd & (iota[:, None] > rowt[None]))[
            :, None, :]
        HSmask = HS.reshape(M, 4, N) * (upd & (iota[:, None] > colt[None]))[
            :, None, :]
        A = np.transpose(Kmask.reshape(M, 2, 2, Nl),
                         (1, 3, 0, 2)).reshape(2, Nl, 2 * M)
        B = np.transpose(HSmask.reshape(M, 2, 2, N),
                         (1, 0, 2, 3)).reshape(2, 2 * M, N)
        crow = np.transpose(cross, (1, 2, 0, 3))             # (2,2,M,N)
        ccol = np.transpose(cross[:, :, :, :Nl], (2, 1, 3, 0))
        got = reference_grid_update(
            jnp.asarray(cov), jnp.asarray(A), jnp.asarray(B),
            jnp.asarray(crow), jnp.asarray(ccol), jnp.asarray(rowt),
            jnp.asarray(colt))
        np.testing.assert_allclose(np.asarray(got), dense, atol=1e-12)


class TestDeferredGridKernelPath:
    """The deferred sharded step with grid_kernel=True (interpret mode)
    equals the XLA deferred step at f32 — the production config-4 path."""

    def test_known_association_end_to_end(self):
        from shermbot_navigation.models import ekf_slam as ekf
        from shermbot_navigation.parallel import (
            blocked_ekf, mesh as mesh_lib)
        from jax.sharding import NamedSharding

        N, M, B = 64, 4, 1
        dtype = jnp.float32
        cfg = ekf.EKFConfig(num_landmarks=N)
        Q = jnp.diag(jnp.array([1e-4] * 3, dtype))
        R = jnp.diag(jnp.array([1e-3] * 2, dtype))
        rng = np.random.default_rng(7)
        T = 3
        twists = jnp.asarray(rng.uniform(-0.05, 0.05, (B, T, 3)), dtype)
        zs = jnp.asarray(
            np.stack([rng.uniform(0.3, 1.0, (B, T, M)),
                      rng.uniform(-3, 3, (B, T, M))], axis=-1), dtype)
        valid = jnp.ones((B, T, M), bool)
        ids = np.zeros((B, T, M), np.int32)
        for t in range(T):
            for k in range(M):
                ids[:, t, k] = (t * M + k) % (T * M)
        ids = jnp.asarray(ids)

        mesh = mesh_lib.make_mesh(jax.devices()[:1], data=1)
        results = []
        for kw in ({}, {"grid_kernel": True, "kernel_interpret": True}):
            step = blocked_ekf.make_sharded_deferred_step(
                cfg, mesh, B, M, **kw)
            bst = blocked_ekf.init(cfg, B, dtype=dtype)
            specs = blocked_ekf.state_sharding(mesh)
            bst = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                bst, specs)
            for t in range(T):
                bst = step(bst, twists[:, t], zs[:, t], valid[:, t],
                           ids[:, t], Q, R)
            results.append(jax.tree_util.tree_map(np.asarray, bst))
        a, b = results
        np.testing.assert_array_equal(a.n_seen, b.n_seen)
        np.testing.assert_allclose(a.mean_r, b.mean_r, atol=1e-6)
        np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-6)
        # grids differ only by the matmul accumulation order
        np.testing.assert_allclose(a.cov_mm, b.cov_mm, atol=1e-4)




class _StubMesh:
    """Just enough of a ``Mesh`` for the routing functions: its devices'
    platform and its axis sizes."""

    def __init__(self, platform, data=1, map_=1):
        dev = type("Dev", (), {"platform": platform})()
        self.devices = np.array([dev], dtype=object)
        self.shape = {"data": data, "map": map_}


class TestKernelRouting:
    """``bigmap._resolve_*``: kernels on a GPU for the shapes they take, the
    XLA schedule on the CPU, an error on a platform the code does not
    know; an explicit request is passed through unchanged."""

    @pytest.mark.parametrize("platform,want", [("gpu", True),
                                               ("cpu", False)])
    def test_kernel_platform(self, platform, want):
        from shermbot_navigation.parallel import bigmap
        assert bigmap.kernel_platform(_StubMesh(platform)) is want

    @pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
    def test_unknown_platform_raises(self, platform):
        from shermbot_navigation.models.ekf_slam import EKFConfig
        from shermbot_navigation.parallel import bigmap
        mesh = _StubMesh(platform)
        with pytest.raises(ValueError, match="no kernel routing"):
            bigmap._resolve_grid_kernel(None, EKFConfig(num_landmarks=2048),
                                        mesh, jnp.float32)

    @pytest.mark.parametrize("N,map_,dtype,want", [
        (8192, 1, jnp.float32, True),
        (16384, 1, jnp.float32, True),
        (2048, 1, jnp.float32, False),      # below GRID_KERNEL_MIN_N
        (10000, 1, jnp.float32, False),     # not a power of two
        (8192, 2, jnp.float32, False),      # multi-shard: XLA schedule
        (8192, 1, jnp.float64, False),      # f64: XLA schedule
    ])
    def test_grid_auto_route_on_gpu(self, N, map_, dtype, want):
        from shermbot_navigation.models.ekf_slam import EKFConfig
        from shermbot_navigation.parallel import bigmap
        got = bigmap._resolve_grid_kernel(
            None, EKFConfig(num_landmarks=N), _StubMesh("gpu", map_=map_),
            dtype)
        assert got is want

    def test_cpu_auto_routes_xla_and_explicit_passes_through(self):
        from shermbot_navigation.models.ekf_slam import EKFConfig
        from shermbot_navigation.parallel import bigmap
        cfg = EKFConfig(num_landmarks=2048)
        cpu = _StubMesh("cpu")
        assert bigmap._resolve_grid_kernel(None, cfg, cpu, jnp.float32) \
            is False
        assert bigmap._resolve_grid_kernel(True, cfg, cpu, jnp.float32)
        assert not bigmap._resolve_grid_kernel(False, cfg, _StubMesh("gpu"),
                                               jnp.float32)

    def test_kernel_on_unsupported_map_raises(self):
        """Asking for a kernel on a map it does not take is an error in
        the step builder, not a quiet switch to the XLA schedule."""
        from shermbot_navigation.models.ekf_slam import EKFConfig
        from shermbot_navigation.parallel import blocked_ekf
        from shermbot_navigation.parallel import mesh as mesh_lib
        mesh = mesh_lib.make_mesh(jax.devices()[:1], data=1)
        cfg = EKFConfig(num_landmarks=48)
        with pytest.raises(ValueError, match="grid_kernel"):
            blocked_ekf.make_sharded_deferred_step(cfg, mesh, 1, 4,
                                                   grid_kernel=True)
        with pytest.raises(ValueError, match="grid_kernel"):
            blocked_ekf.make_sharded_deferred_unknown_step(
                cfg, mesh, 1, 4, grid_kernel=True)


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu_device):
    """On the card: the compiled Triton grid kernel against the XLA
    schedule through the config-4 runners (both association modes)."""
    from jax.sharding import NamedSharding
    from shermbot_navigation.models.ekf_slam import EKFConfig
    from shermbot_navigation.parallel import bigmap, blocked_ekf
    from shermbot_navigation.parallel.mesh import make_mesh

    N, M, T = 256, 8, 8
    mesh = make_mesh([gpu_device], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0))
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    specs = blocked_ekf.state_sharding(mesh)
    for maker in (bigmap.make_runner, bigmap.make_unknown_runner):
        outs = []
        for kern in (False, True):
            st = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                blocked_ekf.init(cfg, 1), specs)
            run = maker(cfg, mesh, 1, M, grid_kernel=kern)
            outs.append(run(st, wl, Q, R, jnp.int32(0), T))
        a, b = outs
        np.testing.assert_array_equal(np.asarray(a.n_seen),
                                      np.asarray(b.n_seen))
        np.testing.assert_allclose(a.mean_m, b.mean_m, atol=1e-4)
        np.testing.assert_allclose(a.cov_mm, b.cov_mm, atol=1e-4)
