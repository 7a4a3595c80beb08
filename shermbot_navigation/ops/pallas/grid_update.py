"""Deferred rank-2M landmark-grid pass as ONE fused Pallas kernel (Triton).

This is the op that dominates config-4 runtime (the blocked EKF's only
O(N^2) state is the landmark grid; reference analog: the dense
``(I - K H) Sigma`` of slam_library.cpp:263-282 executed M times per tick).
The deferred step (parallel/blocked_ekf.py) reduces M grid passes to one:

    grid' = replay_overwrites(grid, init ops) - Kmask @ HSmask^T

where the replay applies each tick-buffered landmark-init's row/column
overwrite in op order (last writer wins) and the masked rank-2M term
subtracts every *later* Kalman update's outer product.

The grid is stored as four COMPONENT PLANES ``(2, 2, Nl, N)`` —
``plane[p, q, n, m] = Sigma[(landmark n, comp p), (landmark m, comp q)]``.
Per plane (p, r) the pass is

    base = replay(cov[p, r])            # row/col overwrites, last-op wins
    out[p, r] = base - A[p] @ B[r]      # (Nl, 2M) x (2M, N)

with A[p][n, 2i+c] = masked-gain comps and B[r][2i+c, m] = masked H-Sigma
comps. The XLA schedule (``blocked_ekf.reference_grid_update``) is free to
materialise the replayed base before the product; this kernel reads each
plane tile once and writes it once, the 16*N^2-byte floor.

Hopper layout: every (plane p, plane r, row tile, column tile) is an
independent Triton program; tiles are powers of two sized for registers.
The product runs with ``precision=HIGHEST``, which the Triton lowering maps
to IEEE f32 (not TF32). Triton's dot needs every operand dimension >= 16,
so the wrapper zero-pads the contraction K = 2M to a power of two >= 16;
the zero columns add nothing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PREC = jax.lax.Precision.HIGHEST

# Tile and launch shape: the fastest of a sweep on an H100 at N=8192 and
# 16384 (PERF.md). Rows are the 16 Triton's dot needs at least.
TILE_ROWS = 16
TILE_COLS = 512
NUM_WARPS = 4


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def grid_shapes_supported(n_local: int, n: int) -> bool:
    """Routing gate: power-of-two plane shapes of at least one tile of 16
    (the smallest block Triton's dot takes), so every tile is full."""
    return _is_pow2(n_local) and _is_pow2(n) and min(n_local, n) >= 16


def _make_kernel(M: int):
    def kernel(cov_ref, a_ref, b_ref, crow_ref, ccol_ref, rowt_ref,
               colt_ref, out_ref):
        base = cov_ref[...]                                    # (TR, TC)
        rt = rowt_ref[...]                                     # (TR, 1)
        ct = colt_ref[...]                                     # (1, TC)
        for i in range(M):
            # column overwrite first, then row: ops replay in ascending
            # order so the LAST init touching an entry wins, and at an op's
            # own (slot, slot) block the row pass lands the exact B_own
            # (the column pass would land its 1-ulp transpose)
            base = jnp.where(ct == i, ccol_ref[:, i:i + 1], base)
            base = jnp.where(rt == i, crow_ref[i:i + 1, :], base)
        out_ref[...] = base - jnp.dot(
            a_ref[...], b_ref[...], preferred_element_type=jnp.float32,
            precision=PREC)
    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def fused_grid_update(cov, a, b, crow, ccol, rowt, colt,
                      interpret: bool = False):
    """One fused pass: replay init overwrites, subtract the rank-2M term.

    cov  (2, 2, Nl, N) f32  local grid rows, component planes
    a    (2, Nl, 2M)        row-masked Kalman gain comps (A[p])
    b    (2, 2M, N)         col-masked H-Sigma comps (B[r])
    crow (2, 2, M, N)       gathered init cross strips, comps [p*2+r]
                            (row overwrite values)
    ccol (2, 2, Nl, M)      local init cross columns, comps [r*2+p]
                            (column overwrite values, landmark-major)
    rowt (Nl,) int32        per-row last-init op index (-1 = none)
    colt (N,)  int32        per-column last-init op index

    Exact-arithmetic-equal to ``blocked_ekf.reference_grid_update``; in f32
    only the product's accumulation order differs. Needs
    :func:`grid_shapes_supported` plane shapes.
    """
    _, _, NL, N = cov.shape
    M = crow.shape[2]
    if not grid_shapes_supported(NL, N):
        raise ValueError(f"grid kernel wants power-of-two planes >= 16, "
                         f"got ({NL}, {N})")
    # pad the op axis to a power of two and K = 2*Mp to >= 16 (zeros: the
    # replay never selects a padded op and the product adds nothing)
    Mp = max(8, _pow2_ceil(M))
    if Mp != M:
        a = jnp.pad(a, ((0, 0), (0, 0), (0, 2 * (Mp - M))))
        b = jnp.pad(b, ((0, 0), (0, 2 * (Mp - M)), (0, 0)))
        crow = jnp.pad(crow, ((0, 0), (0, 0), (0, Mp - M), (0, 0)))
        ccol = jnp.pad(ccol, ((0, 0), (0, 0), (0, 0), (0, Mp - M)))
    K = 2 * Mp
    TR = min(NL, TILE_ROWS)
    TC = min(N, TILE_COLS)
    grid = (2, 2, NL // TR, N // TC)

    return pl.pallas_call(
        _make_kernel(M),
        grid=grid,
        in_specs=[
            pl.BlockSpec((None, None, TR, TC),
                         lambda p, r, i, j: (p, r, i, j)),     # cov tile
            pl.BlockSpec((None, TR, K), lambda p, r, i, j: (p, i, 0)),
            pl.BlockSpec((None, K, TC), lambda p, r, i, j: (r, 0, j)),
            pl.BlockSpec((None, None, Mp, TC),
                         lambda p, r, i, j: (p, r, 0, j)),     # crow comps
            pl.BlockSpec((None, None, TR, Mp),
                         lambda p, r, i, j: (p, r, i, 0)),     # ccol comps
            pl.BlockSpec((TR, 1), lambda p, r, i, j: (i, 0)),  # rowT
            pl.BlockSpec((1, TC), lambda p, r, i, j: (0, j)),  # colT
        ],
        out_specs=pl.BlockSpec((None, None, TR, TC),
                               lambda p, r, i, j: (p, r, i, j)),
        out_shape=jax.ShapeDtypeStruct(cov.shape, cov.dtype),
        input_output_aliases={0: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="grid_update",
    )(cov, a, b, crow, ccol, rowt.reshape(NL, 1), colt.reshape(1, N))
