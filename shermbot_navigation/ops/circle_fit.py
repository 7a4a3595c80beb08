"""Hyperaccurate algebraic circle fit (Al-Sharadqah & Chernov), batched.

JAX re-design of the reference ``circleFit``
(``nuslam/src/circle_fit_library.cpp:15-134``). The per-cluster math is
identical; the implementation is batched over a padded cluster set and uses
the 4x4 moment matrix ``M = Z^T Z`` instead of an SVD of the (n x 4) data
matrix — ``M``'s eigendecomposition gives exactly the reference's ``V`` and
``s^2``, and zero-padded rows contribute nothing to ``M``, so padding is
free. Everything runs as one vmapped ``eigh`` chain on fixed shapes.

Algorithm (per cluster of n points):

1. centroid shift (ref :19-32), ``z_i = x_i^2 + y_i^2``, ``Z = [z, x, y, 1]``
   (ref :37-47);
2. constraint matrix ``H`` / analytic ``H^{-1}`` from ``z_bar`` (ref :50-61);
3. if the smallest singular value of Z < 1e-12: ``A`` = corresponding right
   singular vector (ref :78-80);
4. else ``Y = V S V^T``, ``Q = Y H^{-1} Y``, ``A* `` = eigenvector of the
   smallest *positive* eigenvalue of ``Q``, ``A = Y^{-1} A*`` (ref :81-104);
5. center ``(a, b) = (-A1, -A2) / (2 A0)`` + centroid,
   ``R^2 = (A1^2 + A2^2 - 4 A0 A3) / (4 A0^2)`` (ref :107-110).

Degenerate clusters (n < 4) are invalid — the reference's economy SVD
returns < 4 singular values there and it bails with the ``id = -1`` sentinel
(ref :70-76).

Golden fixtures from the reference tests (``nuslam/tests/circle_tests.cpp``):
6-point set -> center (4.615482, 2.807354) radius 2.413788;
4-point set -> center (0.4908357, -22.15212) radius 11.08989.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .clustering import Clusters
from .smallalg import eigh4_jacobi, eigh4_jacobi_c, solve4, solve4_c

# pin full-f32 matmuls (a GPU runs f32 products in TF32 by default; the
# moment matrix and Y-chain are too ill-conditioned for its 10-bit mantissa)
PRECISION = jax.lax.Precision.HIGHEST


class CircleFits(NamedTuple):
    center: jnp.ndarray  # (C, 2) fitted centers (same frame as the points)
    radius: jnp.ndarray  # (C,) fitted radii
    valid: jnp.ndarray   # (C,) fit is well-defined (>= 4 points, finite)


def _moments_one(pts, count):
    """Masked centroid + 4x4 moment matrix for one padded cluster — the
    data-touching front end (ref :19-47)."""
    dt = pts.dtype
    P = pts.shape[0]
    mask = (jnp.arange(P) < count)
    n = jnp.maximum(count, 1).astype(dt)
    w = mask.astype(dt)

    # centroid shift (ref :19-32)
    cx = jnp.sum(pts[:, 0] * w) / n
    cy = jnp.sum(pts[:, 1] * w) / n
    x = (pts[:, 0] - cx) * w
    y = (pts[:, 1] - cy) * w

    z = x * x + y * y
    z_bar = jnp.sum(z) / n

    # moment matrix M = Z^T Z with Z = [z, x, y, 1] on valid rows (ref :37-47)
    Z = jnp.stack([z, x, y, w], axis=-1)  # (P, 4); masked rows are all-zero
    M = jnp.matmul(Z.T, Z, precision=PRECISION)
    return M, jnp.stack([cx, cy]), z_bar


def _fit_tail(M, centroid, z_bar, count, valid):
    """The eigen-chain on a 4x4 moment matrix (ref :50-110) — tiny,
    compute-bound, shared by the XLA and Pallas front ends."""
    dt = M.dtype
    cx, cy = centroid[0], centroid[1]

    # H^{-1} (ref :55-61)
    Hinv = jnp.array(
        [[0.0, 0.0, 0.0, 0.5],
         [0.0, 1.0, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.5, 0.0, 0.0, 0.0]], dt)
    Hinv = Hinv.at[3, 3].set(-2.0 * z_bar)

    # eigendecomposition of M = V s^2 V^T  (same V as the SVD of Z).
    # Closed-form Jacobi (ops/smallalg.py) instead of jnp.linalg.eigh on
    # 4x4s inside the per-tick perception loop (a solver call per fit).
    lam, V = eigh4_jacobi(M)              # ascending
    lam = jnp.maximum(lam, 0.0)
    s = jnp.sqrt(lam)
    sigma4 = s[0]

    # branch a: rank-deficient -> null vector (ref :78-80)
    A_null = V[:, 0]

    # branch b: Y = V S V^T, Q = Y Hinv Y (ref :81-104)
    Y = jnp.matmul(V * s[None, :], V.T, precision=PRECISION)
    Q = jnp.matmul(jnp.matmul(Y, Hinv, precision=PRECISION), Y,
                   precision=PRECISION)
    eq, EV = eigh4_jacobi(Q)              # ascending
    pos = eq > 0
    # smallest positive eigenvalue; reference default index 0 if none positive
    big = jnp.where(pos, eq, jnp.inf)
    k = jnp.where(jnp.any(pos), jnp.argmin(big), 0)
    # one-hot matvec, not EV[:, k] (vmapped gather — pathology 15 family)
    Astar = jnp.matmul(EV, (jnp.arange(4) == k).astype(dt),
                       precision=PRECISION)
    # A = solve(Y, Astar); guard the solve for the untaken branch
    Ysafe = Y + (sigma4 < 1e-12) * jnp.eye(4, dtype=dt)
    A_gen = solve4(Ysafe, Astar)

    A = jnp.where(sigma4 < 1e-12, A_null, A_gen)

    # circle parameters (ref :107-110)
    A0 = jnp.where(jnp.abs(A[0]) < 1e-30, 1e-30, A[0])
    a = -A[1] / (2.0 * A0)
    b = -A[2] / (2.0 * A0)
    R2 = (A[1] ** 2 + A[2] ** 2 - 4.0 * A[0] * A[3]) / (4.0 * A0 * A0)
    radius = jnp.sqrt(jnp.maximum(R2, 0.0))

    center = jnp.stack([a + cx, b + cy])
    ok = valid & (count >= 4) & jnp.all(jnp.isfinite(center)) & jnp.isfinite(radius)
    return center, radius, ok


def _fit_tail_c(mc, cx, cy, z_bar, count, valid):
    """Fully-componentized eigen-chain (ref :50-110): ``mc`` is a length-16
    list of batched moment components (row-major). The r04 rewrite
    componentized the Jacobi BODY but the chain around it still ran
    (..., 4, 4) matmuls/einsums (Y, Q, the sort one-hots, solve4 slices)
    — each a tiny batched product with 4x4 trailing dims; this form
    materializes NO 4x4 tensor anywhere.
    """
    dt = mc[0].dtype
    lam, V = eigh4_jacobi_c(mc)                   # lists; lam ascending
    lam = [jnp.maximum(l, 0.0) for l in lam]
    s = [jnp.sqrt(l) for l in lam]
    sigma4 = s[0]

    # branch a: rank-deficient -> null vector (ref :78-80)
    A_null = [V[i][0] for i in range(4)]

    # branch b: Y = V S V^T (symmetric — 10 unique comps, mirrored)
    Y = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Y[i][j] = Y[j][i] = sum(V[i][k] * s[k] * V[j][k]
                                    for k in range(4))
    # Y Hinv with the closed-form Hinv (0.5 anti-diag corners, identity
    # middle, -2 z_bar at [3,3]) — ref :55-61
    YH = [[0.5 * Y[i][3], Y[i][1], Y[i][2],
           0.5 * Y[i][0] - 2.0 * z_bar * Y[i][3]] for i in range(4)]
    # Q = (Y Hinv) Y, symmetric
    Q = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Q[i][j] = Q[j][i] = sum(YH[i][k] * Y[k][j] for k in range(4))

    eq, EV = eigh4_jacobi_c([Q[i][j] for i in range(4) for j in range(4)])
    # smallest POSITIVE eigenvalue; default column 0 if none positive
    # (ref :81-104) — running component argmin, strict < keeps the first
    inf = jnp.asarray(jnp.inf, dt)
    big = [jnp.where(e > 0, e, inf) for e in eq]
    best = big[0]
    Astar = [EV[i][0] for i in range(4)]
    for k in (1, 2, 3):
        take = big[k] < best
        best = jnp.where(take, big[k], best)
        Astar = [jnp.where(take, EV[i][k], Astar[i]) for i in range(4)]

    # A = solve(Y, Astar); guard the solve for the untaken branch
    bump = (sigma4 < 1e-12).astype(dt)
    Ysafe = [[Y[i][j] + bump * (1.0 if i == j else 0.0) for j in range(4)]
             for i in range(4)]
    A_gen = solve4_c(Ysafe, Astar)

    rank_def = sigma4 < 1e-12
    A = [jnp.where(rank_def, A_null[i], A_gen[i]) for i in range(4)]

    # circle parameters (ref :107-110)
    A0 = jnp.where(jnp.abs(A[0]) < 1e-30, 1e-30, A[0])
    a = -A[1] / (2.0 * A0)
    b = -A[2] / (2.0 * A0)
    R2 = (A[1] ** 2 + A[2] ** 2 - 4.0 * A[0] * A[3]) / (4.0 * A0 * A0)
    radius = jnp.sqrt(jnp.maximum(R2, 0.0))

    ccx = a + cx
    ccy = b + cy
    ok = (valid & (count >= 4) & jnp.isfinite(ccx) & jnp.isfinite(ccy)
          & jnp.isfinite(radius))
    return jnp.stack([ccx, ccy], axis=-1), radius, ok


def _moments_comps(points, counts):
    """Batched masked moments as 16 flat components + centroid + z_bar —
    the XLA front end for the componentized tail (no (C, 4, 4) tensor).
    points (C, P, 2), counts (C,)."""
    C, P, _ = points.shape
    dt = points.dtype
    mask = jnp.arange(P)[None, :] < jnp.asarray(counts)[:, None]
    w = mask.astype(dt)
    n = jnp.maximum(jnp.asarray(counts, dt), 1.0)
    cx = jnp.sum(points[..., 0] * w, axis=1) / n
    cy = jnp.sum(points[..., 1] * w, axis=1) / n
    x = (points[..., 0] - cx[:, None]) * w
    y = (points[..., 1] - cy[:, None]) * w
    z = x * x + y * y
    s = lambda a: jnp.sum(a, axis=1)
    szz, szx, szy, sz = s(z * z), s(z * x), s(z * y), s(z)
    sxx, sxy, sx = s(x * x), s(x * y), s(x)
    syy, sy, sn = s(y * y), s(y), s(w)
    mc = [szz, szx, szy, sz,
          szx, sxx, sxy, sx,
          szy, sxy, syy, sy,
          sz, sx, sy, sn]
    return mc, cx, cy, sz / n


def _fit_one(pts, count, valid):
    """Fit one padded cluster: pts (P, 2), count scalar."""
    M, centroid, z_bar = _moments_one(pts, count)
    return _fit_tail(M, centroid, z_bar, count, valid)


def fit_circles(clusters: Clusters,
                componentized: bool | None = None) -> CircleFits:
    """Batched circle fit over all cluster slots.

    The data-touching front end (masked centroid + moment matrices) and the
    eigen-chain run FULLY COMPONENTIZED by default (``componentized=None``
    -> True): no (C, 4, 4) tensor is materialized anywhere, so XLA fuses
    the whole fit into elementwise passes over the cluster axis.
    ``componentized=False`` keeps the tensor-form tail (the A/B oracle)."""
    comp = True if componentized is None else componentized
    if comp:
        mc, cx, cy, zbar = _moments_comps(clusters.points, clusters.counts)
        center, radius, ok = _fit_tail_c(mc, cx, cy, zbar,
                                         clusters.counts, clusters.valid)
        return CircleFits(center=center, radius=radius, valid=ok)
    M, cent, zbar = jax.vmap(_moments_one)(clusters.points, clusters.counts)
    center, radius, ok = jax.vmap(_fit_tail)(
        M, cent, zbar, clusters.counts, clusters.valid)
    return CircleFits(center=center, radius=radius, valid=ok)


def fit_points(points) -> tuple:
    """Convenience: fit a single unpadded (n, 2) point set; returns
    ((cx, cy), radius). Used by the golden-vector tests."""
    pts = jnp.asarray(points)
    n = pts.shape[0]
    center, radius, ok = _fit_one(pts, jnp.int32(n), jnp.bool_(True))
    return center, radius
