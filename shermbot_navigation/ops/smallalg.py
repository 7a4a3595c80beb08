"""Closed-form small-matrix algebra for accelerator hot loops.

``jnp.linalg.solve``/``eigh`` on tiny systems lower to solver library
calls or LAPACK-style loops, one per scan iteration, where the closed form
is a handful of fused elementwise ops. Every small dense solve in a hot
path must use these instead; ``jnp.linalg`` is reserved for host-side /
one-shot code.

All functions broadcast over leading batch dims and are branchless.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A GPU runs f32 matmuls/einsums in TF32 by default; the Jacobi rotation
# chain loses orthogonality at 10 mantissa bits. Pin full f32.
PRECISION = jax.lax.Precision.HIGHEST


def inv2(M, eps: float = 1e-30):
    """Closed-form 2x2 inverse (batched)."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < eps, jnp.full_like(det, eps), det)
    out = jnp.stack([
        jnp.stack([d, -b], axis=-1),
        jnp.stack([-c, a], axis=-1)], axis=-2)
    return out / det[..., None, None]


def solve3(M, v, eps: float = 1e-30):
    """Closed-form 3x3 solve via the adjugate (batched): ``M x = v``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < eps, jnp.full_like(det, eps), det)
    x0 = A * v[..., 0] + B * v[..., 1] + C * v[..., 2]
    x1 = D * v[..., 0] + E * v[..., 1] + F * v[..., 2]
    x2 = G * v[..., 0] + H * v[..., 1] + I * v[..., 2]
    return jnp.stack([x0, x1, x2], axis=-1) / det[..., None]


def solve4(M, v, eps: float = 1e-30):
    """4x4 solve by cofactor expansion of the inverse (batched).

    Direct adjugate of a 4x4: 16 cofactors, each a 3x3 determinant built
    from the 18 distinct 2x2 minors — ~100 fused multiply-adds, entirely
    VPU-friendly.
    """
    m = M
    # 2x2 minors of rows (2,3)
    s0 = m[..., 2, 0] * m[..., 3, 1] - m[..., 2, 1] * m[..., 3, 0]
    s1 = m[..., 2, 0] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 0]
    s2 = m[..., 2, 0] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 0]
    s3 = m[..., 2, 1] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 1]
    s4 = m[..., 2, 1] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 1]
    s5 = m[..., 2, 2] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 2]
    # 2x2 minors of rows (0,1)
    c0 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    c1 = m[..., 0, 0] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 0]
    c2 = m[..., 0, 0] * m[..., 1, 3] - m[..., 0, 3] * m[..., 1, 0]
    c3 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c4 = m[..., 0, 1] * m[..., 1, 3] - m[..., 0, 3] * m[..., 1, 1]
    c5 = m[..., 0, 2] * m[..., 1, 3] - m[..., 0, 3] * m[..., 1, 2]

    det = c0 * s5 - c1 * s4 + c2 * s3 + c3 * s2 - c4 * s1 + c5 * s0
    det = jnp.where(jnp.abs(det) < eps, jnp.full_like(det, eps), det)

    inv = jnp.stack([
        jnp.stack([
            m[..., 1, 1] * s5 - m[..., 1, 2] * s4 + m[..., 1, 3] * s3,
            -m[..., 0, 1] * s5 + m[..., 0, 2] * s4 - m[..., 0, 3] * s3,
            m[..., 3, 1] * c5 - m[..., 3, 2] * c4 + m[..., 3, 3] * c3,
            -m[..., 2, 1] * c5 + m[..., 2, 2] * c4 - m[..., 2, 3] * c3,
        ], axis=-1),
        jnp.stack([
            -m[..., 1, 0] * s5 + m[..., 1, 2] * s2 - m[..., 1, 3] * s1,
            m[..., 0, 0] * s5 - m[..., 0, 2] * s2 + m[..., 0, 3] * s1,
            -m[..., 3, 0] * c5 + m[..., 3, 2] * c2 - m[..., 3, 3] * c1,
            m[..., 2, 0] * c5 - m[..., 2, 2] * c2 + m[..., 2, 3] * c1,
        ], axis=-1),
        jnp.stack([
            m[..., 1, 0] * s4 - m[..., 1, 1] * s2 + m[..., 1, 3] * s0,
            -m[..., 0, 0] * s4 + m[..., 0, 1] * s2 - m[..., 0, 3] * s0,
            m[..., 3, 0] * c4 - m[..., 3, 1] * c2 + m[..., 3, 3] * c0,
            -m[..., 2, 0] * c4 + m[..., 2, 1] * c2 - m[..., 2, 3] * c0,
        ], axis=-1),
        jnp.stack([
            -m[..., 1, 0] * s3 + m[..., 1, 1] * s1 - m[..., 1, 2] * s0,
            m[..., 0, 0] * s3 - m[..., 0, 1] * s1 + m[..., 0, 2] * s0,
            -m[..., 3, 0] * c3 + m[..., 3, 1] * c1 - m[..., 3, 2] * c0,
            m[..., 2, 0] * c3 - m[..., 2, 1] * c1 + m[..., 2, 2] * c0,
        ], axis=-1),
    ], axis=-2) / det[..., None, None]
    return jnp.einsum("...ij,...j->...i", inv, v, precision=PRECISION)


def eigh4_jacobi_c(A_comps, sweeps: int = 8):
    """Fully-componentized symmetric 4x4 eigendecomposition (cyclic Jacobi,
    fixed sweep count, branchless).

    ``A_comps``: length-16 list of (batched, arbitrary-shape) arrays, the
    matrix entries row-major. Returns ``(lam, V)`` with ``lam`` a length-4
    list (ascending) and ``V`` a 4x4 list-of-lists (columns are
    eigenvectors) — NO (..., 4, 4) tensor is ever materialized, so no
    operand acquires a tiny trailing dim (pathology 9).

    The rotation body is closed-form Givens row/col updates on 16+16 flat
    arrays inside a ``lax.scan`` whose body compiles ONCE (fully unrolling
    hits an XLA:CPU compile cliff — recorded negative, r04). The final
    ascending sort is a 5-comparator sorting network of component
    where-swaps (the r04 one-hot-einsum sort was itself a padded 4x4
    contraction).
    """
    # symmetrize like the tensor form
    A0 = [0.5 * (A_comps[i * 4 + j] + A_comps[j * 4 + i])
          for i in range(4) for j in range(4)]
    one = jnp.ones_like(A0[0])
    zero = jnp.zeros_like(A0[0])
    eye = [one if i == j else zero for i in range(4) for j in range(4)]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    def sweep(carry, _):
        flat = list(carry)
        A = [[flat[i * 4 + j] for j in range(4)] for i in range(4)]
        V = [[flat[16 + i * 4 + j] for j in range(4)] for i in range(4)]
        for (p, q) in pairs:
            theta = 0.5 * jnp.arctan2(2.0 * A[p][q], A[q][q] - A[p][p])
            c = jnp.cos(theta)
            s = jnp.sin(theta)
            # B = G^T A (rows p, q), then A' = B G (cols p, q); V' = V G.
            # G = I except G[pp]=G[qq]=c, G[pq]=s, G[qp]=-s.
            Bp = [c * A[p][k] - s * A[q][k] for k in range(4)]
            Bq = [s * A[p][k] + c * A[q][k] for k in range(4)]
            B = [Bp if i == p else Bq if i == q else A[i]
                 for i in range(4)]
            A = [[(c * B[i][p] - s * B[i][q]) if j == p
                  else (s * B[i][p] + c * B[i][q]) if j == q
                  else B[i][j]
                  for j in range(4)] for i in range(4)]
            V = [[(c * V[i][p] - s * V[i][q]) if j == p
                  else (s * V[i][p] + c * V[i][q]) if j == q
                  else V[i][j]
                  for j in range(4)] for i in range(4)]
        return tuple(x for row in A for x in row) + tuple(
            x for row in V for x in row), None

    flat, _ = jax.lax.scan(sweep, tuple(A0) + tuple(eye), None,
                           length=sweeps)
    lam = [flat[i * 4 + i] for i in range(4)]
    V = [[flat[16 + i * 4 + j] for j in range(4)] for i in range(4)]

    # ascending sort: 5-comparator network, swapping (eigenvalue, column)
    for (k, l) in [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]:
        take = lam[k] > lam[l]
        lam[k], lam[l] = (jnp.where(take, lam[l], lam[k]),
                          jnp.where(take, lam[k], lam[l]))
        for i in range(4):
            V[i][k], V[i][l] = (jnp.where(take, V[i][l], V[i][k]),
                                jnp.where(take, V[i][k], V[i][l]))
    return lam, V


def eigh4_jacobi(M, sweeps: int = 8):
    """Symmetric 4x4 eigendecomposition via cyclic Jacobi rotations,
    batched and branchless (fixed sweep count; ~machine precision for
    well-scaled inputs after 6-8 sweeps).

    Returns (eigenvalues ascending, eigenvectors as columns) matching
    ``jnp.linalg.eigh``'s convention. Tensor-in/tensor-out wrapper around
    :func:`eigh4_jacobi_c` — hot paths should use the component form
    directly and never materialize the (..., 4, 4) operands.
    """
    comps = [M[..., i, j] for i in range(4) for j in range(4)]
    lam, V = eigh4_jacobi_c(comps, sweeps=sweeps)
    lam_sorted = jnp.stack(lam, axis=-1)
    V_sorted = jnp.stack(
        [jnp.stack([V[i][j] for j in range(4)], axis=-1)
         for i in range(4)], axis=-2)
    return lam_sorted, V_sorted


def solve4_c(Mc, vc, eps: float = 1e-30):
    """Component form of :func:`solve4`: ``Mc`` is a 4x4 list-of-lists,
    ``vc`` a length-4 list; returns a length-4 list. Same cofactor
    expansion, zero (..., 4, 4) materialization."""
    m = Mc
    s0 = m[2][0] * m[3][1] - m[2][1] * m[3][0]
    s1 = m[2][0] * m[3][2] - m[2][2] * m[3][0]
    s2 = m[2][0] * m[3][3] - m[2][3] * m[3][0]
    s3 = m[2][1] * m[3][2] - m[2][2] * m[3][1]
    s4 = m[2][1] * m[3][3] - m[2][3] * m[3][1]
    s5 = m[2][2] * m[3][3] - m[2][3] * m[3][2]
    c0 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    c1 = m[0][0] * m[1][2] - m[0][2] * m[1][0]
    c2 = m[0][0] * m[1][3] - m[0][3] * m[1][0]
    c3 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c4 = m[0][1] * m[1][3] - m[0][3] * m[1][1]
    c5 = m[0][2] * m[1][3] - m[0][3] * m[1][2]

    det = c0 * s5 - c1 * s4 + c2 * s3 + c3 * s2 - c4 * s1 + c5 * s0
    det = jnp.where(jnp.abs(det) < eps, jnp.full_like(det, eps), det)

    inv = [
        [m[1][1] * s5 - m[1][2] * s4 + m[1][3] * s3,
         -m[0][1] * s5 + m[0][2] * s4 - m[0][3] * s3,
         m[3][1] * c5 - m[3][2] * c4 + m[3][3] * c3,
         -m[2][1] * c5 + m[2][2] * c4 - m[2][3] * c3],
        [-m[1][0] * s5 + m[1][2] * s2 - m[1][3] * s1,
         m[0][0] * s5 - m[0][2] * s2 + m[0][3] * s1,
         -m[3][0] * c5 + m[3][2] * c2 - m[3][3] * c1,
         m[2][0] * c5 - m[2][2] * c2 + m[2][3] * c1],
        [m[1][0] * s4 - m[1][1] * s2 + m[1][3] * s0,
         -m[0][0] * s4 + m[0][1] * s2 - m[0][3] * s0,
         m[3][0] * c4 - m[3][1] * c2 + m[3][3] * c0,
         -m[2][0] * c4 + m[2][1] * c2 - m[2][3] * c0],
        [-m[1][0] * s3 + m[1][1] * s1 - m[1][2] * s0,
         m[0][0] * s3 - m[0][1] * s1 + m[0][2] * s0,
         -m[3][0] * c3 + m[3][1] * c1 - m[3][2] * c0,
         m[2][0] * c3 - m[2][1] * c1 + m[2][2] * c0],
    ]
    return [(inv[i][0] * vc[0] + inv[i][1] * vc[1]
             + inv[i][2] * vc[2] + inv[i][3] * vc[3]) / det
            for i in range(4)]
