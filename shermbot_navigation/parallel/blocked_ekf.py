"""Blocked, map-sharded EKF-SLAM for large landmark maps (BASELINE config 4).

The covariance of a (3+2N)-dim SLAM state is stored as structured blocks
instead of one dense matrix (SURVEY.md section 5 "long-context" row):

- ``cov_rr`` (3,3)        robot block               — replicated
- ``cov_rm`` (3,N,2)      robot-landmark strip      — sharded over 'map'
- ``cov_mm`` (2,2,N,N)    landmark grid as four COMPONENT PLANES
                          (``plane[p,q,n,m] = Sigma[(n,p),(m,q)]``) —
                          row-landmark axis sharded over 'map'. Planes put
                          both landmark axes in the two minor dims, so no
                          grid access can induce an interleaved size-2
                          minor dim and the relayout copies of a whole
                          grid it would force are impossible by
                          construction.
- ``mean_r`` (3,), ``mean_m`` (N,2)                 — replicated / sharded

All three EKF phases then have near-perfect locality:

- **predict** touches only ``cov_rr`` and rows 1:3 of the strip — O(N/s)
  per shard, zero communication (the rank-2 structure from
  ``models.ekf_slam.predict``);
- **update** against landmark j needs one broadcast of the owner shard's
  5-column gather (a psum of a (3,2)+(2,2) packet) and one
  ``all_gather`` of the (2, 2N/s) ``H Sigma`` strips — tens of KB over ICI
  for N=2000 — followed by local rank-2 outer products;
- **associate** scores every local landmark block against the measurement
  with closed-form 2x2 inverses, then resolves the reference's first-hit
  semantics globally with a single ``pmin`` over (first-hit slot index).

The reference analog is the dense O(D^3) single-core Armadillo math
(slam_library.cpp:96-108, 263-282); there is no distributed analog to cite —
this is the from-scratch design SURVEY section 2.5 calls for.

All functions here are written *per shard* and wired with ``shard_map`` in
:func:`make_sharded_step`; batch ('data' axis) is an outer vmap inside the
shard, so one program serves (B, N) with B sharded over 'data' and N over
'map'.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.ekf_slam import EKFConfig, _inv2x2, PRECISION
from ..ops import se2


class BlockedState(NamedTuple):
    """Global-view blocked state (leading batch dim B; landmark dim N)."""

    mean_r: jnp.ndarray   # (B, 3)  [theta, x, y]
    mean_m: jnp.ndarray   # (B, N, 2)
    cov_rr: jnp.ndarray   # (B, 3, 3)
    cov_rm: jnp.ndarray   # (B, 3, N, 2)
    cov_mm: jnp.ndarray   # (B, 2, 2, N, N) comp planes — rows sharded
    diag4: jnp.ndarray    # (B, 4, N) own-block diagonal cache, comps
                          # [p*2+q][n] == cov_mm[p, q, n, n]. Maintained by
                          # every step (association reads it instead of
                          # gathering the planes — a full-plane read per
                          # tick otherwise). May drift from the true
                          # diagonal by
                          # f32 ulps (the grid pass sums in a different
                          # order) — PARITY D15.
    n_seen: jnp.ndarray   # (B,) int32
    seen: jnp.ndarray     # (B, N) bool — per-slot init mask (see EKFState.seen)


def state_sharding(mesh: Mesh):
    """PartitionSpecs: batch over 'data', landmark dim over 'map'."""
    return BlockedState(
        mean_r=P("data", None),
        mean_m=P("data", "map", None),
        cov_rr=P("data", None, None),
        cov_rm=P("data", None, "map", None),
        cov_mm=P("data", None, None, "map", None),
        diag4=P("data", None, "map"),
        n_seen=P("data"),
        seen=P("data", "map"),
    )


def init(config: EKFConfig, batch: int, robot_pose=None, dtype=jnp.float32
         ) -> BlockedState:
    N = config.num_landmarks
    B = batch
    mean_r = jnp.zeros((B, 3), dtype)
    if robot_pose is not None:
        mean_r = jnp.broadcast_to(jnp.asarray(robot_pose, dtype), (B, 3))
    # block-diagonal prior: plane[p, q] = eye(N) * diag[p, q]
    diag = jnp.eye(2, dtype=dtype) * jnp.asarray(config.init_cov, dtype)
    cov_mm = jnp.eye(N, dtype=dtype)[None, None, :, :] * diag[:, :, None, None]
    cov_mm = jnp.broadcast_to(cov_mm[None], (B, 2, 2, N, N))
    diag4 = jnp.broadcast_to(
        diag.reshape(4)[None, :, None], (B, 4, N)).astype(dtype)
    return BlockedState(
        mean_r=mean_r,
        mean_m=jnp.zeros((B, N, 2), dtype),
        cov_rr=jnp.zeros((B, 3, 3), dtype),
        cov_rm=jnp.zeros((B, 3, N, 2), dtype),
        cov_mm=cov_mm,
        diag4=diag4,
        n_seen=jnp.zeros((B,), jnp.int32),
        seen=jnp.zeros((B, N), bool),
    )


# ---------------------------------------------------------------------------
# Per-shard kernels (operate on ONE batch element; vmapped by the wrapper)
# ---------------------------------------------------------------------------

def _motion_delta(theta, twist):
    from ..models.ekf_slam import _motion_delta as md
    return md(theta, twist)


def _predict_shard(config, st, twist, Q):
    """Rank-2 strip predict, local to each shard (no communication)."""
    theta = st.mean_r[0]
    dq, b = _motion_delta(theta, twist)
    mean_r = st.mean_r + dq

    # row 0 of Sigma: robot part (3,) and strip part (Nl, 2)
    r0_r = st.cov_rr[0, :]
    r0_m = st.cov_rm[0]                       # (Nl, 2)
    s00 = st.cov_rr[0, 0]

    cov_rr = st.cov_rr
    cov_rr = cov_rr.at[1:3, :].add(b[:, None] * r0_r[None, :])
    cov_rr = cov_rr.at[:, 1:3].add(r0_r[:, None] * b[None, :])
    cov_rr = cov_rr.at[1:3, 1:3].add(s00 * b[:, None] * b[None, :])
    cov_rr = cov_rr + Q

    cov_rm = st.cov_rm.at[1:3].add(b[:, None, None] * r0_m[None, :, :])
    return st._replace(mean_r=mean_r, cov_rr=cov_rr, cov_rm=cov_rm)


def _h5_coeffs(mean_r, mj, dtype):
    """Measurement geometry + compressed Jacobian rows (replicated math)."""
    dx = mj[0] - mean_r[1]
    dy = mj[1] - mean_r[2]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dtype))
    sq = jnp.sqrt(d)
    z = jnp.zeros_like(dx)
    row0 = jnp.stack([z, -dx / sq, -dy / sq, dx / sq, dy / sq])
    row1 = jnp.stack([-jnp.ones_like(dx), dy / d, -dx / d, -dy / d, dx / d])
    H5 = jnp.stack([row0, row1])  # (2, 5)
    z_hat = jnp.stack([sq, se2.normalize_angle(jnp.arctan2(dy, dx) - mean_r[0])])
    return H5, z_hat


def _update_shard(config, st, z, j, R, n_local):
    """Kalman update against GLOBAL landmark slot ``j`` (traced int32).

    Communication: two psums (owner broadcast packets) + one all_gather of
    the (2, 2*Nl) HSigma strip over 'map'.
    """
    dtype = st.mean_r.dtype
    j = jnp.asarray(j, jnp.int32)
    shard = jax.lax.axis_index("map").astype(jnp.int32)
    off = shard * jnp.int32(n_local)
    j_loc = j - off
    owns = (j_loc >= 0) & (j_loc < n_local)
    j_safe = jnp.clip(j_loc, 0, n_local - 1).astype(jnp.int32)

    # owner broadcast: landmark mean (2,), strip col (3,2), mm col block rows
    mj = jax.lax.psum(
        jnp.where(owns, 1.0, 0.0) * jax.lax.dynamic_index_in_dim(
            st.mean_m, j_safe, axis=0, keepdims=False), "map")
    H5, z_hat = _h5_coeffs(st.mean_r, mj, dtype)

    # Sigma H^T, robot rows (3, 2): cols {0:3} = cov_rr, col {j} = cov_rm[:, j]
    rm_j = jax.lax.psum(
        jnp.where(owns, 1.0, 0.0) * jax.lax.dynamic_index_in_dim(
            st.cov_rm, j_safe, axis=1, keepdims=False), "map")  # (3, 2)
    SHt_r = jnp.matmul(jnp.concatenate([st.cov_rr, rm_j], axis=1), H5.T,
                       precision=PRECISION)                      # (3, 2)

    # Sigma H^T, local map rows (Nl, 2, 2):
    # build (Nl, 2, 5): [cov_mr (Nl,2,3), grid column j (Nl,2,2)].
    # The column read is one gather per comp plane (an owner-row psum via
    # grid symmetry would double the per-update collective volume).
    cov_mr = jnp.transpose(st.cov_rm, (1, 2, 0))          # (Nl, 2, 3)
    mm_colj = jnp.transpose(
        jax.lax.dynamic_index_in_dim(st.cov_mm, j, axis=3,
                                     keepdims=False),
        (2, 0, 1))                                         # (Nl, 2, 2)
    cols5_m = jnp.concatenate([cov_mr, mm_colj], axis=-1)  # (Nl, 2, 5)
    SHt_m = jnp.einsum("npk,qk->npq", cols5_m, H5,
                       precision=PRECISION)                      # (Nl, 2, 2)

    # psi = H (Sigma H^T) + R: rows {0:3} + row {j}
    SHt_j = jax.lax.psum(
        jnp.where(owns, 1.0, 0.0) * jax.lax.dynamic_index_in_dim(
            SHt_m, j_safe, axis=0, keepdims=False), "map")  # (2, 2)
    psi = jnp.matmul(H5, jnp.concatenate([SHt_r, SHt_j], axis=0),
                     precision=PRECISION) + R
    psi_inv = _inv2x2(psi)

    K_r = jnp.matmul(SHt_r, psi_inv, precision=PRECISION)   # (3, 2)
    K_m = jnp.einsum("npq,qr->npr", SHt_m, psi_inv,
                     precision=PRECISION)                    # (Nl, 2, 2)

    dz = z - z_hat
    if config.wrap_innovation:
        dz = dz.at[1].set(se2.normalize_angle(dz[1]))

    mean_r = st.mean_r + jnp.matmul(K_r, dz, precision=PRECISION)
    mean_r = mean_r.at[0].set(se2.normalize_angle(mean_r[0]))
    mean_m = st.mean_m + jnp.einsum("npq,q->np", K_m, dz,
                                    precision=PRECISION)

    # covariance: Sigma -= K (H Sigma); HSigma = (Sigma H^T)^T.
    # The full Sigma H^T map strip is needed on every shard for the column
    # side of the rank-2 update: one all_gather of (Nl, 2, 2) -> (N, 2, 2)
    # (~N*16 bytes — tens of KB at N=2000, rides ICI).
    HS_m = jax.lax.all_gather(SHt_m, "map", axis=0, tiled=True)  # (N, 2, 2)

    cov_rr = st.cov_rr - jnp.matmul(K_r, SHt_r.T, precision=PRECISION)
    cov_rm = st.cov_rm - jnp.einsum("iq,npq->inp", K_r, SHt_m,
                                    precision=PRECISION)
    # plane update: sub[p, r, n, m] = sum_q K_m[n, p, q] HS_m[m, r, q]
    cov_mm = st.cov_mm - jnp.einsum("npq,mrq->prnm", K_m, HS_m,
                                    precision=PRECISION)

    # own-block diagonal cache: the same rank-2 subtraction, local rows
    kc = jnp.transpose(K_m, (1, 2, 0))              # (2, 2, Nl) [p, q, n]
    sc = jnp.transpose(SHt_m, (1, 2, 0))            # (2, 2, Nl) [r, q, n]
    diag4 = st.diag4 - jnp.stack(
        [kc[p, 0] * sc[r, 0] + kc[p, 1] * sc[r, 1]
         for p in range(2) for r in range(2)])

    if config.symmetrize:
        cov_rr = 0.5 * (cov_rr + cov_rr.T)
    return st._replace(mean_r=mean_r, mean_m=mean_m, cov_rr=cov_rr,
                       cov_rm=cov_rm, cov_mm=cov_mm, diag4=diag4)


def _init_landmark_shard(config, st, z, j, R, n_local):
    """Analytic first-observation init of global slot j (writes the owner's
    mean/cov blocks; the cross-strip to the robot is global)."""
    dtype = st.mean_r.dtype
    j = jnp.asarray(j, jnp.int32)
    shard = jax.lax.axis_index("map").astype(jnp.int32)
    off = shard * jnp.int32(n_local)
    j_loc = j - off
    owns = (j_loc >= 0) & (j_loc < n_local)
    j_safe = jnp.clip(j_loc, 0, n_local - 1).astype(jnp.int32)

    th, x, y = st.mean_r[0], st.mean_r[1], st.mean_r[2]
    a = z[1] + th
    r = z[0]
    sa, ca = jnp.sin(a), jnp.cos(a)
    m = jnp.stack([x + r * ca, y + r * sa])

    Gx = jnp.stack([jnp.stack([-r * sa, jnp.ones_like(r), jnp.zeros_like(r)]),
                    jnp.stack([r * ca, jnp.zeros_like(r), jnp.ones_like(r)])])
    Gz = jnp.stack([jnp.stack([ca, -r * sa]), jnp.stack([sa, r * ca])])

    # mean
    mean_m = jnp.where(
        owns,
        jax.lax.dynamic_update_index_in_dim(st.mean_m, m, j_safe, axis=0),
        st.mean_m)

    # cross strip to robot: Sigma_{m_j, r} = Gx Sigma_rr  -> cov_rm[:, j] = (Gx Srr)^T
    cross_r = jnp.matmul(Gx, st.cov_rr, precision=PRECISION).T    # (3, 2)
    cov_rm = jnp.where(
        owns,
        jax.lax.dynamic_update_index_in_dim(st.cov_rm, cross_r, j_safe, axis=1),
        st.cov_rm)

    # cross to other landmarks: Sigma_{m_j, m_k} = Gx Sigma_{r, m_k}
    # rows (owner only): (2, N, 2) = Gx @ cov_rm_global. cov_rm is sharded;
    # the ROW lives on the owner, so a gather is unavoidable — but gather
    # the (2, Nl, 2) PRODUCT Gx @ cov_rm_local (computed shard-locally,
    # element-for-element identical) instead of the (3, Nl, 2) strip:
    # 16N bytes on the wire instead of 24N.
    cross_loc = jnp.einsum("pi,imq->pmq", Gx, st.cov_rm,
                           precision=PRECISION)                    # (2, Nl, 2)
    crossc = jnp.transpose(cross_loc, (0, 2, 1))                   # (2, 2, Nl)
    cross_m = jax.lax.all_gather(crossc, "map", axis=2,
                                 tiled=True)                       # (2, 2, N)
    # write owner's grid row j (contiguous per plane)
    cov_mm = jnp.where(
        owns,
        jax.lax.dynamic_update_slice(
            st.cov_mm, cross_m[:, :, None, :],
            (jnp.int32(0), jnp.int32(0), j_safe, jnp.int32(0))),
        st.cov_mm)
    # write the column block on EVERY shard: plane[p, q, :, j] =
    # cross_m[q, p, local rows] (comp swap by symmetry). One-hot select
    # instead of a scatter: the select fuses into a single plane pass.
    n_l = st.mean_m.shape[0]
    local_cols = jax.lax.dynamic_slice_in_dim(
        cross_m, shard * jnp.int32(n_l), n_l, axis=2)              # (2, 2, Nl)
    col_block = jnp.transpose(local_cols, (1, 0, 2))               # (2, 2, Nl)
    N = cov_mm.shape[3]
    col_onehot = jnp.arange(N, dtype=jnp.int32) == j               # (N,)
    cov_mm = jnp.where(col_onehot[None, None, None, :],
                       col_block[:, :, :, None], cov_mm)

    # own 2x2 block: Gx Srr Gx^T + Gz R Gz^T (overwrites the prior diag)
    block = (jnp.matmul(jnp.matmul(Gx, st.cov_rr, precision=PRECISION),
                        Gx.T, precision=PRECISION)
             + jnp.matmul(jnp.matmul(Gz, R, precision=PRECISION), Gz.T,
                          precision=PRECISION))
    cov_mm = jnp.where(
        owns,
        jax.lax.dynamic_update_slice(
            cov_mm, block[:, :, None, None],
            (jnp.int32(0), jnp.int32(0), j_safe, j)),
        cov_mm)
    diag4 = jnp.where(
        owns,
        jax.lax.dynamic_update_slice(
            st.diag4, block.reshape(4, 1), (jnp.int32(0), j_safe)),
        st.diag4)
    return st._replace(mean_m=mean_m, cov_rm=cov_rm, cov_mm=cov_mm,
                       diag4=diag4)


def _associate_shard(config, st, z, R, n_local, Smm=None):
    """Blockwise Mahalanobis association with global first-hit resolution.

    Each shard scores its local landmark blocks (O(Nl)); the reference's
    first-hit decision (SURVEY section 2.4) is recovered with one pmin over
    the global index of the first sub-gate hit.

    ``Smm`` optionally supplies the (Nl, 2, 2) own-block diagonal of the
    landmark grid (the deferred step carries it as a strip instead of
    reading the grid).
    """
    dtype = st.mean_r.dtype
    shard = jax.lax.axis_index("map")
    off = shard * n_local

    m = st.mean_m                                    # (Nl, 2)
    dx = m[:, 0] - st.mean_r[1]
    dy = m[:, 1] - st.mean_r[2]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dtype))
    sq = jnp.sqrt(d)
    zeros = jnp.zeros_like(dx)
    H5 = jnp.stack([
        jnp.stack([zeros, -dx / sq, -dy / sq, dx / sq, dy / sq], axis=-1),
        jnp.stack([-jnp.ones_like(dx), dy / d, -dx / d, -dy / d, dx / d],
                  axis=-1)], axis=-2)               # (Nl, 2, 5)

    Srr = st.cov_rr                                  # (3,3) replicated
    Srm = jnp.transpose(st.cov_rm, (1, 0, 2))        # (Nl, 3, 2)
    ii = jnp.arange(n_local)
    if Smm is None:
        # own-block diagonal from the maintained cache (a plane gather
        # here costs a full plane-set read per call — PARITY D15)
        Smm = jnp.transpose(st.diag4.reshape(2, 2, n_local), (2, 0, 1))
    # (Nl, 2, 2)

    top = jnp.concatenate(
        [jnp.broadcast_to(Srr, (n_local, 3, 3)), Srm], axis=2)
    bot = jnp.concatenate([jnp.transpose(Srm, (0, 2, 1)), Smm], axis=2)
    S5 = jnp.concatenate([top, bot], axis=1)         # (Nl, 5, 5)

    psi = jnp.einsum("nij,njk,nlk->nil", H5, S5, H5,
                     precision=PRECISION) + R
    z_hat = jnp.stack(
        [sq, se2.normalize_angle(jnp.arctan2(dy, dx) - st.mean_r[0])],
        axis=-1)
    dz = z[None, :] - z_hat
    if config.wrap_innovation:
        dz = dz.at[:, 1].set(se2.normalize_angle(dz[:, 1]))
    dist = jnp.einsum("ni,nij,nj->n", dz, _inv2x2(psi), dz,
                      precision=PRECISION)

    gidx = off + jnp.arange(n_local)
    dist = jnp.where(st.seen, dist, jnp.inf)

    # global first-hit: smallest global index with dist < new_gate
    hit_idx = jnp.where(dist < config.new_gate, gidx, jnp.iinfo(jnp.int32).max)
    first = jax.lax.pmin(jnp.min(hit_idx), "map")
    any_hit = first < jnp.iinfo(jnp.int32).max
    first_safe = jnp.where(any_hit, first, 0)
    # distance at the first-hit slot (owner contributes via psum)
    f_loc = first_safe - off
    f_owns = (f_loc >= 0) & (f_loc < n_local)
    d_first = jax.lax.psum(
        jnp.where(f_owns & any_hit,
                  jnp.nan_to_num(dist[jnp.clip(f_loc, 0, n_local - 1)],
                                 posinf=0.0),
                  0.0), "map")
    return any_hit, first_safe, d_first


class _SeqComp(NamedTuple):
    """Per-measurement scan carry of the deferred step, component layout.

    Every strip is stored with the landmark axis MINOR and the 2x2/3x2
    block structure unrolled into leading component rows — the
    ops/smallalg rule applied to the batch dimension (BENCH_NOTES
    pathology 9): a (Nl, 2, 2) array carries its tiny (2, 2) minor dims
    through every op of the scan body, while component rows are plain
    contiguous strips.
    """

    mean_r: jnp.ndarray   # (3,)
    mm2: jnp.ndarray      # (2, Nl)  mean_m components [p][n]
    cov_rr: jnp.ndarray   # (3, 3)
    rm6: jnp.ndarray      # (6, Nl)  cov_rm components [i*2+p][n]
    n_seen: jnp.ndarray   # () int32
    seen: jnp.ndarray     # (Nl,) bool


def _associate_comp(config, mean_r, mm2, cov_rr, rm6, seen, z, R, n_local,
                    diag4):
    """:func:`_associate_shard` on component-layout strips.

    Same math (psi = H5 S5 H5^T + R per landmark, Mahalanobis first-hit,
    global pmin resolution) written as componentwise (Nl,) vector ops:
    the (Nl, 5, 5) S5 / batched einsum form tile-pads to ~40x physical and
    lowers to relayout-heavy tiny batched matmuls. Componentwise f32 VPU
    ops also dodge bf16 demotion, so no Precision pin is needed.
    ``diag4`` is the carried own-block diagonal, components [p*2+q][n].
    """
    shard = jax.lax.axis_index("map")
    off = shard * n_local
    dtype = mean_r.dtype

    dx = mm2[0] - mean_r[1]
    dy = mm2[1] - mean_r[2]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dtype))
    sq = jnp.sqrt(d)
    a = dx / sq
    b = dy / sq
    c = dy / d
    e = -dx / d
    zero = jnp.zeros_like(dx)
    one = jnp.ones_like(dx)
    # H5 rows as 5 components each (H5 of _h5_coeffs, batched over n)
    w = ((zero, -a, -b, a, b), (-one, c, e, -c, -e))

    # u_l = S5 @ w_l, 5 components of (Nl,); psi[p,l] = w_p . u_l + R[p,l]
    psi = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(cov_rr[k, 0] * wl[0] + cov_rr[k, 1] * wl[1]
                     + cov_rr[k, 2] * wl[2]
                     + rm6[k * 2 + 0] * wl[3] + rm6[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm6[0 * 2 + p] * wl[0] + rm6[1 * 2 + p] * wl[1]
                     + rm6[2 * 2 + p] * wl[2]
                     + diag4[p * 2 + 0] * wl[3] + diag4[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                         + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]
    p00, p01, p10, p11 = psi[0][0], psi[0][1], psi[1][0], psi[1][1]
    det = p00 * p11 - p01 * p10

    z_hat1 = se2.normalize_angle(jnp.arctan2(dy, dx) - mean_r[0])
    dz0 = z[0] - sq
    dz1 = z[1] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)
    # dz^T psi^{-1} dz with the closed-form 2x2 adjugate
    dist = (dz0 * (p11 * dz0 - p01 * dz1)
            + dz1 * (-p10 * dz0 + p00 * dz1)) / det

    gidx = off + jnp.arange(n_local)
    dist = jnp.where(seen, dist, jnp.inf)
    hit_idx = jnp.where(dist < config.new_gate, gidx,
                        jnp.iinfo(jnp.int32).max)
    first = jax.lax.pmin(jnp.min(hit_idx), "map")
    any_hit = first < jnp.iinfo(jnp.int32).max
    first_safe = jnp.where(any_hit, first, 0)
    f_loc = first_safe - off
    f_owns = (f_loc >= 0) & (f_loc < n_local)
    d_first = jax.lax.psum(
        jnp.where(f_owns & any_hit,
                  jnp.nan_to_num(dist[jnp.clip(f_loc, 0, n_local - 1)],
                                 posinf=0.0),
                  0.0), "map")
    return any_hit, first_safe, d_first


# ---------------------------------------------------------------------------
# shard_map wiring
# ---------------------------------------------------------------------------

def make_sharded_step(config: EKFConfig, mesh: Mesh, batch: int,
                      max_meas: int):
    """Build the jitted, mesh-sharded known-association SLAM tick.

    Returns ``step(state, twist (B,3), zs (B,M,2), valid (B,M),
    ids (B,M), Q, R) -> state`` with the state sharded per
    :func:`state_sharding`. Measurements are processed sequentially
    (reference semantics) via ``lax.scan`` inside the shard.
    """
    N = config.num_landmarks
    n_map = mesh.shape["map"]
    if N % n_map:
        raise ValueError(f"num_landmarks {N} not divisible by map={n_map}")
    n_local = N // n_map

    specs = state_sharding(mesh)
    in_specs = (specs, P("data", None), P("data", None, None),
                P("data", None), P("data", None), P(None, None), P(None, None))

    def shard_fn(st, twist, zs, valid, ids, Q, R):
        # st leaves have local shapes; vmap over the local batch
        def one(st1, tw1, zs1, va1, id1):
            st1 = _predict_shard(config, st1, tw1, Q)

            def body(carry, inp):
                s, = carry
                z, v, j = inp
                # out-of-range id -> full no-op (in particular no phantom
                # n_seen bump); same rule in the deferred path
                v = v & (j >= 0) & (j < N)
                # owner-broadcast of the slot's seen bit (psum of a bool)
                shard = jax.lax.axis_index("map")
                j_loc = j - shard * n_local
                owns = (j_loc >= 0) & (j_loc < n_local)
                seen = jax.lax.psum(
                    jnp.where(owns,
                              s.seen[jnp.clip(j_loc, 0, n_local - 1)]
                              .astype(jnp.int32), 0), "map") > 0
                is_new = v & ~seen
                s_init = _init_landmark_shard(config, s, z, j, R, n_local)
                seen_upd = jnp.where(
                    owns,
                    s.seen.at[jnp.clip(j_loc, 0, n_local - 1)].set(True),
                    s.seen)
                s_init = s_init._replace(n_seen=s.n_seen + 1, seen=seen_upd)
                pre = jax.tree_util.tree_map(
                    lambda a_, b_: jnp.where(is_new, a_, b_), s_init, s)
                upd = _update_shard(config, pre, z, j, R, n_local)
                do_update = v & seen
                s = jax.tree_util.tree_map(
                    lambda a_, b_: jnp.where(do_update, a_, b_), upd, pre)
                return (s,), None

            (st1,), _ = jax.lax.scan(body, (st1,), (zs1, va1, id1))
            return st1

        return jax.vmap(one)(st, twist, zs, valid, ids)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs, out_specs=specs,
                   check_vma=False)
    return jax.jit(fn)


def reference_grid_update(cov, a, b, crow, ccol, rowt, colt):
    """The deferred grid pass as plain XLA: replay the tick's init
    overwrites (last op wins), then subtract the masked rank-2M term.

    The schedule on the CPU, in f64 and on multi-shard meshes, and the
    oracle of ``ops/pallas/grid_update.fused_grid_update`` (same operands).
    cov (2, 2, Nl, N) comp planes; a (2, Nl, 2M); b (2, 2M, N);
    crow (2, 2, M, N) row overwrite values; ccol (2, 2, Nl, M) column
    overwrite values; rowt (Nl,) / colt (N,) last-init op index or -1."""
    M = crow.shape[2]
    rt = rowt[:, None]                                         # (Nl, 1)
    ct = colt[None, :]                                         # (1, N)
    outs = []
    for p in range(2):
        row_out = []
        for r in range(2):
            base = cov[p, r]
            for i in range(M):
                base = jnp.where(ct == i, ccol[p, r, :, i:i + 1], base)
                base = jnp.where(rt == i, crow[p, r, i:i + 1, :], base)
            row_out.append(base - jnp.matmul(a[p], b[r],
                                             precision=PRECISION))
        outs.append(jnp.stack(row_out))
    return jnp.stack(outs)


def _make_sharded_deferred(config: EKFConfig, mesh: Mesh, batch: int,
                           max_meas: int, known: bool,
                           grid_kernel: bool = False,
                           kernel_interpret: bool = False,
                           meas_unroll: bool = False):
    """SLAM tick with a DEFERRED landmark-grid update (known or unknown
    association; see the public wrappers below).

    Semantically identical to :func:`make_sharded_step` (same sequential
    per-measurement ordering, PARITY P5), but the (N,2,N,2) landmark grid —
    the only O(N^2) state — is read and written ONCE PER TICK instead of
    once per measurement. The sequential scan over measurements touches
    only O(N) strips:

    - each update's Kalman gain needs one grid COLUMN at its pre-update
      value; that column is reconstructed from ``cov_mm0`` (the tick's
      input grid) plus the tick's earlier ops: rank-2 subtractions are
      re-applied from the buffered (K_i, HSigma_i) strips and init
      row/column overwrites from the buffered cross strips — O(M * N) work,
      no grid traffic;
    - init writes (row, column, own block) are buffered, not applied.

    After the scan, ONE fused pass assembles the final grid: for every
    entry the last overwrite (if any) wins and only later rank-2 terms are
    subtracted — the (i > last_init) masks factor per-row and per-column,
    so the combined subtraction is a single (2*Nl, 2*M) x (2*M, 2*N)
    matmul. In exact arithmetic this equals the sequential result; in
    finite precision only summation order differs (pinned by
    test_blocked_ekf / test_blocked_unknown at f64 tolerance and by an f32
    association-decision rollout).

    Communication structure (the multi-host story, bench_scaling.py): the
    per-measurement scan issues only O(1)-byte owner-broadcast psums — the
    strips it buffers are kept SHARD-LOCAL (``HSbuf`` holds each shard's
    rows of Sigma H^T, ``CRbuf`` each shard's columns of the init cross
    strip) and the two O(M*N)-byte ``all_gather``s that assemble global
    strips happen ONCE per tick, at the grid pass, where XLA can overlap
    them with the scan epilogue. Reconstruction reads that previously
    gathered full strips (v1) now pull single-column packets from the
    owner: one (M, 2, 2) psum per measurement.

    Device-memory traffic per tick drops from ~2*M full-grid passes to
    ~2-3 (XLA schedule), or the 2-pass floor with ``grid_kernel=True`` —
    the fused Pallas pass (ops/pallas/grid_update.py; f32 and power-of-two
    planes). ``kernel_interpret`` runs the kernel in the Pallas
    interpreter (CPU tests only).
    """
    N = config.num_landmarks
    n_map = mesh.shape["map"]
    if N % n_map:
        raise ValueError(f"num_landmarks {N} not divisible by map={n_map}")
    n_local = N // n_map
    M = max_meas

    if grid_kernel:
        from ..ops.pallas import grid_update as _gu
        if not _gu.grid_shapes_supported(n_local, N):
            raise ValueError(
                f"grid_kernel wants power-of-two planes of at least 16; "
                f"got ({n_local}, {N})")

    specs = state_sharding(mesh)
    if known:
        in_specs = (specs, P("data", None), P("data", None, None),
                    P("data", None), P("data", None), P(None, None),
                    P(None, None))
    else:
        in_specs = (specs, P("data", None), P("data", None, None),
                    P("data", None), P(None, None), P(None, None))

    def shard_fn(st, twist, zs, valid, *rest):
        if known:
            ids, Q, R = rest
        else:
            Q, R = rest
            ids = None

        def one(st1, tw1, zs1, va1, id1):
            dtype = st1.mean_r.dtype
            st1 = _predict_shard(config, st1, tw1, Q)
            cov_mm0 = st1.cov_mm                     # (2, 2, Nl, N) frozen
            shard = jax.lax.axis_index("map").astype(jnp.int32)
            off = shard * jnp.int32(n_local)
            # column-major comp view for the in-scan column reads: one
            # clean (Nl, N) -> (N, Nl) transpose per plane, once per tick
            mm0cT = jnp.transpose(cov_mm0, (0, 1, 3, 2)
                                  ).reshape(4, N, n_local)
            ii_loc = jnp.arange(n_local, dtype=jnp.int32)
            # EVERYTHING the scan carries or indexes is in component-row
            # layout (see _SeqComp): strips as (k, Nl) with the landmark
            # axis on lanes. diag comps [p*2+q][n]; rm comps [i*2+p][n].
            # own-block diagonal from the maintained state cache —
            # gathering it from the planes costs a full plane-set read
            # per tick.
            diag4 = st1.diag4
            s0 = _SeqComp(
                mean_r=st1.mean_r,
                mm2=st1.mean_m.T,
                cov_rr=st1.cov_rr,
                rm6=jnp.transpose(st1.cov_rm, (0, 2, 1)).reshape(6, n_local),
                n_seen=st1.n_seen,
                seen=st1.seen)

            # op-history buffers — ALL SHARD-LOCAL and component-laid-out
            # (Kbuf/HSbuf: local rows of the Kalman gain / Sigma H^T per
            # update, comps [p*2+q][n]; CRbuf: local columns of the init
            # cross strip, own column pre-patched with B_own). Global
            # strips are assembled by two all_gathers once per tick, at
            # the grid pass.
            Kbuf = jnp.zeros((M, 4, n_local), dtype)
            HSbuf = jnp.zeros((M, 4, n_local), dtype)
            CRbuf = jnp.zeros((M, 4, n_local), dtype)
            gbuf = jnp.zeros((M,), jnp.int32)
            kindbuf = jnp.zeros((M,), jnp.int32)     # 0 none / 1 update / 2 init

            def col_at(bufs, j, g):
                """Grid column g (local rows, comps (4, Nl)) after ops
                0..j-1."""
                Kb, HSb, CRb, gb, kb = bufs
                col = jax.lax.dynamic_index_in_dim(
                    mm0cT, g, axis=1, keepdims=False)      # (4, Nl)
                g_loc = g - off
                owns_g = (g_loc >= 0) & (g_loc < n_local)
                g_safe = jnp.clip(g_loc, 0, n_local - 1).astype(jnp.int32)
                w_own = jnp.where(owns_g, 1.0, 0.0).astype(dtype)
                # column-g packets of every buffered op, in ONE batched
                # owner-broadcast each: (M, 4) = O(M) bytes, not O(N)
                hs_g = jax.lax.psum(w_own * HSb[:, :, g_safe], "map")
                cr_g = jax.lax.psum(w_own * CRb[:, :, g_safe], "map")
                rows = jnp.arange(n_local, dtype=jnp.int32)
                for i in range(M):
                    past = jnp.asarray(i, jnp.int32) < j
                    is_upd = past & (kb[i] == 1)
                    is_init = past & (kb[i] == 2)
                    s_i = gb[i]
                    # rank-2 subtraction on this column:
                    # corr[p,r] = K[p,0] hs[r,0] + K[p,1] hs[r,1]
                    k00, k01, k10, k11 = Kb[i, 0], Kb[i, 1], Kb[i, 2], Kb[i, 3]
                    h00, h01, h10, h11 = (hs_g[i, 0], hs_g[i, 1],
                                          hs_g[i, 2], hs_g[i, 3])
                    corr = jnp.stack([
                        k00 * h00 + k01 * h01, k00 * h10 + k01 * h11,
                        k10 * h00 + k11 * h01, k10 * h10 + k11 * h11])
                    col = jnp.where(is_upd, col - corr, col)
                    # init at slot s_i == g: whole column overwritten with
                    # the cross strip's local columns — comp (p,q) of the
                    # column is comp (q,p) of the stored cross strip (the
                    # own diagonal block is pre-patched into CRbuf)
                    over = CRb[i][jnp.array([0, 2, 1, 3])]       # (4, Nl)
                    col = jnp.where(is_init & (s_i == g), over, col)
                    # init at another slot: row s_i of this column becomes
                    # the cross strip's column g (if s_i is a local row)
                    hit_row = (rows == (s_i - off))[None, :]
                    col = jnp.where(is_init & (s_i != g) & hit_row,
                                    cr_g[i][:, None], col)
                return col

            def body(carry, inp):
                s, bufs, diag, stopped, j = carry
                if known:
                    z, v, g = inp
                    g = g.astype(jnp.int32)
                else:
                    z, v = inp
                Kb, HSb, CRb, gb, kb = bufs
                if known:
                    # out-of-range id -> full no-op (no phantom n_seen
                    # bump); matches the sequential step
                    v = v & (g >= 0) & (g < N)
                    g_loc = g - off
                    owns = (g_loc >= 0) & (g_loc < n_local)
                    g_safe = jnp.clip(g_loc, 0, n_local - 1).astype(jnp.int32)
                    seen = jax.lax.psum(
                        jnp.where(owns,
                                  s.seen[g_safe].astype(jnp.int32), 0),
                        "map") > 0
                    is_new = v & ~seen
                    do_update = v & seen
                    is_overflow = jnp.bool_(False)
                else:
                    # reference first-hit gating against the CARRIED own-
                    # block diagonal (the grid itself is never read here)
                    act = v & ~stopped
                    any_hit, first, d_first = _associate_comp(
                        config, s.mean_r, s.mm2, s.cov_rr, s.rm6, s.seen,
                        z, R, n_local, diag)
                    no_seen = s.n_seen == 0
                    cap_full = s.n_seen >= N
                    first_match = d_first < config.match_gate
                    is_match = act & ~no_seen & any_hit & first_match
                    want_new = act & (no_seen | ~any_hit)
                    is_new = want_new & ~cap_full
                    is_overflow = want_new & cap_full
                    do_update = is_match
                    new_slot = jnp.minimum(s.n_seen, N - 1).astype(jnp.int32)
                    g = jnp.where(is_match, first, new_slot).astype(jnp.int32)
                    g_loc = g - off
                    owns = (g_loc >= 0) & (g_loc < n_local)
                    g_safe = jnp.clip(g_loc, 0, n_local - 1).astype(jnp.int32)

                w_own = jnp.where(owns, 1.0, 0.0).astype(dtype)
                # ---- measurement geometry off the sequential means ----
                mj = jax.lax.psum(w_own * s.mm2[:, g_safe], "map")   # (2,)
                H5, z_hat = _h5_coeffs(s.mean_r, mj, dtype)
                dz = z - z_hat
                if config.wrap_innovation:
                    dz = dz.at[1].set(se2.normalize_angle(dz[1]))

                # ---- UPDATE branch: gains from strips + reconstructed col
                rm_j = jax.lax.psum(w_own * s.rm6[:, g_safe],
                                    "map").reshape(3, 2)
                SHt_r = jnp.matmul(
                    jnp.concatenate([s.cov_rr, rm_j], axis=1), H5.T,
                    precision=PRECISION)                          # (3, 2)
                col4 = col_at(bufs, j, g)                         # (4, Nl)
                # SHt comps s4[p*2+q] = sum_k cols5[p,k] H5[q,k] where
                # cols5[p, k<3] = rm6[k*2+p] and cols5[p, 3+t] = col4[p*2+t]
                s4 = jnp.stack([
                    s.rm6[0 + p] * H5[q, 0] + s.rm6[2 + p] * H5[q, 1]
                    + s.rm6[4 + p] * H5[q, 2]
                    + col4[p * 2 + 0] * H5[q, 3] + col4[p * 2 + 1] * H5[q, 4]
                    for p in range(2) for q in range(2)])          # (4, Nl)
                SHt_j = jax.lax.psum(w_own * s4[:, g_safe],
                                     "map").reshape(2, 2)
                psi = jnp.matmul(
                    H5, jnp.concatenate([SHt_r, SHt_j], axis=0),
                    precision=PRECISION) + R
                psi_inv = _inv2x2(psi)
                K_r = jnp.matmul(SHt_r, psi_inv, precision=PRECISION)
                # gain comps k4[p*2+r] = s4[p*2+0] psi_inv[0,r]
                #                      + s4[p*2+1] psi_inv[1,r]
                k4 = jnp.stack([
                    s4[p * 2 + 0] * psi_inv[0, r] + s4[p * 2 + 1] * psi_inv[1, r]
                    for p in range(2) for r in range(2)])          # (4, Nl)

                upd_mean_r = s.mean_r + jnp.matmul(K_r, dz,
                                                   precision=PRECISION)
                upd_mean_r = upd_mean_r.at[0].set(
                    se2.normalize_angle(upd_mean_r[0]))
                upd_mm2 = s.mm2 + jnp.stack([k4[0] * dz[0] + k4[1] * dz[1],
                                             k4[2] * dz[0] + k4[3] * dz[1]])
                upd_cov_rr = s.cov_rr - jnp.matmul(K_r, SHt_r.T,
                                                   precision=PRECISION)
                if config.symmetrize:
                    upd_cov_rr = 0.5 * (upd_cov_rr + upd_cov_rr.T)
                # rm6[i*2+p] -= K_r[i,0] s4[p*2+0] + K_r[i,1] s4[p*2+1]
                upd_rm6 = s.rm6 - jnp.stack([
                    K_r[i, 0] * s4[p * 2 + 0] + K_r[i, 1] * s4[p * 2 + 1]
                    for i in range(3) for p in range(2)])

                # ---- INIT branch: strips only; grid writes buffered ----
                th, x, y = s.mean_r[0], s.mean_r[1], s.mean_r[2]
                a = z[1] + th
                r_ = z[0]
                sa, ca = jnp.sin(a), jnp.cos(a)
                m_new = jnp.stack([x + r_ * ca, y + r_ * sa])
                Gx = jnp.stack(
                    [jnp.stack([-r_ * sa, jnp.ones_like(r_),
                                jnp.zeros_like(r_)]),
                     jnp.stack([r_ * ca, jnp.zeros_like(r_),
                                jnp.ones_like(r_)])])
                Gz = jnp.stack([jnp.stack([ca, -r_ * sa]),
                                jnp.stack([sa, r_ * ca])])
                # LOCAL columns of the init cross strip — each shard holds
                # exactly its slice of Sigma_{m_new, m_k} = Gx Sigma_{r, m_k},
                # so NO per-measurement all_gather is needed. comps
                # cross4[p*2+q] = sum_i Gx[p,i] rm6[i*2+q]
                cross4 = jnp.stack([
                    Gx[p, 0] * s.rm6[0 + q] + Gx[p, 1] * s.rm6[2 + q]
                    + Gx[p, 2] * s.rm6[4 + q]
                    for p in range(2) for q in range(2)])           # (4, Nl)
                B_own = (jnp.matmul(
                    jnp.matmul(Gx, s.cov_rr, precision=PRECISION), Gx.T,
                    precision=PRECISION)
                    + jnp.matmul(jnp.matmul(Gz, R, precision=PRECISION),
                                 Gz.T, precision=PRECISION))
                # pre-patch the own column with the own 2x2 block so both
                # the column reconstruction and the final replay land B_own
                # at the (slot, slot) diagonal without a separate buffer
                cross4 = jnp.where(
                    owns,
                    jax.lax.dynamic_update_slice(
                        cross4, B_own.reshape(4, 1),
                        (jnp.int32(0), g_safe)),
                    cross4)
                cross_r = jnp.matmul(Gx, s.cov_rr, precision=PRECISION).T
                ini_mm2 = jnp.where(
                    owns, jax.lax.dynamic_update_slice(
                        s.mm2, m_new.reshape(2, 1),
                        (jnp.int32(0), g_safe)), s.mm2)
                ini_rm6 = jnp.where(
                    owns, jax.lax.dynamic_update_slice(
                        s.rm6, cross_r.reshape(6, 1),
                        (jnp.int32(0), g_safe)), s.rm6)
                seen_upd = jnp.where(
                    owns, s.seen.at[g_safe].set(True), s.seen)

                # ---- select sequential state ----
                s = s._replace(
                    mean_r=jnp.where(do_update, upd_mean_r, s.mean_r),
                    mm2=jnp.where(do_update, upd_mm2,
                                  jnp.where(is_new, ini_mm2, s.mm2)),
                    cov_rr=jnp.where(do_update, upd_cov_rr, s.cov_rr),
                    rm6=jnp.where(do_update, upd_rm6,
                                  jnp.where(is_new, ini_rm6, s.rm6)),
                    n_seen=s.n_seen + is_new.astype(s.n_seen.dtype),
                    seen=jnp.where(is_new, seen_upd, s.seen))

                # ---- carried own-block diagonal (association input) ----
                # diag[p*2+r] -= k4[p*2+0] s4[r*2+0] + k4[p*2+1] s4[r*2+1]
                diag_upd = diag - jnp.stack([
                    k4[p * 2 + 0] * s4[r * 2 + 0]
                    + k4[p * 2 + 1] * s4[r * 2 + 1]
                    for p in range(2) for r in range(2)])
                diag = jnp.where(do_update, diag_upd, diag)
                hit_own = (ii_loc == g_loc)[None, :]
                diag = jnp.where(is_new & hit_own,
                                 B_own.reshape(4, 1), diag)

                # ---- record the op ----
                kind = jnp.where(do_update, 1, jnp.where(is_new, 2, 0)
                                 ).astype(jnp.int32)
                zK = jnp.where(do_update, k4, jnp.zeros_like(k4))
                zHS = jnp.where(do_update, s4, jnp.zeros_like(s4))
                bufs = (
                    jax.lax.dynamic_update_index_in_dim(Kb, zK, j, axis=0),
                    jax.lax.dynamic_update_index_in_dim(HSb, zHS, j, axis=0),
                    jax.lax.dynamic_update_index_in_dim(
                        CRb, jnp.where(is_new, cross4,
                                       jnp.zeros_like(cross4)), j,
                        axis=0),
                    jax.lax.dynamic_update_index_in_dim(
                        gb, jnp.where(kind > 0, g, -1), j, axis=0),
                    jax.lax.dynamic_update_index_in_dim(kb, kind, j, axis=0),
                )
                return (s, bufs, diag, stopped | is_overflow, j + 1), None

            bufs0 = (Kbuf, HSbuf, CRbuf, gbuf, kindbuf)
            xs = (zs1, va1, id1) if known else (zs1, va1)
            # the scan body never touches the raw grid (columns come from
            # mm0cT, association from the carried diag) — the grid stays
            # OUT of the while-loop carry so layout assignment cannot
            # relayout it
            (s_out, bufs, diag_out, _, _), _ = jax.lax.scan(
                body, (s0, bufs0, diag4, jnp.bool_(False), jnp.int32(0)),
                xs, unroll=meas_unroll)
            st1 = st1._replace(
                mean_r=s_out.mean_r,
                mean_m=s_out.mm2.T,
                cov_rr=s_out.cov_rr,
                cov_rm=jnp.transpose(
                    s_out.rm6.reshape(3, 2, n_local), (0, 2, 1)),
                diag4=diag_out,
                n_seen=s_out.n_seen,
                seen=s_out.seen)
            Kb, HSb, CRb, gb, kb = bufs

            # ---- ONE fused grid pass: overwrites + combined rank-2M ----
            # the tick's only O(N)-scale collectives: assemble the global
            # H-Sigma strips and init cross strips from the shard-local
            # buffers (2 x 16*M*N bytes per tick, overlappable with the
            # mask/flatten prologue below)
            HSfull = jax.lax.all_gather(HSb, "map", axis=2,
                                        tiled=True)               # (M,4,N)
            CRfull = jax.lax.all_gather(CRb, "map", axis=2,
                                        tiled=True)               # (M,4,N)

            iota = jnp.arange(M, dtype=jnp.int32)
            is_init_op = kb == 2
            grow = off + jnp.arange(n_local, dtype=jnp.int32)      # (Nl,)
            gcol = jnp.arange(N, dtype=jnp.int32)                  # (N,)
            rowT = jnp.max(jnp.where(is_init_op[:, None]
                                     & (gb[:, None] == grow[None, :]),
                                     iota[:, None], -1), axis=0)   # (Nl,)
            colT = jnp.max(jnp.where(is_init_op[:, None]
                                     & (gb[:, None] == gcol[None, :]),
                                     iota[:, None], -1), axis=0)   # (N,)

            Kmask = Kb * (iota[:, None] > rowT[None, :]
                          )[:, None, :].astype(Kb.dtype)           # (M,4,Nl)
            HSmask = HSfull * (iota[:, None] > colT[None, :]
                               )[:, None, :].astype(HSfull.dtype)  # (M,4,N)

            # the grid pass runs per COMPONENT PLANE — every operand is
            # a large-by-large 2D array, so no op in the pass (select,
            # matmul) can acquire an interleaved lane-padded layout. The
            # XLA schedule and the Pallas kernel share identical operands
            # (ops/pallas/grid_update.py). Comp buffers [i, p*2+c, n]
            # reshape to:
            #   A[p][n, 2i+c]    = Kmask[i, p*2+c, n]
            #   B[r][2i+c, m]    = HSmask[i, r*2+c, m]
            #   crow[p, r, i, m] = CRfull[i, p*2+r, m]  (row overwrites)
            #   ccol[p, r, n, i] = CRb[i, r*2+p, n]     (col overwrites,
            #                                            comp-swapped)
            A = jnp.transpose(Kmask.reshape(M, 2, 2, n_local),
                              (1, 3, 0, 2)).reshape(2, n_local, 2 * M)
            Bm = jnp.transpose(HSmask.reshape(M, 2, 2, N),
                               (1, 0, 2, 3)).reshape(2, 2 * M, N)
            crow = jnp.transpose(CRfull.reshape(M, 2, 2, N), (1, 2, 0, 3))
            ccol = jnp.transpose(CRb.reshape(M, 2, 2, n_local),
                                 (2, 1, 3, 0))
            if grid_kernel:
                cov = _gu.fused_grid_update(
                    st1.cov_mm, A, Bm, crow, ccol, rowT, colT,
                    interpret=kernel_interpret)
            else:
                cov = reference_grid_update(
                    st1.cov_mm, A, Bm, crow, ccol, rowT, colT)
            return st1._replace(cov_mm=cov)

        if known:
            return jax.vmap(one)(st, twist, zs, valid, ids)
        return jax.vmap(one, in_axes=(0, 0, 0, 0, None))(
            st, twist, zs, valid, None)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs, out_specs=specs,
                   check_vma=False)
    return jax.jit(fn)


def make_sharded_deferred_step(config: EKFConfig, mesh: Mesh, batch: int,
                               max_meas: int, grid_kernel: bool = False,
                               kernel_interpret: bool = False,
                               meas_unroll: bool = False):
    """Known-association deferred tick: semantics of
    :func:`make_sharded_step`, one grid pass per tick (see
    :func:`_make_sharded_deferred`). ``grid_kernel=True`` runs the grid
    pass as the fused Pallas kernel (f32, power-of-two planes)."""
    return _make_sharded_deferred(config, mesh, batch, max_meas, known=True,
                                  grid_kernel=grid_kernel,
                                  kernel_interpret=kernel_interpret,
                                  meas_unroll=meas_unroll)


def make_sharded_deferred_unknown_step(config: EKFConfig, mesh: Mesh,
                                       batch: int, max_meas: int,
                                       grid_kernel: bool = False,
                                       kernel_interpret: bool = False,
                                       meas_unroll: bool = False):
    """Unknown-association deferred tick: semantics of
    :func:`make_sharded_unknown_step` (reference first-hit Mahalanobis
    gating, PARITY P2/P5), one grid pass per tick. Association scores
    against a sequentially-carried own-block diagonal strip instead of
    reading the grid. ``grid_kernel`` as in
    :func:`make_sharded_deferred_step`."""
    return _make_sharded_deferred(config, mesh, batch, max_meas, known=False,
                                  grid_kernel=grid_kernel,
                                  kernel_interpret=kernel_interpret,
                                  meas_unroll=meas_unroll)


def make_sharded_unknown_step(config: EKFConfig, mesh: Mesh, batch: int,
                              max_meas: int):
    """Mesh-sharded SLAM tick with UNKNOWN association: the reference's
    Mahalanobis first-hit gating (SURVEY section 2.4) resolved globally via
    pmin over shards. Semantics mirror ``models.ekf_slam.step`` exactly:
    match -> update; gray-zone -> skip; all-far -> new landmark at the next
    sequential slot (analytic init); capacity overflow -> the tick stops
    processing further measurements (sticky flag).

    Returns ``step(state, twist (B,3), zs (B,M,2), valid (B,M), Q, R)``.
    """
    N = config.num_landmarks
    n_map = mesh.shape["map"]
    if N % n_map:
        raise ValueError(f"num_landmarks {N} not divisible by map={n_map}")
    n_local = N // n_map

    specs = state_sharding(mesh)
    in_specs = (specs, P("data", None), P("data", None, None),
                P("data", None), P(None, None), P(None, None))

    def shard_fn(st, twist, zs, valid, Q, R):
        def one(st1, tw1, zs1, va1):
            st1 = _predict_shard(config, st1, tw1, Q)

            def body(carry, inp):
                s, stopped = carry
                z, v = inp
                act = v & ~stopped

                any_hit, first, d_first = _associate_shard(
                    config, s, z, R, n_local)
                no_seen = s.n_seen == 0
                cap_full = s.n_seen >= N
                first_match = d_first < config.match_gate

                is_match = act & ~no_seen & any_hit & first_match
                is_skip = act & ~no_seen & any_hit & ~first_match
                want_new = act & (no_seen | ~any_hit)
                is_new = want_new & ~cap_full
                is_overflow = want_new & cap_full

                new_slot = jnp.minimum(s.n_seen, N - 1).astype(jnp.int32)
                j_eff = jnp.where(is_match, first, new_slot)

                # analytic init at the new slot
                s_init = _init_landmark_shard(config, s, z, j_eff, R,
                                              n_local)
                shard = jax.lax.axis_index("map")
                j_loc = j_eff - shard * n_local
                owns = (j_loc >= 0) & (j_loc < n_local)
                seen_upd = jnp.where(
                    owns,
                    s.seen.at[jnp.clip(j_loc, 0, n_local - 1)].set(True),
                    s.seen)
                s_init = s_init._replace(n_seen=s.n_seen + 1, seen=seen_upd)
                pre = jax.tree_util.tree_map(
                    lambda a_, b_: jnp.where(is_new, a_, b_), s_init, s)

                upd = _update_shard(config, pre, z, j_eff, R, n_local)
                s = jax.tree_util.tree_map(
                    lambda a_, b_: jnp.where(is_match, a_, b_), upd, pre)
                return (s, stopped | is_overflow), None

            (st1, _), _ = jax.lax.scan(
                body, (st1, jnp.bool_(False)), (zs1, va1))
            return st1

        return jax.vmap(one)(st, twist, zs, valid)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs, out_specs=specs,
                   check_vma=False)
    return jax.jit(fn)
