"""Batch-on-lanes dense EKF-SLAM: the explicitly-batched engine.

Same math and semantics as ``models.ekf_slam`` (the reference
``ExtendedKalman``, nuslam/src/slam_library.cpp:65-282 + the slam node's
measurement loop, slam.cpp:279-318), but the batch dimension is TRAILING
on every array instead of leading-under-vmap:

    mean (D, B)   cov (D, D, B)   n_seen (B,)   seen (N, B)

Why (BENCH_NOTES pathology 9, applied to the batch axis — the
"batch-on-lanes" layout): the engine's first accelerator tiled the last
two dims of every array onto (8, 128) sublane/lane tiles. The vmapped engine's
``(B, 27, 27)`` covariances pad to ``(B, 32, 128)`` — ~5.6x physical HBM
inflation and 27/128 lane utilization on every covariance pass. With the
batch TRAILING, ``(27, 27, 2048)`` tiles as ``(27, 32, 2048)`` — ~1.19x
— and every elementwise pass runs at full lane width. The association
chain's ``(N, B)`` component arrays (vs vmap's ``(B, N)`` with N=12..24
padding to 128 lanes) get the same treatment.

A second structural win: per-world predicates (``(B,)`` masks) broadcast
against trailing-batch arrays *naturally* (numpy broadcasting aligns
trailing dims), so the branchless select trees cost no reshapes.

The implementation is the r04 broadcast-arithmetic decomposition of the
dense engine (no matmuls on the covariance path, no gathers, no
scatters), transcribed to explicit batch; parity with the vmapped engine
is pinned by tests/test_ekf_batch.py (f64 tight + f32 decision
equality). vmap cannot express this layout (its batching rule inserts
the batch dim where it chooses, leading for intermediates), hence the
explicit transcription.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import se2
from .ekf_slam import (ASSOC_MATCH, ASSOC_NEW, ASSOC_OVERFLOW, ASSOC_SKIP,
                       EKFConfig, PRECISION, _motion_delta)
from typing import NamedTuple


class BatchState(NamedTuple):
    """Batch-trailing filter state (D = 3 + 2N)."""

    mean: jnp.ndarray    # (D, B)
    cov: jnp.ndarray     # (D, D, B)
    n_seen: jnp.ndarray  # (B,) int32
    seen: jnp.ndarray    # (N, B) bool


def init(config: EKFConfig, batch: int, robot_pose=None,
         dtype=jnp.float32) -> BatchState:
    D = config.dim
    N = config.num_landmarks
    mean = jnp.zeros((D, batch), dtype)
    if robot_pose is not None:
        mean = mean.at[:3].set(
            jnp.broadcast_to(jnp.asarray(robot_pose, dtype)[:, None],
                             (3, batch)))
    diag = jnp.zeros((D,), dtype).at[3:3 + 2 * N].set(
        jnp.asarray(config.init_cov, dtype))
    cov = jnp.broadcast_to((jnp.diag(diag))[:, :, None], (D, D, batch)
                           ).astype(dtype)
    return BatchState(mean=mean, cov=cov,
                      n_seen=jnp.zeros((batch,), jnp.int32),
                      seen=jnp.zeros((N, batch), bool))


def from_vmapped(st) -> BatchState:
    """Re-layout a leading-batch (vmapped) EKFState tree into batch-trailing
    (tests / migration; one transpose each way)."""
    return BatchState(mean=st.mean.T, cov=jnp.transpose(st.cov, (1, 2, 0)),
                      n_seen=st.n_seen, seen=st.seen.T)


def to_vmapped(st: BatchState):
    from .ekf_slam import EKFState
    return EKFState(mean=st.mean.T, cov=jnp.transpose(st.cov, (2, 0, 1)),
                    n_seen=st.n_seen, seen=st.seen.T)


# ---------------------------------------------------------------------------
# Predict (rank-2 strip, ekf_slam.predict transcribed)
# ---------------------------------------------------------------------------

def predict(config: EKFConfig, st: BatchState, twist, Q) -> BatchState:
    """``twist`` is (B, 3) (the natural vmapped-producer layout)."""
    theta = st.mean[0]                                  # (B,)
    dq, b = _motion_delta(theta, jnp.asarray(twist, st.mean.dtype))
    dqT = dq.T                                          # (3, B)
    bT = b.T                                            # (2, B)
    mean = st.mean.at[:3].add(dqT)

    cov = st.cov
    r0 = cov[0]                                         # (D, B)
    s00 = cov[0, 0]                                     # (B,)
    strip = bT[:, None, :] * r0[None, :, :]             # (2, D, B)
    cov = cov.at[1:3, :, :].add(strip)
    cov = cov.at[:, 1:3, :].add(jnp.transpose(strip, (1, 0, 2)))
    cov = cov.at[1:3, 1:3, :].add(s00 * bT[:, None, :] * bT[None, :, :])
    cov = cov.at[:3, :3, :].add(jnp.asarray(Q, cov.dtype)[:, :, None])
    return st._replace(mean=mean, cov=cov)


# ---------------------------------------------------------------------------
# Measurement geometry
# ---------------------------------------------------------------------------

def _slot_masks(D, j, dtype):
    """(D, B) 0/1 masks for state entries ``3+2j`` and ``4+2j``."""
    lane = jnp.arange(D)[:, None]
    idx = (3 + 2 * j)[None, :]
    return ((lane == idx).astype(dtype), (lane == idx + 1).astype(dtype))


def _landmark_delta(mean, j):
    dt = mean.dtype
    m0, m1 = _slot_masks(mean.shape[0], j, dt)
    mx = jnp.sum(mean * m0, axis=0)                     # (B,)
    my = jnp.sum(mean * m1, axis=0)
    dx = mx - mean[1]
    dy = my - mean[2]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dt))
    return dx, dy, d, jnp.sqrt(d), m0, m1


# ---------------------------------------------------------------------------
# Update (rank-2, broadcast-arithmetic — ekf_slam.update transcribed)
# ---------------------------------------------------------------------------

def update(config: EKFConfig, st: BatchState, z, j, R) -> BatchState:
    """``z`` (B, 2), ``j`` (B,) int32."""
    mean, cov = st.mean, st.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)

    dx, dy, d, sq, m0, m1 = _landmark_delta(mean, j)
    # H5 component scalars (B,) — the 9 nonzeros of H
    a_ = dx / sq
    b_ = dy / sq
    c_ = dy / d
    e_ = -dx / d
    zero = jnp.zeros_like(dx)
    one = jnp.ones_like(dx)
    w = ((zero, -a_, -b_, a_, b_), (-one, c_, e_, -c_, -e_))

    # Sigma H^T columns: 3 robot cols are plain slices; the landmark pair
    # via one mask-reduce pass over cov
    cols_r = cov[:, :3, :]                              # (D, 3, B)
    cm0 = jnp.sum(cov * m0[None, :, :], axis=1)         # (D, B)
    cm1 = jnp.sum(cov * m1[None, :, :], axis=1)
    SHt = []
    for q in range(2):
        wq = w[q]
        SHt.append(cols_r[:, 0] * wq[0][None, :]
                   + cols_r[:, 1] * wq[1][None, :]
                   + cols_r[:, 2] * wq[2][None, :]
                   + cm0 * wq[3][None, :] + cm1 * wq[4][None, :])  # (D, B)

    # psi = H (Sigma H^T) + R from the same 5 rows of SHt
    psi = [[None, None], [None, None]]
    for q in range(2):
        r5 = [SHt[q][0], SHt[q][1], SHt[q][2],
              jnp.sum(SHt[q] * m0, axis=0), jnp.sum(SHt[q] * m1, axis=0)]
        for p in range(2):
            wp = w[p]
            psi[p][q] = (wp[0] * r5[0] + wp[1] * r5[1] + wp[2] * r5[2]
                         + wp[3] * r5[3] + wp[4] * r5[4]) + R[p, q]

    z_hat0 = sq
    z_hat1 = se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0])
    dz0 = z[:, 0] - z_hat0
    dz1 = z[:, 1] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0]
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.full_like(det, 1e-30), det)
    i00 = psi[1][1] / det
    i01 = -psi[0][1] / det
    i10 = -psi[1][0] / det
    i11 = psi[0][0] / det
    K0 = SHt[0] * i00[None, :] + SHt[1] * i10[None, :]  # (D, B)
    K1 = SHt[0] * i01[None, :] + SHt[1] * i11[None, :]
    mean = mean + K0 * dz0[None, :] + K1 * dz1[None, :]

    mean = mean.at[0].set(se2.normalize_angle(mean[0]))
    if config.symmetrize:
        # symmetrized downdate: 0.5 (cov' + cov'^T) with
        # cov' = cov - K (SHt)^T equals cov - 0.5 (K⊗S + S⊗K) whenever
        # the incoming cov is symmetric (every op in this engine writes
        # symmetric terms, so it holds to ulps). The explicit transpose
        # form materializes a full (D, D, B) layout copy per measurement;
        # this form never transposes the big array.
        cov = cov - 0.5 * (K0[:, None, :] * SHt[0][None, :, :]
                           + SHt[0][:, None, :] * K0[None, :, :]
                           + K1[:, None, :] * SHt[1][None, :, :]
                           + SHt[1][:, None, :] * K1[None, :, :])
    else:
        cov = cov - (K0[:, None, :] * SHt[0][None, :, :]
                     + K1[:, None, :] * SHt[1][None, :, :])
    return st._replace(mean=mean, cov=cov)


# ---------------------------------------------------------------------------
# Landmark initialization (mask-arithmetic — ekf_slam transcribed)
# ---------------------------------------------------------------------------

def init_landmark(config: EKFConfig, st: BatchState, z, j) -> BatchState:
    mean = st.mean
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    ang = z[:, 1] + mean[0]                             # (B,)
    gx = mean[1] + z[:, 0] * jnp.cos(ang)
    gy = mean[2] + z[:, 0] * jnp.sin(ang)
    m0, m1 = _slot_masks(mean.shape[0], j, dt)
    one = jnp.asarray(1.0, dt)
    mean = (mean * (one - m0) * (one - m1)
            + m0 * gx[None, :] + m1 * gy[None, :])
    return st._replace(mean=mean)


def _init_cov_comps(mean, cov, z, R):
    """First-observation covariance ingredients: ``cross`` (two (D, B)
    rows) and the 2x2 ``block`` components — depend only on theta, z, R
    and the CURRENT cov (not on the init'd mean slot). Shared by the
    dynamic mask-arithmetic writer and the static-slice writer."""
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)
    a = z[:, 1] + mean[0]
    r = z[:, 0]
    sa, ca = jnp.sin(a), jnp.cos(a)
    one = jnp.ones_like(r)
    zero = jnp.zeros_like(r)
    # Gx rows as component (B,) triples
    Gx = ((-r * sa, one, zero), (r * ca, zero, one))
    # cross[k] = Gx[k] . cov[:3]  -> (D, B)
    c3 = cov[:3]                                        # (3, D, B)
    cross = [Gx[k][0][None, :] * c3[0] + Gx[k][1][None, :] * c3[1]
             + Gx[k][2][None, :] * c3[2] for k in range(2)]
    # block = Gx crr Gx^T + Gz R Gz^T, components (B,)
    crr = cov[:3, :3]                                   # (3, 3, B)
    u = [[crr[i, 0] * Gx[k][0] + crr[i, 1] * Gx[k][1] + crr[i, 2] * Gx[k][2]
          for i in range(3)] for k in range(2)]         # u[k][i] (B,)
    gxc = [[Gx[p][0] * u[k][0] + Gx[p][1] * u[k][1] + Gx[p][2] * u[k][2]
            for k in range(2)] for p in range(2)]
    Gz = ((ca, -r * sa), (sa, r * ca))
    gzr = [[Gz[p][0] * (R[0, 0] * Gz[q][0] + R[0, 1] * Gz[q][1])
            + Gz[p][1] * (R[1, 0] * Gz[q][0] + R[1, 1] * Gz[q][1])
            for q in range(2)] for p in range(2)]
    block = [[gxc[p][q] + gzr[p][q] for q in range(2)] for p in range(2)]
    return cross, block


def _analytic_init_cov(st: BatchState, z, j, R) -> jnp.ndarray:
    """First-observation covariance blocks, batch-trailing mask arithmetic
    (the exact infinite-prior limit; see ekf_slam._analytic_init_cov)."""
    mean, cov = st.mean, st.cov
    dt = mean.dtype
    cross, block = _init_cov_comps(mean, cov, z, R)

    m0, m1 = _slot_masks(cov.shape[0], j, dt)
    onec = jnp.asarray(1.0, dt)
    inrow = (m0 + m1)[:, None, :]                       # (D, 1, B)
    incol = (m0 + m1)[None, :, :]                       # (1, D, B)
    rowv = (m0[:, None, :] * cross[0][None, :, :]
            + m1[:, None, :] * cross[1][None, :, :])
    colv = (cross[0][:, None, :] * m0[None, :, :]
            + cross[1][:, None, :] * m1[None, :, :])
    blockv = (m0[:, None, :] * m0[None, :, :] * block[0][0]
              + m0[:, None, :] * m1[None, :, :] * block[0][1]
              + m1[:, None, :] * m0[None, :, :] * block[1][0]
              + m1[:, None, :] * m1[None, :, :] * block[1][1])
    return (cov * (onec - inrow) * (onec - incol)
            + rowv * (onec - incol)
            + colv * (onec - inrow)
            + blockv)


# ---------------------------------------------------------------------------
# Association (componentized w-chain — ekf_slam.associate transcribed)
# ---------------------------------------------------------------------------

class BatchAssoc(NamedTuple):
    outcome: jnp.ndarray   # (B,) int32
    index: jnp.ndarray     # (B,) int32
    distances: jnp.ndarray # (N, B)


def associate(config: EKFConfig, st: BatchState, z, R) -> BatchAssoc:
    N = config.num_landmarks
    mean, cov = st.mean, st.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)

    m = mean[3:3 + 2 * N].reshape(N, 2, -1)             # (N, 2, B)
    dx = m[:, 0] - mean[1][None, :]                     # (N, B)
    dy = m[:, 1] - mean[2][None, :]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dt))
    sq = jnp.sqrt(d)

    crr = cov[:3, :3]                                   # (3, 3, B)
    Srm = cov[:3, 3:3 + 2 * N].reshape(3, N, 2, -1)     # (3, N, 2, B)
    rows = cov[3:3 + 2 * N, 3:3 + 2 * N].reshape(N, 2, N, 2, -1)
    eyeN = jnp.eye(N, dtype=dt)
    Smm = jnp.einsum("npmqb,nm->npqb", rows, eyeN,
                     precision=PRECISION)               # (N, 2, 2, B)
    a_ = dx / sq
    b_ = dy / sq
    c_ = dy / d
    e_ = -dx / d
    zero = jnp.zeros_like(dx)
    one = jnp.ones_like(dx)
    w = ((zero, -a_, -b_, a_, b_), (-one, c_, e_, -c_, -e_))
    rm = [Srm[i, :, p] for i in range(3) for p in range(2)]   # (N, B)
    dg = [Smm[:, p, q] for p in range(2) for q in range(2)]   # (N, B)
    psi_c = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(crr[k, 0][None, :] * wl[0] + crr[k, 1][None, :] * wl[1]
                     + crr[k, 2][None, :] * wl[2]
                     + rm[k * 2 + 0] * wl[3] + rm[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm[0 + p] * wl[0] + rm[2 + p] * wl[1]
                     + rm[4 + p] * wl[2]
                     + dg[p * 2 + 0] * wl[3] + dg[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi_c[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                           + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]

    z_hat1 = se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0][None, :])
    dz0 = z[:, 0][None, :] - sq                         # (N, B)
    dz1 = z[:, 1][None, :] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = psi_c[0][0] * psi_c[1][1] - psi_c[0][1] * psi_c[1][0]
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.full_like(det, 1e-30), det)
    dist = (dz0 * (psi_c[1][1] * dz0 - psi_c[0][1] * dz1)
            + dz1 * (-psi_c[1][0] * dz0 + psi_c[0][0] * dz1)) / det
    dist = jnp.where(st.seen, dist, jnp.inf)            # (N, B)

    if config.assoc_mode == "nearest":
        first = jnp.argmin(dist, axis=0).astype(jnp.int32)   # (B,)
        d_first = jnp.min(dist, axis=0)
        any_hit = d_first < config.new_gate
        first_match = d_first < config.match_gate
    else:
        lt_new = dist < config.new_gate
        any_hit = jnp.any(lt_new, axis=0)
        first = jnp.argmax(lt_new, axis=0).astype(jnp.int32)
        d_first = jnp.sum(
            jnp.where(jnp.arange(N)[:, None] == first[None, :],
                      jnp.where(jnp.isfinite(dist), dist, 0.0), 0.0),
            axis=0)
        first_match = jnp.where(any_hit, d_first < config.match_gate,
                                jnp.bool_(False))

    no_seen = st.n_seen == 0
    capacity_full = st.n_seen >= N
    outcome = jnp.where(
        no_seen,
        jnp.where(capacity_full, ASSOC_OVERFLOW, ASSOC_NEW),
        jnp.where(
            any_hit,
            jnp.where(first_match, ASSOC_MATCH, ASSOC_SKIP),
            jnp.where(capacity_full, ASSOC_OVERFLOW, ASSOC_NEW),
        ),
    ).astype(jnp.int32)
    index = jnp.where(outcome == ASSOC_MATCH, first,
                      jnp.minimum(st.n_seen, N - 1)).astype(jnp.int32)
    return BatchAssoc(outcome=outcome, index=index, distances=dist)


# ---------------------------------------------------------------------------
# Tick drivers (control flow of ekf_slam.step_measurement / step /
# known_association_step, with (B,) predicates)
# ---------------------------------------------------------------------------

def _where_state(pred, a: BatchState, b: BatchState) -> BatchState:
    """Per-world select; (B,) pred broadcasts against trailing batch."""
    return BatchState(
        mean=jnp.where(pred, a.mean, b.mean),
        cov=jnp.where(pred, a.cov, b.cov),
        n_seen=jnp.where(pred, a.n_seen, b.n_seen),
        seen=jnp.where(pred, a.seen, b.seen),
    )


def step_measurement(config: EKFConfig, st: BatchState, z, valid, stopped,
                     R):
    """``z`` (B, 2), ``valid``/``stopped`` (B,) bool."""
    res = associate(config, st, z, R)
    act = valid & ~stopped

    is_new = act & (res.outcome == ASSOC_NEW)
    is_match = act & (res.outcome == ASSOC_MATCH)
    is_overflow = act & (res.outcome == ASSOC_OVERFLOW)
    do_update = is_match if config.analytic_init else (is_new | is_match)

    st_init = init_landmark(config, st, z, res.index)
    if config.analytic_init:
        st_init = st_init._replace(cov=_analytic_init_cov(st_init, z,
                                                          res.index, R))
    pre = _where_state(is_new, st_init, st)
    pre = pre._replace(
        n_seen=jnp.where(is_new, st.n_seen + 1, st.n_seen),
        seen=st.seen | (is_new[None, :]
                        & (jnp.arange(st.seen.shape[0])[:, None]
                           == res.index[None, :])))

    upd = update(config, pre, z, res.index, R)
    new_state = _where_state(do_update, upd, pre)
    return new_state, stopped | is_overflow


def step(config: EKFConfig, st: BatchState, twist, zs, z_valid, Q, R
         ) -> BatchState:
    """One SLAM tick, unknown association. ``twist`` (B, 3), ``zs``
    (B, M, 2), ``z_valid`` (B, M)."""
    st = predict(config, st, twist, Q)
    zsT = jnp.transpose(jnp.asarray(zs), (1, 0, 2))     # (M, B, 2)
    validT = jnp.asarray(z_valid).T                     # (M, B)

    def body(carry, inp):
        s, stopped = carry
        z, valid = inp
        s, stopped = step_measurement(config, s, z, valid, stopped, R)
        return (s, stopped), None

    B = st.mean.shape[1]
    (st, _), _ = jax.lax.scan(
        body, (st, jnp.zeros((B,), bool)), (zsT, validT), unroll=True)
    return st


def known_association_step(config: EKFConfig, st: BatchState, twist, zs,
                           z_valid, z_ids, Q, R) -> BatchState:
    """Known-association tick. ``z_ids`` (B, M) int32; same capacity
    semantics as the dense engine (at/beyond-capacity id = sticky stop,
    negative id = no-op)."""
    st = predict(config, st, twist, Q)
    zsT = jnp.transpose(jnp.asarray(zs), (1, 0, 2))
    validT = jnp.asarray(z_valid).T
    idsT = jnp.asarray(z_ids).T                         # (M, B)
    N = config.num_landmarks

    def body(carry, inp):
        s, stopped = carry
        z, valid, j = inp
        overflow = j >= N
        valid = valid & ~stopped & ~overflow & (j >= 0)
        stopped = stopped | overflow
        j_safe = jnp.clip(j, 0, N - 1)
        seen_j = jnp.any(
            jnp.where(jnp.arange(N)[:, None] == j_safe[None, :],
                      s.seen, False), axis=0)
        is_new = valid & ~seen_j
        st_init = init_landmark(config, s, z, j_safe)
        if config.analytic_init:
            st_init = st_init._replace(
                cov=_analytic_init_cov(st_init, z, j_safe, R))
        st_init = st_init._replace(
            n_seen=s.n_seen + 1,
            seen=s.seen | (jnp.arange(N)[:, None] == j_safe[None, :]))
        pre = _where_state(is_new, st_init, s)
        do_update = (valid & seen_j) if config.analytic_init else valid
        upd = update(config, pre, z, j_safe, R)
        s = _where_state(do_update, upd, pre)
        return (s, stopped), None

    B = st.mean.shape[1]
    (st, _), _ = jax.lax.scan(
        body, (st, jnp.zeros((B,), bool)), (zsT, validT, idsT), unroll=True)
    return st
