"""EKF-SLAM core: predict / associate / update over a padded landmark map.

JAX re-design of the reference ``ExtendedKalman`` class
(``nuslam/include/nuslam/slam_library.hpp`` + ``nuslam/src/slam_library.cpp``).

State layout (identical to the reference, ``slam_library.cpp:39-63``)::

    zeta = [theta, x, y, m1x, m1y, ..., mNx, mNy]  in R^(3+2N)

but with a *fixed capacity* ``N`` plus an ``n_seen`` counter instead of the
reference's dynamically-grown notion of "seen landmarks" — dynamic structure
becomes static shapes + masks so everything jits, vmaps and scans.

The covariance math exploits the sparsity the reference ignores:

- ``A = I + B`` has only two nonzeros ``B[1,0], B[2,0]``
  (ref ``getA``, slam_library.cpp:127-148), so the propagate
  ``Sigma <- A Sigma A^T + Qbar`` (ref ``propagateUncertainty``,
  slam_library.cpp:96-108) is a **rank-2 strip update touching only rows/cols
  1:3** — O(D) work instead of the reference's dense O(D^3) triple product.
- ``H`` is 2xD with 9 nonzeros (ref ``linearizedMeasurementModel``,
  slam_library.cpp:162-186), so the Kalman update
  ``Sigma <- (I - K H) Sigma`` (ref ``update``, slam_library.cpp:263-282) is a
  **rank-2 outer-product update** — O(D^2) instead of O(D^3).
- Mahalanobis association (ref ``associateLandmark``,
  slam_library.cpp:188-253) needs only the robot-block strip of Sigma plus
  each landmark's 2x2 block — batched over all landmarks in O(N) with
  closed-form 2x2 inverses, replacing the reference's per-landmark dense
  ``H * Sigma * H^T`` (O(N * D^2)).

Behavioral parity notes (full list in PARITY.md):

- Association reproduces the reference's *first-hit* semantics exactly
  (SURVEY.md section 2.4): scanning landmarks in order, the first one with
  Mahalanobis distance < ``new_gate`` decides the outcome (match if
  < ``match_gate`` else skip); a new landmark is created only if every
  distance is >= ``new_gate``. The reference's "temporary state with candidate
  landmark N+1" (slam_library.cpp:204-207) never influences the loop (the
  candidate slot is only read by dead code, slam_library.cpp:224-226), so we
  score against the current state directly.
- Innovations are NOT angle-wrapped (the reference computes ``z - z_hat`` raw,
  slam_library.cpp:230/271); set ``wrap_innovation=True`` for the fixed
  behavior.
- The reference initializes unseen-landmark covariance to ``INT_MAX``
  (``initCov``, slam_library.cpp:24-33) and lets the first update collapse it.
  That is fine in float64 but catastrophically cancels in float32, so the
  default f32 path uses the mathematically-equivalent-in-the-limit *analytic
  first-observation initialization* (``analytic_init=True``); set it False
  (+ float64) for bit-faithful reference behavior.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import se2

# A GPU runs float32 matmuls in TF32 by default — fatal for EKF covariance
# algebra (rank-2 cancellations amplify the 10-bit mantissa error until the
# filter diverges). Every matmul in this module pins full f32.
PRECISION = jax.lax.Precision.HIGHEST

# Association outcomes (see `associate`).
ASSOC_MATCH = 0      # matched an existing landmark
ASSOC_SKIP = 1       # "gray area" — measurement ignored (ref slam_library.cpp:243-246)
ASSOC_NEW = 2        # new landmark created
ASSOC_OVERFLOW = 3   # capacity full — caller stops the tick (ref slam.cpp:301-316)

INT_MAX = 2147483647.0  # ref initCov, slam_library.cpp:31


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """Static configuration (hashable; safe to close over under jit)."""

    num_landmarks: int                 # capacity N (ref slam.cpp:71: 6)
    match_gate: float = 0.01           # ref slam_library.cpp:193
    new_gate: float = 60.0             # ref slam_library.cpp:194
    init_cov: float = INT_MAX          # unseen-landmark prior variance
    analytic_init: bool = True         # f32-safe first-observation init
    wrap_innovation: bool = False      # reference does not wrap (PARITY.md)
    symmetrize: bool = True            # re-symmetrize Sigma after updates
    # "first_hit": the reference's scan-order gating (SURVEY 2.4).
    # "nearest": statistically-sound nearest-neighbor gating (quality mode;
    # pair with chi-square gates like 5.99/13.8 and wrap_innovation=True).
    assoc_mode: str = "first_hit"

    @property
    def dim(self) -> int:
        return 3 + 2 * self.num_landmarks


class EKFState(NamedTuple):
    """Filter state: mean, covariance, per-slot landmark bookkeeping.

    ``seen`` is a per-slot bitmask rather than the reference's bare counter
    (slam_library.cpp:33 ``seen_landmarks``): with known-association ids,
    landmark k can be observed before landmark k-1, and a counter would mark
    the gap slots "seen" while they still hold the untouched huge prior —
    updates against such phantom slots are numerically catastrophic. For the
    reference's unknown-association mode slots fill strictly in order, so
    ``seen == (arange(N) < n_seen)`` and behavior is identical.
    """

    mean: jnp.ndarray    # (D,)  [theta, x, y, m1x, m1y, ...]
    cov: jnp.ndarray     # (D, D)
    n_seen: jnp.ndarray  # () int32 — number of initialized landmarks
    seen: jnp.ndarray    # (N,) bool — which slots are initialized


def init(config: EKFConfig, robot_pose, dtype=jnp.float32) -> EKFState:
    """Build the initial state (ref ctor slam_library.cpp:39-63 + initCov).

    ``robot_pose`` is ``[theta, x, y]``; map entries start at zero and the
    covariance is zero on the robot block, ``init_cov`` on the landmark
    diagonal (ref slam_library.cpp:24-33).
    """
    D = config.dim
    mean = jnp.zeros((D,), dtype).at[:3].set(jnp.asarray(robot_pose, dtype))
    # landmark diag = init_cov on the 2N landmark slots
    diag = jnp.zeros((D,), dtype).at[3:3 + 2 * config.num_landmarks].set(
        jnp.asarray(config.init_cov, dtype))
    return EKFState(mean=mean, cov=jnp.diag(diag), n_seen=jnp.int32(0),
                    seen=jnp.zeros((config.num_landmarks,), bool))


def cartesian2polar(x, y):
    """(x, y) -> [range, bearing] (ref slam_library.cpp:16-22)."""
    r = jnp.sqrt(x * x + y * y)
    phi = se2.normalize_angle(jnp.arctan2(y, x))
    return jnp.stack([r, phi], axis=-1)


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------

def _motion_delta(theta, twist):
    """Arc motion model increment + its two Jacobian entries.

    Ref ``predictEstimate`` (slam_library.cpp:71-94) and ``getA``
    (slam_library.cpp:127-148); the ``dth == 0`` branch becomes a branchless
    sinc-style limit. Returns ``(dq, b)`` with ``dq = [dth, dx, dy]`` and
    ``b = [B10, B20]`` (the only nonzeros of ``B = A - I``).
    """
    dth, dx = twist[..., 0], twist[..., 1]
    small = jnp.abs(dth) < 1e-7
    safe = jnp.where(small, jnp.ones_like(dth), dth)
    ratio = dx / safe  # v / omega (arc radius)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    st1, ct1 = jnp.sin(theta + dth), jnp.cos(theta + dth)
    dq_x = jnp.where(small, dx * ct, -ratio * st + ratio * st1)
    dq_y = jnp.where(small, dx * st, ratio * ct - ratio * ct1)
    b10 = jnp.where(small, -dx * st, -ratio * ct + ratio * ct1)
    b20 = jnp.where(small, dx * ct, -ratio * st + ratio * st1)
    dq = jnp.stack([dth, dq_x, dq_y], axis=-1)
    b = jnp.stack([b10, b20], axis=-1)
    return dq, b


def predict(config: EKFConfig, state: EKFState, twist, Q) -> EKFState:
    """Prediction step (ref ``predict``, slam_library.cpp:65-69).

    Mean: arc motion model on the robot block (theta NOT normalized here —
    the reference only normalizes in ``update``).

    Covariance: ``Sigma <- A Sigma A^T + Qbar`` with ``A = I + g e0^T`` where
    ``g`` has two nonzeros, expanded to the exact rank-2 strip update::

        Sigma' = Sigma + g r0^T + r0 g^T + Sigma00 g g^T + Qbar,  r0 = Sigma[0,:]

    touching only rows/cols 1:3 — O(D) work, entirely HBM-bandwidth-bound.
    ``Qbar`` adds ``Q`` on the top-left 3x3 only (ref
    ``expanded_process_noise``, slam_library.cpp:110-125).
    """
    theta = state.mean[0]
    dq, b = _motion_delta(theta, jnp.asarray(twist, state.mean.dtype))
    mean = state.mean.at[:3].add(dq)

    cov = state.cov
    r0 = cov[0, :]                          # (D,) original row 0
    s00 = cov[0, 0]
    strip = b[:, None] * r0[None, :]        # (2, D)
    cov = cov.at[1:3, :].add(strip)
    cov = cov.at[:, 1:3].add(strip.T)
    cov = cov.at[1:3, 1:3].add(s00 * (b[:, None] * b[None, :]))
    cov = cov.at[:3, :3].add(jnp.asarray(Q, cov.dtype))
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


def predict_dense(config: EKFConfig, state: EKFState, twist, Q) -> EKFState:
    """Literal dense ``A Sigma A^T + Qbar`` (O(D^3)) — test oracle for
    :func:`predict`, mirroring ref ``propagateUncertainty`` exactly."""
    D = config.dim
    theta = state.mean[0]
    dq, b = _motion_delta(theta, jnp.asarray(twist, state.mean.dtype))
    mean = state.mean.at[:3].add(dq)
    A = jnp.eye(D, dtype=state.cov.dtype)
    A = A.at[1, 0].add(b[0]).at[2, 0].add(b[1])
    Qbar = jnp.zeros((D, D), state.cov.dtype).at[:3, :3].set(
        jnp.asarray(Q, state.cov.dtype))
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    cov = mm(mm(A, state.cov), A.T) + Qbar
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


# ---------------------------------------------------------------------------
# Measurement model
# ---------------------------------------------------------------------------

def _slot_onehot(D, j, dtype):
    """(2, D) one-hot rows selecting state entries ``3+2j`` and ``4+2j``.

    Batch-index-dependent reads/writes in the hot path use one-hot
    MATVECS against these rows instead of ``dynamic_slice`` — under vmap
    a variable-offset slice is a gather on (B, D, D) operands, while a
    (2, D) matmul fuses with its consumers. (Chosen on the engine's first
    accelerator; not re-measured on a GPU.)"""
    lane = jnp.arange(D)
    idx = 3 + 2 * j
    return jnp.stack([(lane == idx).astype(dtype),
                      (lane == idx + 1).astype(dtype)])


# Above this state dim, slot selections on Sigma go back to
# dynamic_slice: a one-hot matvec READS THE WHOLE COVARIANCE to pick two
# columns (67 MB at the D=4096 serving scale), while the serving path is
# unbatched so its dynamic_slice lowers to a genuine fast slice. The
# matvec form is for the SMALL-D batched engines, where a per-world slot
# under vmap would otherwise lower to a batched gather (BENCH_NOTES
# pathology 15). No production path batches a data-dependent slot at
# large D (big maps run the blocked engine).
_ONEHOT_MAX_D = 512


def _slot_cols(cov, j, uu):
    """Sigma's (D, 2) column pair at slot ``j`` (see _ONEHOT_MAX_D).

    The small-D form is a masked REDUCE, not a matmul: a (D, D) x (D, 2)
    one-hot matmul is a skinny product with layout overhead, while
    `sum(cov * row_mask)` fuses into one elementwise pass."""
    if cov.shape[-1] <= _ONEHOT_MAX_D:
        return jnp.stack([jnp.sum(cov * uu[0][None, :], axis=-1),
                          jnp.sum(cov * uu[1][None, :], axis=-1)], axis=-1)
    return jax.lax.dynamic_slice_in_dim(cov, 3 + 2 * j, 2, axis=-1)


def _landmark_delta(mean, j):
    """``(dx, dy, d, sqrt_d)`` from robot to landmark slot ``j`` (0-based),
    with safe denominators (slots may be uninitialized; results masked out
    downstream). Ref slam_library.cpp:150-186 uses 1-based ``j``."""
    uu = _slot_onehot(mean.shape[0], j, mean.dtype)
    m = jnp.matmul(uu, mean, precision=PRECISION)
    dx = m[0] - mean[1]
    dy = m[1] - mean[2]
    d = dx * dx + dy * dy
    d = jnp.maximum(d, jnp.asarray(1e-12, mean.dtype))
    return dx, dy, d, jnp.sqrt(d)


def predicted_measurement(state: EKFState, j):
    """``z_hat`` for landmark slot ``j`` (ref ``computeTheoreticalMeasurement``,
    slam_library.cpp:150-160)."""
    dx, dy, _, sq = _landmark_delta(state.mean, j)
    return jnp.stack(
        [sq, se2.normalize_angle(jnp.arctan2(dy, dx) - state.mean[0])]
    )


def _h5(dx, dy, d, sq):
    """The 2x5 compressed measurement Jacobian on the basis
    ``[theta, x, y, mx, my]`` (the 9 nonzeros of H,
    ref slam_library.cpp:174-183)."""
    z = jnp.zeros_like(dx)
    row0 = jnp.stack([z, -dx / sq, -dy / sq, dx / sq, dy / sq], axis=-1)
    row1 = jnp.stack([-jnp.ones_like(dx), dy / d, -dx / d, -dy / d, dx / d],
                     axis=-1)
    return jnp.stack([row0, row1], axis=-2)  # (..., 2, 5)


def _inv2x2(M):
    """Closed-form 2x2 inverse with safe determinant."""
    a, b_, c, d_ = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    det = a * d_ - b_ * c
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.full_like(det, 1e-30), det)
    inv = jnp.stack(
        [jnp.stack([d_, -b_], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
    )
    return inv / det[..., None, None]


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

def update(config: EKFConfig, state: EKFState, z, j, R) -> EKFState:
    """Kalman update against landmark slot ``j`` (ref ``update``,
    slam_library.cpp:263-282), exploiting H-sparsity:

    - ``Sigma H^T`` is a linear combination of 5 columns of Sigma — O(D).
    - ``K = Sigma H^T psi^{-1}`` with closed-form 2x2 ``psi^{-1}`` — O(D).
    - ``Sigma <- Sigma - K (H Sigma)`` is a rank-2 outer product — O(D^2).

    The O(D^2) tail is bound by device-memory bandwidth; XLA fuses it
    into one read and one write of Sigma.

    The innovation is raw ``z - z_hat`` like the reference (no angle wrap)
    unless ``config.wrap_innovation``; theta is re-normalized afterwards
    (ref slam_library.cpp:274).
    """
    mean, cov = state.mean, state.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)

    dx, dy, d, sq = _landmark_delta(mean, j)
    H5 = _h5(dx, dy, d, sq)  # (2, 5)

    # Sigma H^T via 5 selected columns: indices [0, 1, 2, 3+2j, 4+2j].
    # The landmark pair comes from a one-hot matvec, NOT dynamic_slice
    # (a vmapped variable-offset slice is a gather — see _slot_onehot).
    uu = _slot_onehot(mean.shape[0], j, dt)                        # (2, D)
    cols_r = cov[:, :3]                                            # (D, 3)
    cols_m = _slot_cols(cov, j, uu)                                # (D, 2)
    # SHt as a 5-term broadcast combination (tiny matmuls carry layout
    # overhead; broadcasts fuse)
    SHt = jnp.stack(
        [cols_r[:, 0] * H5[q, 0] + cols_r[:, 1] * H5[q, 1]
         + cols_r[:, 2] * H5[q, 2]
         + cols_m[:, 0] * H5[q, 3] + cols_m[:, 1] * H5[q, 4]
         for q in range(2)], axis=-1)                              # (D, 2)

    # psi = H Sigma H^T + R: the same 5 rows of Sigma H^T
    rows_r = SHt[:3, :]                                            # (3, 2)
    rows_m = jnp.stack([jnp.sum(SHt * uu[k][:, None], axis=0)
                        for k in range(2)])                        # (2, 2)
    rows5 = jnp.concatenate([rows_r, rows_m], axis=0)              # (5, 2)
    psi = jnp.stack(
        [jnp.stack([jnp.sum(H5[q] * rows5[:, r]) for r in range(2)])
         for q in range(2)]) + R                                   # (2, 2)

    z_hat = jnp.stack(
        [sq, se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0])])
    dz = z - z_hat
    if config.wrap_innovation:
        dz = dz.at[1].set(se2.normalize_angle(dz[1]))

    inv = _inv2x2(psi)
    # gain + rank-2 downdate as broadcasts (see SHt comment)
    K0 = SHt[:, 0] * inv[0, 0] + SHt[:, 1] * inv[1, 0]             # (D,)
    K1 = SHt[:, 0] * inv[0, 1] + SHt[:, 1] * inv[1, 1]
    mean = mean + K0 * dz[0] + K1 * dz[1]
    # (I - K H) Sigma = Sigma - K (H Sigma); H Sigma = (Sigma H^T)^T
    cov = cov - (K0[:, None] * SHt[:, 0][None, :]
                 + K1[:, None] * SHt[:, 1][None, :])

    mean = mean.at[0].set(se2.normalize_angle(mean[0]))
    if config.symmetrize:
        cov = 0.5 * (cov + cov.T)
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


def innovation(config: EKFConfig, state: EKFState, z, j, R):
    """Pre-update innovation and its covariance ``(dz, psi)`` against
    landmark slot ``j`` — the NIS ingredients for filter-consistency tests
    (SURVEY.md section 4; ``pipeline.metrics.nis``). Same math as the head
    of :func:`update`, recomputed standalone so the hot path stays fused."""
    mean, cov = state.mean, state.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)
    dx, dy, d, sq = _landmark_delta(mean, j)
    H5 = _h5(dx, dy, d, sq)
    uu = _slot_onehot(mean.shape[0], j, dt)
    cols_r = cov[:, :3]
    cols_m = _slot_cols(cov, j, uu)
    cols = jnp.concatenate([cols_r, cols_m], axis=1)
    SHt = jnp.matmul(cols, H5.T, precision=PRECISION)
    rows_r = SHt[:3, :]
    rows_m = jnp.matmul(uu, SHt, precision=PRECISION)
    psi = jnp.matmul(H5, jnp.concatenate([rows_r, rows_m], axis=0),
                     precision=PRECISION) + R
    z_hat = jnp.stack(
        [sq, se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0])])
    dz = z - z_hat
    if config.wrap_innovation:
        dz = dz.at[1].set(se2.normalize_angle(dz[1]))
    return dz, psi


def update_dense(config: EKFConfig, state: EKFState, z, j, R) -> EKFState:
    """Literal dense update (test oracle), mirroring ref slam_library.cpp:263-282
    with explicitly assembled 2xD ``H``."""
    D = config.dim
    mean, cov = state.mean, state.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)
    dx, dy, d, sq = _landmark_delta(mean, j)
    H5 = _h5(dx, dy, d, sq)
    H = jnp.zeros((2, D), dt)
    j32 = jnp.asarray(j, jnp.int32)
    H = jax.lax.dynamic_update_slice(
        H, H5[:, 3:], (jnp.zeros_like(j32), 3 + 2 * j32))
    H = H.at[:, :3].set(H5[:, :3])
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    K = mm(mm(cov, H.T), jnp.linalg.inv(mm(mm(H, cov), H.T) + R))
    z_hat = jnp.stack(
        [sq, se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0])])
    dz = z - z_hat
    if config.wrap_innovation:
        dz = dz.at[1].set(se2.normalize_angle(dz[1]))
    mean = mean + mm(K, dz)
    mean = mean.at[0].set(se2.normalize_angle(mean[0]))
    cov = mm(jnp.eye(D, dtype=dt) - mm(K, H), cov)
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


# ---------------------------------------------------------------------------
# Landmark initialization
# ---------------------------------------------------------------------------

def init_landmark(config: EKFConfig, state: EKFState, z, j) -> EKFState:
    """Write landmark ``j``'s mean from a range-bearing measurement
    (ref ``initializeLandmark``, slam_library.cpp:255-261)::

        m = [x + r cos(phi + theta), y + r sin(phi + theta)]

    With ``config.analytic_init`` also writes the first-observation
    covariance blocks (the float32-safe equivalent of the reference's
    INT_MAX-prior-then-update):

        Sigma_m,:  = Gx Sigma[0:3, :]
        Sigma_mm   = Gx Sigma_rr Gx^T + Gz R Gz^T  ... via update() caller

    NOTE: the analytic covariance write happens in :func:`step_measurement`
    (it needs R); this function only writes the mean, exactly like the
    reference.
    """
    mean = state.mean
    z = jnp.asarray(z, mean.dtype)
    ang = z[1] + mean[0]
    m = jnp.stack([mean[1] + z[0] * jnp.cos(ang),
                   mean[2] + z[0] * jnp.sin(ang)])
    # masked write, NOT dynamic_update_slice: under vmap a batch-dependent
    # start index (unknown association picks a different slot per world)
    # lowers to an XLA scatter over the batch; the
    # where-chain is one vectorized pass over a (D,) row.
    idx = 3 + 2 * j
    lane = jnp.arange(mean.shape[0])
    mean = jnp.where(lane == idx, m[0],
                     jnp.where(lane == idx + 1, m[1], mean))
    return EKFState(mean=mean, cov=state.cov, n_seen=state.n_seen,
                    seen=state.seen)


def _analytic_init_cov(state: EKFState, z, j, R) -> jnp.ndarray:
    """First-observation covariance for landmark ``j`` (f32-safe path).

    With ``m = g(theta, x, y, z)``::

        Gx = [[-r sin(a), 1, 0], [r cos(a), 0, 1]]   (a = phi + theta)
        Gz = [[cos(a), -r sin(a)], [sin(a), r cos(a)]]

    New blocks: cross ``Sigma_m,: = Gx Sigma[0:3, :]`` and diagonal
    ``Sigma_mm = Gx Sigma_rr Gx^T + Gz R Gz^T``. This is the exact limit of
    the reference's infinite-prior update as the prior variance -> inf.
    """
    mean, cov = state.mean, state.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)
    a = z[1] + mean[0]
    r = z[0]
    sa, ca = jnp.sin(a), jnp.cos(a)
    Gx = jnp.stack([jnp.stack([-r * sa, jnp.ones_like(r), jnp.zeros_like(r)]),
                    jnp.stack([r * ca, jnp.zeros_like(r), jnp.ones_like(r)])])
    Gz = jnp.stack([jnp.stack([ca, -r * sa]), jnp.stack([sa, r * ca])])

    cross = jnp.matmul(Gx, cov[:3, :], precision=PRECISION)       # (2, D)
    block = (jnp.matmul(jnp.matmul(Gx, cov[:3, :3], precision=PRECISION),
                        Gx.T, precision=PRECISION)
             + jnp.matmul(jnp.matmul(Gz, R, precision=PRECISION), Gz.T,
                          precision=PRECISION))                    # (2, 2)

    idx = 3 + 2 * j
    if cov.shape[0] > _ONEHOT_MAX_D:
        # serving-scale states are unbatched: plain slice writes stay
        # real dynamic-update-slices (and a one-hot form would read the
        # full 67 MB+ covariance three times) — see _ONEHOT_MAX_D
        cov = jax.lax.dynamic_update_slice(
            cov, cross, (idx, jnp.zeros_like(idx)))
        cov = jax.lax.dynamic_update_slice(
            cov, cross.T, (jnp.zeros_like(idx), idx))
        cov = jax.lax.dynamic_update_slice(cov, block, (idx, idx))
        return cov
    # Rank-2 one-hot rewrite of the three block writes (BENCH_NOTES
    # pathology 15): dynamic_update_slice with the per-world slot
    # unknown association produces lowers under vmap to XLA scatters; (D, D) where-select trees sent XLA fusion-pass compile
    # time super-linear at lidar20 size; batched dynamic_slice READS of
    # the current rows/cols are gathers. One-hot matvecs express both the
    # reads and the overwrites as 2xD matmuls: they fuse flat and
    # vectorize over the batch.
    #   Sigma1 = Sigma + u^T (cross - u Sigma)          rows <- cross
    #   Sigma2 = Sigma1 + (cross^T - Sigma1 u^T) u      cols <- cross^T
    #   Sigma3 = Sigma2 + u^T (block - u Sigma2 u^T) u  own 2x2 <- block
    uu = _slot_onehot(cov.shape[0], j, cov.dtype)                 # (2, D)
    one = jnp.asarray(1.0, cov.dtype)
    r0, r1 = uu[0][:, None], uu[1][:, None]                       # (D, 1)
    c0, c1 = uu[0][None, :], uu[1][None, :]                       # (1, D)
    inrow = r0 + r1
    incol = c0 + c1
    rowv = r0 * cross[0][None, :] + r1 * cross[1][None, :]
    colv = cross[0][:, None] * c0 + cross[1][:, None] * c1
    blockv = ((r0 * c0) * block[0, 0] + (r0 * c1) * block[0, 1]
              + (r1 * c0) * block[1, 0] + (r1 * c1) * block[1, 1])
    # overwrite semantics via exact 0/1 mask arithmetic — values are
    # products with exact 1.0/0.0, so this equals the slice writes
    # bitwise
    return (cov * (one - inrow) * (one - incol)
            + rowv * (one - incol)
            + colv * (one - inrow)
            + blockv)


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------

class AssocResult(NamedTuple):
    outcome: jnp.ndarray   # () int32, one of ASSOC_*
    index: jnp.ndarray     # () int32: matched slot, or the new slot for NEW
    distances: jnp.ndarray # (N,) Mahalanobis distances (inf for unseen slots)


def associate(config: EKFConfig, state: EKFState, z, R) -> AssocResult:
    """Mahalanobis data association with the reference's exact first-hit
    semantics (ref ``associateLandmark``, slam_library.cpp:188-253;
    SURVEY.md section 2.4):

    1. No landmarks seen -> NEW at slot 0.
    2. Scan slots in order; the FIRST slot with distance < ``new_gate``
       decides: MATCH if < ``match_gate``, else SKIP.
    3. All distances >= ``new_gate`` -> NEW at slot ``n_seen`` (OVERFLOW if
       the capacity is full; ref slam.cpp:301-316 breaks the tick).

    Batched: all N distances at once using only the robot strip of Sigma
    and each landmark's 2x2 block — O(N) instead of O(N D^2).
    """
    N = config.num_landmarks
    mean, cov = state.mean, state.cov
    dt = mean.dtype
    z = jnp.asarray(z, dt)
    R = jnp.asarray(R, dt)

    # Per-landmark geometry, batched over all capacity slots.
    m = mean[3:3 + 2 * N].reshape(N, 2)
    dx = m[:, 0] - mean[1]
    dy = m[:, 1] - mean[2]
    d = jnp.maximum(dx * dx + dy * dy, jnp.asarray(1e-12, dt))
    sq = jnp.sqrt(d)

    # psi = H5 S5 H5^T + R over all N slots, in COMPONENT arrays — the
    # same w-chain algebra as the blocked engine's _associate_comp. The
    # (N, 5, 5)/(N, 2, 2)
    # einsum tensors this replaces carry tiny trailing dims through every
    # op (pathology 9).
    crr = cov[:3, :3]                                   # 3x3 scalars
    Srm = cov[:3, 3:3 + 2 * N].reshape(3, N, 2)         # rm comps (3,N,2)
    rows = cov[3:3 + 2 * N, 3:3 + 2 * N].reshape(N, 2, N, 2)
    # own-block diagonal via a masked reduce, not advanced indexing (a
    # vmapped data-dependent gather, pathology 15 family)
    eyeN = jnp.eye(N, dtype=dt)
    Smm = jnp.einsum("npmq,nm->npq", rows, eyeN,
                     precision=PRECISION)               # (N, 2, 2)
    a_ = dx / sq
    b_ = dy / sq
    c_ = dy / d
    e_ = -dx / d
    zero = jnp.zeros_like(dx)
    one = jnp.ones_like(dx)
    w = ((zero, -a_, -b_, a_, b_), (-one, c_, e_, -c_, -e_))
    rm = [Srm[i, :, p] for i in range(3) for p in range(2)]   # [i*2+p]
    dg = [Smm[:, p, q] for p in range(2) for q in range(2)]   # [p*2+q]
    psi_c = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(crr[k, 0] * wl[0] + crr[k, 1] * wl[1]
                     + crr[k, 2] * wl[2]
                     + rm[k * 2 + 0] * wl[3] + rm[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm[0 + p] * wl[0] + rm[2 + p] * wl[1]
                     + rm[4 + p] * wl[2]
                     + dg[p * 2 + 0] * wl[3] + dg[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi_c[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                           + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]

    z_hat1 = se2.normalize_angle(jnp.arctan2(dy, dx) - mean[0])
    dz0 = z[0] - sq                              # (N,) raw, like the ref
    dz1 = z[1] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = psi_c[0][0] * psi_c[1][1] - psi_c[0][1] * psi_c[1][0]
    # same |det| floor as _inv2x2: a singular psi at a seen slot must yield
    # a huge finite distance, not NaN — in nearest mode a NaN propagates
    # through min/argmin and suppresses real matches at OTHER slots
    # (advisor r04)
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.full_like(det, 1e-30), det)
    dist = (dz0 * (psi_c[1][1] * dz0 - psi_c[0][1] * dz1)
            + dz1 * (-psi_c[1][0] * dz0 + psi_c[0][0] * dz1)) / det
    seen_mask = state.seen
    dist = jnp.where(seen_mask, dist, jnp.inf)

    if config.assoc_mode == "nearest":
        # nearest-neighbor gating: the minimum distance decides
        first = jnp.argmin(dist).astype(jnp.int32)
        d_first = jnp.min(dist)
        any_hit = d_first < config.new_gate
        first_match = d_first < config.match_gate
    else:
        # First-hit scan: first slot with dist < new_gate (reference).
        # d_first via one-hot dot, not dist[first] (vmapped gather)
        lt_new = dist < config.new_gate
        any_hit = jnp.any(lt_new)
        first = jnp.argmax(lt_new).astype(jnp.int32)  # first True (0 if none)
        d_first = jnp.sum(
            jnp.where(jnp.arange(N) == first,
                      jnp.where(jnp.isfinite(dist), dist, 0.0), 0.0))
        first_match = jnp.where(any_hit, d_first < config.match_gate,
                                jnp.bool_(False))

    no_seen = state.n_seen == 0
    capacity_full = state.n_seen >= N

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
                      jnp.minimum(state.n_seen, N - 1)).astype(jnp.int32)
    return AssocResult(outcome=outcome, index=index, distances=dist)


# ---------------------------------------------------------------------------
# Per-tick driver: sequential measurement processing
# ---------------------------------------------------------------------------

def step_measurement(config: EKFConfig, state: EKFState, z, valid, stopped,
                     R):
    """Process one measurement with the reference node's control flow
    (ref slam.cpp:279-318): associate -> maybe initialize -> maybe update.

    ``valid`` masks padded measurement slots; ``stopped`` is the sticky
    capacity-overflow flag (the reference ``break``s out of the measurement
    loop, slam.cpp:301-316). Returns ``(new_state, new_stopped)``.

    Branchless: the update is computed unconditionally against a safe slot
    and selected with ``where`` — under jit this is one fused program with
    no data-dependent control flow.
    """
    res = associate(config, state, z, R)
    act = valid & ~stopped

    is_new = act & (res.outcome == ASSOC_NEW)
    is_match = act & (res.outcome == ASSOC_MATCH)
    is_overflow = act & (res.outcome == ASSOC_OVERFLOW)
    # With analytic init, the first-observation posterior is written directly
    # by the init (it already contains the measurement) — running update()
    # again would apply the measurement twice. Without it (reference mode),
    # the update against the huge prior does the collapsing, exactly like
    # ref slam.cpp:295-318 (initializeLandmark then update).
    do_update = is_match if config.analytic_init else (is_new | is_match)

    # Landmark initialization (mean write; analytic covariance if configured).
    st_init = init_landmark(config, state, z, res.index)
    if config.analytic_init:
        cov_init = _analytic_init_cov(st_init, z, res.index, R)
        st_init = st_init._replace(cov=cov_init)
    pre = jax.tree_util.tree_map(
        lambda a, b: jnp.where(is_new, a, b), st_init, state)
    # mask-or, not .at[res.index].set — the batched-index scatter class
    # again (BENCH_NOTES pathology 15)
    pre = pre._replace(
        n_seen=jnp.where(is_new, state.n_seen + 1, state.n_seen),
        seen=state.seen | (is_new
                           & (jnp.arange(state.seen.shape[0])
                              == res.index)))

    upd = update(config, pre, z, res.index, R)
    new_state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(do_update, a, b), upd, pre)
    return new_state, stopped | is_overflow


def step(config: EKFConfig, state: EKFState, twist, zs, z_valid, Q, R
         ) -> EKFState:
    """One SLAM tick (ref slam.cpp:231-365 ``main_loop`` body): predict with
    the odometry twist, then process the measurement batch *sequentially*
    (measurement i sees the state updated by i-1 — ref behavior, SURVEY.md
    section 3.3) via ``lax.scan``.

    ``zs``: (M, 2) range-bearing measurements; ``z_valid``: (M,) bool mask.
    """
    state = predict(config, state, twist, Q)

    def body(carry, inp):
        st, stopped = carry
        z, valid = inp
        st, stopped = step_measurement(config, st, z, valid, stopped, R)
        return (st, stopped), None

    (state, _), _ = jax.lax.scan(
        body, (state, jnp.bool_(False)),
        (jnp.asarray(zs), jnp.asarray(z_valid)), unroll=True)
    return state


def known_association_step(config: EKFConfig, state: EKFState, twist, zs,
                           z_valid, z_ids, Q, R) -> EKFState:
    """Tick with *known* data association (BASELINE.json config 1 /
    ref ``fake_sensor`` mode where marker ids identify tubes). ``z_ids``
    gives the landmark slot of each measurement; first observation of a slot
    initializes it.

    Capacity semantics match the reference node: an id at or beyond the
    landmark capacity stops the tick — no further measurements are processed
    (ref slam.cpp:301-316 ``break``; the unknown path's ASSOC_OVERFLOW has
    the same sticky-stop behavior)."""
    state = predict(config, state, twist, Q)

    def body(carry, inp):
        st, stopped = carry
        z, valid, j = inp
        overflow = j >= config.num_landmarks
        # a NEGATIVE id is a plain no-op like the blocked engine (ungated,
        # idx = 3+2j would land on the robot x/y lanes); only
        # at-or-beyond-capacity ids keep the reference's
        # sticky stop (ref slam.cpp:301-316)
        valid = valid & ~stopped & ~overflow & (j >= 0)
        stopped = stopped | overflow
        seen = st.seen[j]
        is_new = valid & ~seen
        st_init = init_landmark(config, st, z, j)
        if config.analytic_init:
            st_init = st_init._replace(
                cov=_analytic_init_cov(st_init, z, j, R))
        st_init = st_init._replace(
            n_seen=st.n_seen + 1, seen=st.seen.at[j].set(True))
        pre = jax.tree_util.tree_map(
            lambda a, b: jnp.where(is_new, a, b), st_init, st)
        # analytic init already contains the measurement; see step_measurement
        do_update = (valid & seen) if config.analytic_init else valid
        upd = update(config, pre, z, j, R)
        st = jax.tree_util.tree_map(
            lambda a, b: jnp.where(do_update, a, b), upd, pre)
        return (st, stopped), None

    (state, _), _ = jax.lax.scan(
        body, (state, jnp.bool_(False)),
        (jnp.asarray(zs), jnp.asarray(z_valid), jnp.asarray(z_ids)),
        unroll=True)
    return state
