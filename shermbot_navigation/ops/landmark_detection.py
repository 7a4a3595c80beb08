"""Scan -> landmark detections: the perception stage as one pure function.

JAX equivalent of the reference ``landmarks`` node
(``nuslam/src/landmarks.cpp``): cluster the scan, classify clusters as
circles, fit circles, and emit robot-frame landmark positions. The ROS
callback + 10 Hz loop + MarkerArray plumbing becomes a single jitted
function returning padded detections + a validity mask.

Filtering matches the node exactly (ref landmarks.cpp:84-105):
- non-circle clusters dropped (classifyCluster);
- degenerate fits dropped (``marker.id < 0``, i.e. < 4 points);
- fitted radius > 1 m dropped (ref :95-97);
- positions are the fitted centers; radii are overridden with the known
  tube radius (ref :100-105) — radii are therefore not part of the output.

Detections keep cluster order (the reference re-ids sequentially 0,1,2,...;
order is what matters for the EKF's sequential update semantics).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import se2
from .circle_fit import _fit_tail_c, fit_circles
from .clustering import (SPLIT_THRESHOLD, _scan_membership, classify_clusters,
                         cluster_scan)

PRECISION = jax.lax.Precision.HIGHEST


class Detections(NamedTuple):
    positions: jnp.ndarray  # (C, 2) robot-frame landmark centers, compacted
    valid: jnp.ndarray      # (C,) detection mask


def _compact(center, ok):
    """Compact valid detections to the front, preserving order (stable);
    the permutation is applied with a one-hot matmul, not fancy indexing
    (a vmapped gather, BENCH_NOTES pathology 15 family)."""
    C = ok.shape[0]
    order = jnp.argsort(jnp.where(ok, jnp.arange(C), C), stable=True)
    perm = (order[:, None] == jnp.arange(C)[None, :]).astype(center.dtype)
    positions = jnp.matmul(perm, center, precision=PRECISION)
    valid = jnp.matmul(perm, ok.astype(center.dtype),
                       precision=PRECISION) > 0.5
    return Detections(positions=positions, valid=valid)


def _detect_segmented(ranges, min_range, max_range, max_clusters: int,
                      max_points: int, max_radius: float,
                      std_threshold_deg: float = 10.0) -> Detections:
    """The whole perception stage as SEGMENT REDUCTIONS over rays.

    The buffered path scatters rays into a padded ``(C, P, 2)`` buffer via
    a ``(C*P, n)`` one-hot matmul and then re-reduces that buffer three
    times (classify endpoints/angles, centroid, moments). But every
    downstream consumer is a per-cluster REDUCTION — nothing needs the
    points materialized per-slot. This path computes the identical
    quantities directly from per-ray arrays with a handful of ``(C, n)``
    segment matmuls (C=16, n=360 — 23x smaller than the scatter matrix)
    feeding the componentized fit tail. Semantics are the buffered
    path's, including the wraparound append of ray n-1 to cluster 0
    (ref :169-174), the ``max_points`` capacity drop, and the
    divide-by-full-count centroid; parity pinned by
    tests/test_perception.py::TestSegmentedDetect.
    """
    ranges = jnp.asarray(ranges)
    n = ranges.shape[0]
    dt = ranges.dtype
    C = max_clusters
    P = max_points
    idx = jnp.arange(n)
    slot = jnp.arange(C)

    pts, member, cid, pos, counts, num_closed, wrap_move = _scan_membership(
        ranges, min_range, max_range, C, SPLIT_THRESHOLD)
    x = pts[:, 0]
    y = pts[:, 1]

    # effective buffer coordinates per ray (incl. the wrap append; a full
    # cluster 0 overwrites its last stored row, exactly like the buffer's
    # row write at min(counts0, P-1))
    is_last = idx == n - 1
    counts0 = counts[0]
    rcid = jnp.where(is_last & wrap_move, 0, cid)
    rpos = jnp.where(is_last & wrap_move, jnp.minimum(counts0, P - 1), pos)
    overwritten = ((~is_last) & wrap_move & (counts0 >= P)
                   & (cid == 0) & (pos == P - 1))
    rinc = (((member & (pos < P) & ~overwritten)
             | (is_last & wrap_move)) & (rcid < C))

    count_final = counts + jnp.where(wrap_move & (slot == 0), 1, 0)
    valid = (slot < num_closed) & (count_final >= 3)

    Wc = ((rcid[None, :] == slot[:, None]) & rinc[None, :]).astype(dt)
    WcT = Wc.T                                             # (n, C)

    def seg(vals):
        """Segment-sum a list of per-ray arrays -> list of (C,) arrays."""
        V = jnp.stack(vals, axis=-1)                       # (n, K)
        out = jnp.matmul(Wc, V, precision=PRECISION)       # (C, K)
        return [out[:, k] for k in range(len(vals))]

    def bcast(vals):
        """Broadcast per-cluster values back to rays (0 off-cluster)."""
        V = jnp.stack(vals, axis=-1)                       # (C, K)
        out = jnp.matmul(WcT, V, precision=PRECISION)      # (n, K)
        return [out[:, k] for k in range(len(vals))]

    # endpoints: first stored row / last stored row of each cluster
    w0 = Wc * (rpos == 0).astype(dt)[None, :]
    p2 = jnp.matmul(w0, pts, precision=PRECISION)          # (C, 2)
    last = jnp.clip(count_final - 1, 0, P - 1).astype(dt)
    last_r = jnp.matmul(WcT, last, precision=PRECISION)    # (n,)
    w3 = Wc * (rpos.astype(dt) == last_r).astype(dt)[None, :]
    p3 = jnp.matmul(w3, pts, precision=PRECISION)

    one_r = jnp.ones_like(x)
    cf_r, p2x_r, p2y_r, p3x_r, p3y_r = bcast(
        [count_final.astype(dt), p2[:, 0], p2[:, 1], p3[:, 0], p3[:, 1]])

    # inscribed angles (ref :221-224), interior rows only
    num = p2y_r * (x - p3x_r) + y * (p3x_r - p2x_r) + p3y_r * (p2x_r - x)
    den = (p2x_r - x) * (x - p3x_r) + (p2y_r - y) * (y - p3y_r)
    angles = se2.rad2deg(jnp.arctan2(num, den))
    interior = rinc & (rpos >= 1) & (rpos.astype(dt) <= cf_r - 2.0)
    ang0 = jnp.where(interior, angles, 0.0)                # select, not *

    sx, sy, s_ang, s_int = seg([x, y, ang0, interior.astype(dt)])
    cnt_m = jnp.maximum(count_final, 1).astype(dt)
    cx = sx / cnt_m
    cy = sy / cnt_m
    cnt_i = jnp.maximum(s_int, 1.0)
    mean_ang = s_ang / cnt_i

    cx_r, cy_r, mean_r = bcast([cx, cy, mean_ang])
    dev2 = jnp.where(interior, (angles - mean_r) ** 2, 0.0)
    xc = x - cx_r
    yc = y - cy_r
    z = xc * xc + yc * yc
    (s_dev2, szz, szx, szy, sz, sxx, sxy, sxc, syy, syc, sn) = seg(
        [dev2, z * z, z * xc, z * yc, z, xc * xc, xc * yc, xc,
         yc * yc, yc, one_r])

    std = jnp.sqrt(s_dev2 / cnt_i)
    is_circle = valid & (count_final >= 3) & (std < std_threshold_deg)

    mc = [szz, szx, szy, sz,
          szx, sxx, sxy, sxc,
          szy, sxy, syy, syc,
          sz, sxc, syc, sn]
    zbar = sz / cnt_m
    center, radius, okf = _fit_tail_c(mc, cx, cy, zbar, count_final, valid)

    ok = is_circle & okf & (radius <= max_radius)
    return _compact(center, ok)


def detect_landmarks(ranges, min_range, max_range,
                     max_clusters: int = 16, max_points: int = 64,
                     max_radius: float = 1.0,
                     segmented: bool | None = None) -> Detections:
    """Full perception stage for one scan (vmap over a batch of scans for
    many robots/sequences at once).

    ``segmented=None`` -> True: the segment-reduction path (no
    ``(C, P, 2)`` point buffer, no ``(C*P, n)`` scatter matmul; the
    buffered path re-reads that buffer three times). ``segmented=False``
    keeps the
    buffered path (the parity oracle, and the path serving users who
    need the ``Clusters`` buffer itself)."""
    if segmented is None or segmented:
        return _detect_segmented(ranges, min_range, max_range,
                                 max_clusters, max_points, max_radius)
    clusters = cluster_scan(ranges, min_range, max_range,
                            max_clusters=max_clusters, max_points=max_points)
    is_circle = classify_clusters(clusters)
    fits = fit_circles(clusters)
    ok = is_circle & fits.valid & (fits.radius <= max_radius)
    return _compact(fits.center, ok)
