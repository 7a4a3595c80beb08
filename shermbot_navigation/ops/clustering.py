"""Lidar scan clustering as fixed-shape vectorized ops.

JAX re-design of the reference ``clusterPoints``
(``nuslam/src/circle_fit_library.cpp:136-206``): the sequential 360-ray sweep
with wraparound becomes a branchless segmented labeling — split flags, an
exclusive cumsum for cluster ids, and one scatter into a padded
``(max_clusters, max_points, 2)`` buffer. Everything is static-shape and
jit/vmap friendly.

Reproduced semantics (SURVEY.md C4):

- points with range outside ``[min_range, max_range]`` are skipped and do NOT
  split the cluster they sit inside (ref :148-153 ``continue``);
- an in-range ray ``i`` closes its cluster iff ``|r[i] - r[i+1]| >= 0.04``
  where ``i+1`` wraps and may be out-of-range (ref :155-159, :185-196);
- clusters are emitted in close order; the trailing still-open cluster is
  DROPPED (reference behavior: it is never pushed), except that when ray 359
  is in range and ``|r[359] - r[0]| < threshold`` the single point 359 is
  appended to cluster 0 (ref :169-174) — the rest of the open cluster is
  still dropped;
- point coordinates use integer-degree ray angles in the body frame
  (ref :161-163);
- clusters with fewer than 3 points are marked invalid (the reference's
  erase loop has a skip-after-erase bug that can leave some < 3 clusters in
  the list, ref :197-204, but those are always rejected by the circle
  classifier downstream, so dropping them here is behavior-preserving —
  see PARITY.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import se2

SPLIT_THRESHOLD = 0.04  # meters, ref circle_fit_library.cpp:142


class Clusters(NamedTuple):
    """Padded cluster set.

    ``points``: (C, P, 2) body-frame xy, zero-padded.
    ``counts``: (C,) number of valid points per cluster slot.
    ``valid``:  (C,) cluster slot holds a real cluster with >= 3 points.
    """

    points: jnp.ndarray
    counts: jnp.ndarray
    valid: jnp.ndarray


def _scan_membership(ranges, min_range, max_range, max_clusters: int,
                     threshold: float):
    """Shared clustering front end: per-ray membership, cluster id,
    within-cluster position, per-cluster counts, plus the wraparound
    bookkeeping (ref :148-174). Returns
    ``(pts, member, cid, pos, counts, num_closed, wrap_move)`` where
    ``member``/``counts`` are BEFORE the wraparound append of ray n-1."""
    ranges = jnp.asarray(ranges)
    n = ranges.shape[0]
    dt = ranges.dtype
    idx = jnp.arange(n)

    in_range = (ranges >= min_range) & (ranges <= max_range)
    nxt = jnp.roll(ranges, -1)
    split = in_range & (jnp.abs(ranges - nxt) >= threshold)

    # cluster id = number of splits strictly before this ray
    cum = jnp.cumsum(split.astype(jnp.int32))
    cid = cum - split.astype(jnp.int32)          # exclusive cumsum
    num_closed = cum[-1]

    # trailing open cluster (id == num_closed) is dropped...
    member = in_range & (cid < num_closed)
    # ...except the wraparound single-point move of ray n-1 into cluster 0
    wrap_move = in_range[n - 1] & ~split[n - 1] & (num_closed > 0)
    member = member & ~((idx == n - 1) & wrap_move)

    # body-frame points at integer-degree angles (ref :161-163)
    ang = se2.deg2rad(idx.astype(dt) * (360.0 / n))
    pts = jnp.stack([ranges * jnp.cos(ang), ranges * jnp.sin(ang)], axis=-1)

    # position within cluster: per-cluster running count. pos comes from
    # a masked row-sum of the one-hot matrix, NOT take_along_axis (a
    # vmapped data-dependent gather, BENCH_NOTES pathology 15 family).
    onehot = (cid[:, None] == jnp.arange(max_clusters)[None, :]) & member[:, None]
    run = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - onehot.astype(jnp.int32)
    cid_hot = (jnp.clip(cid, 0, max_clusters - 1)[:, None]
               == jnp.arange(max_clusters)[None, :])
    pos = jnp.sum(jnp.where(cid_hot, run, 0), axis=1)

    counts = jnp.sum(onehot, axis=0)
    return pts, member, cid, pos, counts, num_closed, wrap_move


def cluster_scan(ranges, min_range, max_range,
                 max_clusters: int = 16, max_points: int = 64,
                 threshold: float = SPLIT_THRESHOLD) -> Clusters:
    """Cluster one scan. ``ranges``: (n,) — ray k at body angle k*(360/n) deg."""
    ranges = jnp.asarray(ranges)
    n = ranges.shape[0]
    dt = ranges.dtype
    idx = jnp.arange(n)
    pts, member, cid, pos, counts, num_closed, wrap_move = _scan_membership(
        ranges, min_range, max_range, max_clusters, threshold)

    # one-hot matmul into the padded buffer (drop overflows). NOT a
    # scatter (`buf.at[flat_idx].set` lowers under vmap to a scatter
    # over batch x rays — BENCH_NOTES pathology 15), and NOT an argsort +
    # searchsorted gather (a vmapped gather). Member slots
    # (cid * max_points + pos) are unique by construction, so
    # ``W[s, r] = [flat_idx[r] == s]`` has at most one 1 per row and
    # ``W @ pts`` IS the scatter — one (C*P, n) x (n, 2) matmul,
    # with empty slots landing exactly the zero padding.
    flat_idx = jnp.where(
        member & (cid < max_clusters) & (pos < max_points),
        cid * max_points + pos,
        max_clusters * max_points,
    )
    slots = jnp.arange(max_clusters * max_points)
    W = (flat_idx[None, :] == slots[:, None]).astype(dt)   # (C*P, n)
    points = jnp.matmul(W, pts,
                        precision=jax.lax.Precision.HIGHEST
                        ).reshape(max_clusters, max_points, 2)

    # append ray n-1 to the end of cluster 0 on wrap (ref :169-174) —
    # masked write, not .at[0, c0] (data-dependent position, same
    # scatter pathology)
    c0 = jnp.minimum(counts[0], max_points - 1)
    row0 = jnp.where(
        (wrap_move & (jnp.arange(max_points) == c0))[:, None],
        pts[n - 1][None, :], points[0])
    points = points.at[0].set(row0)
    counts = counts.at[0].add(jnp.where(wrap_move, 1, 0))

    slot = jnp.arange(max_clusters)
    valid = (slot < num_closed) & (counts >= 3)
    return Clusters(points=points, counts=counts, valid=valid)


def classify_clusters(clusters: Clusters, std_threshold_deg: float = 10.0):
    """Circle / not-circle via inscribed-angle statistics, batched over all
    cluster slots (ref ``classifyCluster``, circle_fit_library.cpp:208-250).

    For each cluster: endpoints p2 (first) and p3 (last); for every interior
    point p1 the angle ``atan2(num, den)`` (twice-signed-area / dot form,
    ref :221-224) in degrees; circle iff the population stddev of those
    angles is < 10 degrees. Clusters with < 3 points have no interior points
    and are non-circles (the reference computes 0/0 = NaN there; NaN < 10 is
    false — same outcome).
    """
    pts, counts, valid = clusters
    C, P, _ = pts.shape
    dt = pts.dtype
    pos = jnp.arange(P)[None, :]
    m = counts[:, None]

    p2 = pts[:, 0, :]                                    # (C, 2) first
    # p3 = last valid point, via a one-hot masked sum (take_along_axis
    # is a vmapped gather, pathology 15 family)
    last = jnp.clip(counts - 1, 0, P - 1)
    lastmask = (pos == last[:, None])                    # (C, P)
    p3 = jnp.sum(jnp.where(lastmask[..., None], pts, 0.0), axis=1)

    interior = (pos >= 1) & (pos <= m - 2)               # (C, P)

    x1, y1 = pts[..., 0], pts[..., 1]                    # p1 = each point
    x2, y2 = p2[:, None, 0], p2[:, None, 1]
    x3, y3 = p3[:, None, 0], p3[:, None, 1]
    num = y2 * (x1 - x3) + y1 * (x3 - x2) + y3 * (x2 - x1)
    den = (x2 - x1) * (x1 - x3) + (y2 - y1) * (y1 - y3)
    angles = se2.rad2deg(jnp.arctan2(num, den))          # (C, P)

    cnt = jnp.maximum(jnp.sum(interior, axis=1), 1).astype(dt)
    mean = jnp.sum(jnp.where(interior, angles, 0.0), axis=1) / cnt
    var = jnp.sum(
        jnp.where(interior, (angles - mean[:, None]) ** 2, 0.0), axis=1) / cnt
    std = jnp.sqrt(var)

    return valid & (counts >= 3) & (std < std_threshold_deg)
