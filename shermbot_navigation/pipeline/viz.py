"""Replay/visualization artifacts — the rviz replacement.

The reference validates everything by eyeballing rviz paths and markers
(SURVEY.md D5/L7: gifs are the acceptance record). Headless accelerator
hosts have no rviz, so the equivalents are files:

- :func:`plot_run` — a PNG of ground-truth / odometry / SLAM trajectories
  plus true and estimated landmark positions (what
  ``unknown_data_assoc.launch`` + rviz shows);
- :func:`write_trajectory_csv` — the machine-diffable path artifact;
- :func:`scan_figure` — one lidar scan + detected landmark overlay (the
  ``landmark_detect.launch`` view).
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_run(path: str, outs, tube_locs=None, est_landmarks=None,
             title: str = "") -> None:
    """Save trajectory figure. ``outs`` is a stacked TickOutput."""
    plt = _mpl()
    tp = np.asarray(outs.true_pose)
    op = np.asarray(outs.odom_pose)
    sp = np.asarray(outs.slam_pose)

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(tp[:, 1], tp[:, 2], color="#555555", lw=2, label="ground truth")
    ax.plot(op[:, 1], op[:, 2], color="#1f77b4", lw=1.2, ls="--",
            label="odometry")
    ax.plot(sp[:, 1], sp[:, 2], color="#d62728", lw=1.2, label="SLAM")
    if tube_locs is not None:
        t = np.asarray(tube_locs)
        ax.scatter(t[:, 0], t[:, 1], marker="o", s=120, facecolors="none",
                   edgecolors="#2ca02c", label="tubes (true)")
    if est_landmarks is not None:
        e = np.asarray(est_landmarks)
        ax.scatter(e[:, 0], e[:, 1], marker="x", s=60, c="#d62728",
                   label="landmarks (est)")
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def write_trajectory_csv(path: str, outs) -> None:
    tp = np.asarray(outs.true_pose)
    op = np.asarray(outs.odom_pose)
    sp = np.asarray(outs.slam_pose)
    ns = np.asarray(outs.n_seen)
    with open(path, "w") as f:
        f.write("tick,true_th,true_x,true_y,odom_th,odom_x,odom_y,"
                "slam_th,slam_x,slam_y,n_seen\n")
        for t in range(tp.shape[0]):
            f.write(f"{t},{tp[t,0]},{tp[t,1]},{tp[t,2]},"
                    f"{op[t,0]},{op[t,1]},{op[t,2]},"
                    f"{sp[t,0]},{sp[t,1]},{sp[t,2]},{int(ns[t])}\n")


def scan_figure(path: str, scan, detections=None, valid=None,
                max_range: float = 1.0) -> None:
    """One polar lidar scan + detected landmark overlay."""
    plt = _mpl()
    r = np.asarray(scan)
    n = r.shape[0]
    ang = np.arange(n) * 2 * np.pi / n
    mask = r <= max_range
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(r[mask] * np.cos(ang[mask]), r[mask] * np.sin(ang[mask]),
               s=4, c="#1f77b4", label="scan")
    if detections is not None:
        d = np.asarray(detections)
        if valid is not None:
            d = d[np.asarray(valid)]
        ax.scatter(d[:, 0], d[:, 1], marker="x", s=80, c="#d62728",
                   label="detections")
    ax.scatter([0], [0], marker="^", s=80, c="k", label="robot")
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
