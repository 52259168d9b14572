"""Diagnostic renders — reachability plots, 2-D cluster plots, pipeline frames
(a copy of evflow_tpu/utils/plots.py, over the port's OPTICS).

Replaces the reference's OpenCV windows/JPEG dumps and the optics library's
software-rasterized plots:
  - draw_reachability_plot (optics.hpp:618-671): 256-px-tall normalized graph,
    green points, red no-dist markers, gray fill under the curve
  - draw_reachability_plot_with_chi_clusters (hpp:1024-1049): cluster-extent
    bars appended under the plot
  - draw_2d_clusters (hpp:1052-1088): colored cluster points + bounding boxes
  - cluster/flow frame render (accel …store.cpp:466-548): member dots in
    cluster colors, centroid dots, previous-centroid dots, flow arrows,
    cluster-id text at centroid+10 in blue (…store.cpp:502; r3 — rendered
    with the built-in 5×7 bitmap font in utils/ppm.py)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .ppm import BGRImage
from ..models.optics import ReachabilityDist, get_chi_clusters, ClusterNode

# accel …store.cpp:357-368 cluster color table (BGR)
CLUSTER_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (128, 0, 0), (0, 128, 0), (0, 0, 128), (128, 128, 0),
]

# optics.hpp:1056-1062 12-color table
OPTICS_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (255, 128, 128), (128, 255, 128), (128, 128, 255),
    (255, 255, 128), (255, 128, 255), (128, 255, 255),
]


def draw_reachability_plot(reach_dists: Sequence[ReachabilityDist],
                           min_width: int = 100) -> BGRImage:
    if len(reach_dists) < 2:
        return BGRImage(1, 1)
    width = max(len(reach_dists), min_width)
    img = BGRImage(width, 256)
    vals = np.array([r.reach_dist for r in reach_dists], float)
    max_val = vals.max() if len(vals) else 1.0
    no_dist_val = max_val + max(30.0, max_val / 3)
    # normalize [-1, no_dist_val] → [-1, 192] like fplus::normalize_min_max
    lo, hi = -1.0, no_dist_val
    scale = (256.0 - 64.0 - (-1.0)) / (hi - lo) if hi > lo else 1.0

    def norm(v):
        return (v - lo) * scale + (-1.0)

    ys = [int(255 - (norm(no_dist_val) if v < 0 else round(norm(v))))
          for v in vals]
    xs = [int(round((width - 1) * i / (len(vals) - 1))) for i in range(len(vals))]
    for i in range(len(vals) - 1):
        img.line(xs[i], ys[i], xs[i + 1], ys[i + 1], (30, 30, 30))
        img.set_pixel(xs[i], ys[i], (0, 0, 255) if vals[i] < 0 else (0, 255, 0))
        img.set_pixel(xs[i + 1], ys[i + 1],
                      (0, 0, 255) if vals[i + 1] < 0 else (0, 255, 0))
    # fill under the curve
    fill = np.array((177, 177, 177), np.uint8)
    white = np.array((255, 255, 255), np.uint8)
    for x in range(width):
        y = 255
        while y >= 0 and (img.px[y, x] == white).all():
            img.px[y, x] = fill
            y -= 1
    return img


def draw_reachability_plot_with_chi_clusters(
        reach_dists, chi: float, min_pts: int,
        steep_area_min_diff: float = 0.0, min_width: int = 100) -> BGRImage:
    img = draw_reachability_plot(reach_dists, min_width)
    trees = get_chi_clusters(reach_dists, chi, min_pts, steep_area_min_diff)
    max_depth = max((t.depth() for t in trees), default=0)
    v_space = 4
    bars = BGRImage(img.width, (max_depth + 1) * v_space)
    x_norm = 1.0
    if min_width > len(reach_dists):
        x_norm = min_width / (len(reach_dists) - 1)

    def draw(node: ClusterNode, depth: int):
        y = bars.height - (depth + 1) * v_space
        x1 = int(round(x_norm * node.data[0]))
        x2 = int(round(x_norm * node.data[1]))
        bars.line(x1, y, x2, y, (0, 0, 0))
        bars.set_pixel(x1, y, (0, 255, 0))
        bars.set_pixel(x2, y, (255, 0, 0))
        for c in node.children:
            draw(c, depth + 1)

    for t in trees:
        draw(t, 0)
    return img.append_rows(bars)


def draw_2d_clusters(clusters: Sequence[np.ndarray]) -> BGRImage:
    all_pts = np.concatenate([np.asarray(c, float) for c in clusters
                              if len(c)]) if clusters else np.zeros((1, 2))
    bl = all_pts.min(axis=0)
    tr = all_pts.max(axis=0)
    img = BGRImage(int(round(tr[0] - bl[0])) + 5, int(round(tr[1] - bl[1])) + 5)
    for ci, cluster in enumerate(clusters):
        col = OPTICS_COLORS[ci % len(OPTICS_COLORS)]
        pts = np.asarray(cluster, float)
        if len(pts) == 0:
            continue
        cb, ct = pts.min(axis=0), pts.max(axis=0)
        x0, y0 = int(round(cb[0] - bl[0])), int(round(cb[1] - bl[1]))
        x1, y1 = int(round(ct[0] - bl[0])), int(round(ct[1] - bl[1]))
        for a, b, c, d in ((x0, y0, x1, y0), (x1, y0, x1, y1),
                           (x1, y1, x0, y1), (x0, y1, x0, y0)):
            img.line(a, b, c, d, col)
        for p in pts:
            img.circle(int(round(p[0] - bl[0])), int(round(p[1] - bl[1])), 2, col)
    return img


def render_cluster_frame(width: int, height: int, out, member_xy=None,
                         member_labels=None) -> BGRImage:
    """Per-slice flagship frame: centroids (green), prev-centroid end of flow
    arrows, member dots in per-cid colors (accel …store.cpp:466-548)."""
    img = BGRImage(width, height, fill=(0, 0, 0))
    reported = np.asarray(out.reported)
    cent = np.asarray(out.centroid)
    flow = np.asarray(out.flow)
    cid = np.asarray(out.cid)
    if member_xy is not None and member_labels is not None:
        mx, my = member_xy
        for x, y, l in zip(np.asarray(mx), np.asarray(my), np.asarray(member_labels)):
            if l >= 0:
                img.set_pixel(int(x), int(y),
                              CLUSTER_COLORS[int(cid[l]) % len(CLUSTER_COLORS)])
    for i in np.where(reported)[0]:
        cx, cy = int(round(cent[i, 0])), int(round(cent[i, 1]))
        img.circle(cx, cy, 1, (0, 255, 0), filled=True)
        # cluster-id text at centroid+10, blue font (…store.cpp:497-502)
        img.text(cx + 10, cy + 10, str(int(cid[i])), (255, 0, 0))
        px, py = cx - flow[i, 0], cy - flow[i, 1]
        if px > 0 and py > 0:
            img.arrow(int(round(px)), int(round(py)), cx, cy, (0, 255, 0))
    return img


def render_track_frame(width: int, height: int, out,
                       arrow_scale: float = 3.0) -> BGRImage:
    """Per-slice corner-tracker frame — CornerVisualizer::visualizeTrackedCorners
    (group_track.cpp:539-626): group circles with their radius, group-velocity
    arrows scaled for visibility, the "%.1f px/f" magnitude text above each
    moving group (:582-585), per-corner dots colored by group membership with
    their "label(Gk)" tag at (x+5, y-5) (:613-622) — text via the built-in
    5×7 bitmap font (utils/ppm.py)."""
    img = BGRImage(width, height, fill=(0, 0, 0))
    groups = out.groups
    exists = np.asarray(groups.exists)
    gcent = np.asarray(groups.centroid)
    gvel = np.asarray(groups.avg_velocity)
    grad = np.asarray(groups.radius)
    for g in np.where(exists)[0]:
        cx, cy = int(round(gcent[g, 0])), int(round(gcent[g, 1]))
        img.circle(cx, cy, max(int(round(grad[g])), 2), (255, 200, 0))
        vmag = float(np.hypot(gvel[g, 0], gvel[g, 1]))
        if vmag > 0.1:   # reference draws only for significant movement
            img.arrow(cx, cy,
                      int(round(gcent[g, 0] + arrow_scale * gvel[g, 0])),
                      int(round(gcent[g, 1] + arrow_scale * gvel[g, 1])),
                      (0, 255, 255))
            img.text(cx - 20, cy - max(int(round(grad[g])), 2) - 5,
                     f"{vmag:.1f} px/f", (255, 200, 0))
    act = np.asarray(out.track_active)
    pos = np.asarray(out.track_pos)
    grp = np.asarray(out.track_group)
    lbl = np.asarray(out.track_label)
    # reference gates: corners drawn only at frame_count >= 3
    # (group_track.cpp:592); "(Gk)" appended only on a fresh detection,
    # frames_since_last_detection == 0 (:615-617). Outputs that don't carry
    # these fields (scalar -1 default, e.g. the tiled path) draw everything.
    fs = np.asarray(getattr(out, "track_frames_since", -1))
    fc = np.asarray(getattr(out, "track_frame_count", -1))
    for i in np.where(act)[0]:
        if fc.ndim == 1 and fc[i] < 3:
            continue
        col = (CLUSTER_COLORS[int(grp[i]) % len(CLUSTER_COLORS)]
               if grp[i] >= 0 else (200, 200, 200))
        px, py = int(round(pos[i, 0])), int(round(pos[i, 1]))
        img.circle(px, py, 2, col, filled=True)
        tag = str(int(lbl[i]))
        if grp[i] >= 0 and not (fs.ndim == 1 and fs[i] != 0):
            tag += f"(G{int(grp[i])})"
        img.text(px + 5, py - 5, tag, col)
    return img
