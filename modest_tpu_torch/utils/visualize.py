"""Views of a point cloud and its boxes — port of
``modest_tpu/utils/visualize.py`` (the stand-ins for the reference's mayavi
views): ``plot_bev``, a headless BEV image, and ``plot_scene_3d``, an
interactive 3D scatter. matplotlib and plotly are imported inside the
function that draws with them only: the rest of the port needs neither."""
from __future__ import annotations

import numpy as np


def _box_corners_bev(box7):
    cx, cy, dx, dy, ang = box7[0], box7[1], box7[3], box7[4], box7[6]
    local = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]]) * [dx, dy]
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + [cx, cy]


def plot_bev(points, boxes=None, point_color=None, save_path=None, *, title=None,
             xlim=(-10, 90), ylim=(-50, 50), box_color="red", gt_boxes=None, gt_color="lime",
             point_size=0.3, cmap="viridis"):
    """BEV scatter of a lidar cloud (N, 3+) with optional (K, 7) rotated
    ``boxes`` and ``gt_boxes``; ``point_color`` a scalar per point. Saves a
    PNG at ``save_path`` when given; returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(12, 9))
    ax.scatter(points[:, 0], points[:, 1], s=point_size, c=point_color, cmap=cmap,
               linewidths=0)
    for group, color in ((boxes, box_color), (gt_boxes, gt_color)):
        if group is None:
            continue
        for b in np.asarray(group).reshape(-1, 7):
            corners = _box_corners_bev(b)
            loop = np.vstack([corners, corners[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=1.0)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_scene_3d(points, boxes=None, point_color=None, max_points=50000):
    """An interactive 3D scatter of ``points`` (N, ≥3) with the edges of
    ``boxes`` (M, 7) in red, as a plotly figure; None when plotly is not
    installed. Past ``max_points`` a fixed random subset (seed 0) is drawn."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    pts = np.asarray(points)
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        point_color = None if point_color is None else np.asarray(point_color)[sel]
    data = [go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                         marker=dict(size=1, color=point_color))]
    if boxes is not None:
        from .box_np import boxes_to_corners_3d

        edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4), (0, 4),
                 (1, 5), (2, 6), (3, 7)]
        for c in boxes_to_corners_3d(np.asarray(boxes).reshape(-1, 7)):
            xs, ys, zs = [], [], []
            for a, b in edges:
                xs += [c[a, 0], c[b, 0], None]
                ys += [c[a, 1], c[b, 1], None]
                zs += [c[a, 2], c[b, 2], None]
            data.append(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                     line=dict(color="red", width=2)))
    fig = go.Figure(data=data)
    fig.update_layout(scene_aspectmode="data")
    return fig
