"""BEV rendering of a point cloud and its boxes — port of ``plot_bev`` in
``modest_tpu/utils/visualize.py`` (the headless stand-in for the
reference's mayavi views). matplotlib is imported inside ``plot_bev`` only:
the rest of the port does not need it."""
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
