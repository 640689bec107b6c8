"""3D bounding-box projection into the image plane: a host copy of
`monoloco_tpu/visuals/plot_3d_box.py` (the 8 yaw-rotated corners of a box
projected through K in one product, their enclosing 2D box, and the 12
edges drawn on a matplotlib axis the caller passes in).
"""

import numpy as np


def rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def compute_box_3d(hwl, xyz, ry, kk):
    """8 corners of a yaw-rotated 3D box projected into the image.

    hwl: [h, w, l]; xyz: bottom-center location; ry: egocentric yaw.
    Returns (corners_2d (8, 2), corners_3d (8, 3)); corners_2d is None when the
    box is behind the camera.
    """
    h, w, l = hwl
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0., 0., 0., 0., -h, -h, -h, -h])
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    corners = rot_y(ry) @ np.stack([x_c, y_c, z_c])   # (3, 8)
    corners_3d = corners + np.asarray(xyz, np.float64).reshape(3, 1)
    if np.any(corners_3d[2, :] < 0.1):
        return None, corners_3d.T
    uvw = np.asarray(kk, np.float64) @ corners_3d
    corners_2d = (uvw[0:2] / uvw[2]).T
    return corners_2d, corners_3d.T


def project_8p_to_4p(corners_2d):
    """Enclosing [x1, y1, x2, y2] box of projected corners."""
    c = np.asarray(corners_2d)
    return [float(c[:, 0].min()), float(c[:, 1].min()),
            float(c[:, 0].max()), float(c[:, 1].max())]


def draw_box_3d(ax, corners_2d, color='b', linewidth=1.5):
    """Draw the 12 edges of a projected 3D box on a matplotlib axis."""
    if corners_2d is None:
        return
    edges = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        ax.plot([corners_2d[a, 0], corners_2d[b, 0]],
                [corners_2d[a, 1], corners_2d[b, 1]],
                color=color, linewidth=linewidth)
