"""COCO-17 skeleton drawing and image canvases.

A host copy of `monoloco_tpu/visuals/pifpaf_show.py`: skeleton segments,
raised-arm highlighting, optional boxes, and a blurred-background canvas for
the social distancing renders. matplotlib is imported inside the functions
that draw (`_pyplot`), never when the module is imported: the card's machine
has no matplotlib, and a json-only predict run must not need it.
"""

from contextlib import contextmanager

import numpy as np

# COCO keypoint skeleton as pairs of joint indices (1-based in the COCO spec).
COCO_PERSON_SKELETON = [
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13),
    (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3),
    (2, 4), (3, 5), (4, 6), (5, 7),
]

LEFT_ARM_JOINTS = (5, 7, 9)    # shoulder, elbow, hand (0-based)
RIGHT_ARM_JOINTS = (6, 8, 10)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


@contextmanager
def image_canvas(image, output_path=None, show=False, fig_width=10.0,
                 dpi_factor=1.0, **kwargs):
    """Yield an axis drawn over the image; save to output_path on exit."""
    plt = _pyplot()
    image = np.asarray(image)
    height, width = image.shape[0], image.shape[1]
    fig = plt.figure(figsize=(fig_width, fig_width * height / width))
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    fig.add_axes(ax)
    ax.imshow(image)
    yield ax
    if output_path:
        fig.savefig(output_path, dpi=100 * dpi_factor)
        print(f'image saved: {output_path}')
    if show:
        plt.show()
    plt.close(fig)


def _gaussian_blur(image, sigma=2.5):
    """Separable Gaussian blur (scipy-free), as ndimage.gaussian_filter(image,
    sigma=(sigma, sigma, 0)): edge-reflected 1-D convolutions along rows then
    columns, the kernel truncated at 4 sigma like scipy's default, the
    boundary scipy's 'reflect' (numpy's 'symmetric': edge sample repeated)."""
    image = np.asarray(image, dtype=np.float32)
    radius = int(4.0 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    kernel = np.exp(-0.5 * (xs / sigma) ** 2)
    kernel /= kernel.sum()

    def conv_axis0(arr):
        pad = np.pad(arr, [(radius, radius)] + [(0, 0)] * (arr.ndim - 1),
                     mode='symmetric')
        out = np.zeros_like(arr)
        for i, w in enumerate(kernel):
            out += w * pad[i:i + arr.shape[0]]
        return out

    blurred = conv_axis0(image)                       # rows
    blurred = conv_axis0(blurred.swapaxes(0, 1)).swapaxes(0, 1)  # columns
    return blurred


@contextmanager
def blurred_canvas(image, output_path=None, show=False, fig_width=10.0):
    """Canvas with a Gaussian-blurred background (social-distancing style,
    sigma 2.5 over the image axes)."""
    soft = _gaussian_blur(image, sigma=2.5)
    with image_canvas(np.clip(soft, 0, 255).astype(np.uint8),
                      output_path, show, fig_width) as ax:
        yield ax


class KeypointPainter:
    """Draw COCO-17 skeletons (and optionally boxes/annotations) on an axis."""

    def __init__(self, show_box=False, linewidth=2, markersize=None, color_connections=True):
        self.show_box = show_box
        self.linewidth = linewidth
        self.markersize = markersize or max(1, linewidth * 2)
        self.color_connections = color_connections

    def _draw_skeleton(self, ax, x, y, v, color='deepskyblue', raised=None):
        cmap = _pyplot().get_cmap('tab20')
        for ci, (j1, j2) in enumerate(COCO_PERSON_SKELETON):
            a, b = j1 - 1, j2 - 1
            if v[a] > 0 and v[b] > 0:
                c = cmap(ci / len(COCO_PERSON_SKELETON)) if self.color_connections else color
                ax.plot([x[a], x[b]], [y[a], y[b]], color=c,
                        linewidth=self.linewidth, solid_capstyle='round')
        valid = v > 0
        ax.plot(x[valid], y[valid], 'o', markersize=self.markersize / 2,
                markerfacecolor=color, markeredgecolor='k', markeredgewidth=0.3)
        if raised in ('left', 'both'):
            self._highlight_arm(ax, x, y, v, LEFT_ARM_JOINTS)
        if raised in ('right', 'both'):
            self._highlight_arm(ax, x, y, v, RIGHT_ARM_JOINTS)

    def _highlight_arm(self, ax, x, y, v, joints):
        for a, b in zip(joints[:-1], joints[1:]):
            if v[a] > 0 and v[b] > 0:
                ax.plot([x[a], x[b]], [y[a], y[b]], color='lime',
                        linewidth=self.linewidth * 2, alpha=0.8, solid_capstyle='round')

    def keypoints(self, ax, keypoint_sets, activities=(), dic_out=None, size=None,
                  colors=None, scores=None):
        """keypoint_sets: (m, 17, 3) arrays of [x, y, conf] per joint."""
        if keypoint_sets is None:
            return
        raising = (dic_out or {}).get('raising_hand', [])
        for i, kps in enumerate(np.asarray(keypoint_sets)):
            x, y, v = kps[:, 0], kps[:, 1], kps[:, 2]
            color = colors[i] if colors else 'deepskyblue'
            raised = raising[i] if ('raise_hand' in (activities or []) and i < len(raising)) else None
            self._draw_skeleton(ax, x, y, v, color=color, raised=raised)
            if self.show_box:
                valid = v > 0
                if valid.any():
                    ax.add_patch(_pyplot().Rectangle(
                        (x[valid].min(), y[valid].min()),
                        x[valid].max() - x[valid].min(), y[valid].max() - y[valid].min(),
                        fill=False, color=color, linewidth=1))


def get_pifpaf_outputs(annotations):
    """Pifpaf annotation dicts -> ((m, 17, 3) keypoint array, boxes list)."""
    if not annotations:
        return np.zeros((0, 17, 3)), []
    kps = np.asarray([np.asarray(ann['keypoints']).reshape(-1, 3)
                      for ann in annotations])
    boxes = [ann.get('bbox') for ann in annotations]
    return kps, boxes
