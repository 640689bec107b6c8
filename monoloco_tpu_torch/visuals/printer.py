"""Front / bird-eye / combined ("multi") result rendering.

A host copy of `monoloco_tpu/visuals/printer.py`: the annotated front image
(boxes and distances), the bird-eye view (uncertainty bars, orientation
arrows, field-of-view lines), the combined multi figure, mono/stereo colour
coding by the aux score, and social-distance colouring. matplotlib is
imported inside the functions that draw, never when the module is imported.
"""

import math

import numpy as np

from ..geometry.host import np_pixel_to_camera
from .pifpaf_show import KeypointPainter, _pyplot, get_pifpaf_outputs


def _patches():
    from matplotlib.patches import FancyArrow, Rectangle
    return FancyArrow, Rectangle


def social_distance_colors(colors, dic_out):
    """Red for violators, the given colour otherwise."""
    flags = dic_out.get('social_distance', [])
    return ['r' if i < len(flags) and flags[i] else colors[i]
            for i in range(len(colors))]


def draw_orientation(ax, centers, sizes, angles, colors, mode='front'):
    """Arrows showing body orientation, on the image (front) or the ground
    plane (bird)."""
    fancy_arrow, _ = _patches()
    for idx, theta in enumerate(angles):
        color = colors[idx] if idx < len(colors) else 'deepskyblue'
        if mode == 'front':
            length = sizes[idx] if idx < len(sizes) else 20
            x, y = centers[idx][0], centers[idx][1]
            dx = length * math.cos(theta)
            # Image y grows downward, hence +sin here.
            dy = length * math.sin(theta)
            ax.add_patch(fancy_arrow(x, y, dx, dy, head_width=max(2, length / 4),
                                     color=color))
        else:
            x, z = centers[idx][0], centers[idx][1]
            length = 1.0
            dx = length * math.cos(theta)
            dz = -length * math.sin(theta)
            ax.add_patch(fancy_arrow(x, z, dx, dz, head_width=0.3, color=color))


def draw_uncertainty(ax, centers, stds, color='g'):
    """Radial uncertainty bars on the bird view."""
    for idx, std in enumerate(stds):
        theta = math.atan2(centers[idx][1], centers[idx][0])
        dx, dz = std * math.cos(theta), std * math.sin(theta)
        ax.plot((centers[idx][0] - dx, centers[idx][0] + dx),
                (centers[idx][1] - dz, centers[idx][1] + dz),
                color=color, linewidth=2.5)


class Printer:
    """Render per-image localization results as front / bird / multi figures."""

    FIG_WIDTH = 10

    def __init__(self, image, output_path, kk, args):
        self.im = image
        self.width, self.height = image.size[0], image.size[1]
        self.output_path = output_path
        self.kk = kk
        self.output_types = args.output_types
        self.z_max = args.z_max
        # show_all: draw every detection, else only ground-truth matches;
        # show: interactive display.
        self.show_all = getattr(args, 'show_all', False)
        self.show = getattr(args, 'show', False)
        self.save = not getattr(args, 'no_save', False)
        self.dpi = getattr(args, 'dpi', 100)
        self.hide_distance = getattr(args, 'hide_distance', False)
        self.activities = getattr(args, 'activities', [])

    # ------------------------------------------------------------------

    def _process(self, dic_ann):
        self.dds = dic_ann.get('dds_pred', [])
        self.stds_ale = dic_ann.get('stds_ale', [0.0] * len(self.dds))
        self.stds_epi = dic_ann.get('stds_epi', [0.0] * len(self.dds))
        self.angles = dic_ann.get('angles', [0.0] * len(self.dds))
        self.xyz = dic_ann.get('xyz_pred', [])
        self.xz_centers = [[p[0], p[2]] for p in self.xyz]
        self.boxes = dic_ann.get('boxes', [])
        self.xyz_real = dic_ann.get('xyz_real', [])
        gt_flags = dic_ann.get('gt', [True] * len(self.dds))
        # Rows to draw: all of them with --show_all (forced when no gt file
        # was given), else only the gt-matched ones.
        self.drawn = [i for i in range(len(self.dds))
                      if self.show_all or (i < len(gt_flags) and gt_flags[i])]
        auxs = dic_ann.get('aux', [])
        if auxs:
            self.modes = ['stereo' if a > 0.3 else 'mono' for a in auxs]
        else:
            self.modes = ['mono'] * len(self.dds)
        self.dds_real = dic_ann.get('dds_real', [])
        if self.z_max > 99 and self.dds:
            # Include gt distances so far-away gt markers stay visible.
            self.z_max = int(min(self.z_max,
                                 4 + max(max(self.dds),
                                         max(self.dds_real, default=0))))
        colors = ['deepskyblue'] * len(self.dds)
        if 'social_distance' in (self.activities or []):
            colors = social_distance_colors(colors, dic_ann)
        self.colors = colors
        # Colours follow dic_out (post_process-reordered) order; map them back
        # to pifpaf annotation order for skeleton painting.
        self.indices = dic_ann.get('indices', list(range(len(self.dds))))

    # ------------------------------------------------------------------

    def factory_axes(self, dic_out):
        """Create (figures, axes) for the chosen output types."""
        plt = _pyplot()
        self._process(dic_out)
        figures, axes = [], []
        self._fig_suffixes = []
        if 'multi' in self.output_types:
            if any(t in self.output_types for t in ('front', 'bird')):
                print("WARNING: 'multi' already contains the front and bird "
                      "views; separate front/bird files are not written")
            self._fig_suffixes = ['.multi.png']
            fig = plt.figure(figsize=(self.FIG_WIDTH * 1.8,
                                      self.FIG_WIDTH * self.height / self.width))
            ax_front = fig.add_subplot(1, 2, 1)
            ax_bird = fig.add_subplot(1, 2, 2)
            self._setup_front(ax_front)
            self._setup_bird(ax_bird)
            figures.append(fig)
            axes.extend([ax_front, ax_bird])
        else:
            if 'front' in self.output_types:
                fig = plt.figure(figsize=(self.FIG_WIDTH,
                                          self.FIG_WIDTH * self.height / self.width))
                ax = fig.add_subplot(1, 1, 1)
                self._setup_front(ax)
                figures.append(fig)
                axes.append(ax)
                self._fig_suffixes.append('.front.png')
            if 'bird' in self.output_types:
                fig = plt.figure(figsize=(self.FIG_WIDTH * 0.8, self.FIG_WIDTH * 0.8))
                ax = fig.add_subplot(1, 1, 1)
                self._setup_bird(ax)
                figures.append(fig)
                axes.append(ax)
                self._fig_suffixes.append('.bird.png')
        return figures, axes

    def _setup_front(self, ax):
        ax.set_axis_off()
        ax.set_xlim(0, self.width)
        ax.set_ylim(self.height, 0)
        ax.front = True

    def _setup_bird(self, ax):
        # Field-of-view dashes from the camera frustum: the leftmost pixel ray
        # at z_max; a fixed ratio without calibration.
        x_max = self.z_max / 1.5
        if self.kk is not None:
            try:
                corner = np_pixel_to_camera(
                    np.asarray([[0.0, float(self.height)]]),
                    np.asarray(self.kk, np.float64), float(self.z_max))
                x_max = abs(float(corner[0][0]))
            except Exception:
                pass
        ax.plot([0, x_max], [0, self.z_max], 'k--')
        ax.plot([0, -x_max], [0, self.z_max], 'k--')
        ax.set_ylim(0, self.z_max + 1)
        ax.set_xlabel('X [m]')
        ax.set_ylabel('Z [m]')
        ax.front = False

    # ------------------------------------------------------------------

    # When False (a live view), figures stay open for the caller to show.
    close_on_draw = True

    def draw(self, figures, axes, image, dic_out, annotations=None):
        plt = _pyplot()
        for ax in axes:
            if getattr(ax, 'front', False):
                self._draw_front(ax, image, dic_out, annotations)
            else:
                self._draw_bird(ax)
        if self.save:
            for fig, suffix in zip(figures, self._fig_suffixes):
                fig.savefig(self.output_path + suffix, bbox_inches='tight',
                            dpi=self.dpi)
                print(f'Image saved: {self.output_path + suffix}')
        if self.show:
            plt.show(block=False)
        elif not self.save:
            print('WARNING: --no_save without an interactive display — no '
                  'figure output produced')
        if self.close_on_draw:
            for fig in figures:
                plt.close(fig)

    def _draw_front(self, ax, image, dic_out, annotations):
        _, rectangle = _patches()
        ax.imshow(image)
        if annotations:
            kps, _ = get_pifpaf_outputs(annotations)
            n_ann = len(annotations)
            colors_ann = ['deepskyblue'] * n_ann
            for pos, ann_idx in enumerate(self.indices):
                if pos < len(self.colors) and ann_idx < n_ann:
                    colors_ann[ann_idx] = self.colors[pos]
            painter = KeypointPainter(show_box=False, linewidth=2)
            painter.keypoints(ax, kps, activities=self.activities,
                              dic_out=dic_out, colors=colors_ann)
        for idx, box in enumerate(self.boxes):
            if idx >= len(self.dds):
                break
            if idx not in self.drawn:
                continue
            mode_color = 'deepskyblue' if self.modes[idx] == 'stereo' else 'red'
            if 'social_distance' in (self.activities or []):
                # violators must stand out from the mono 'red' mode colour
                color = 'r' if self.colors[idx] == 'r' else 'deepskyblue'
            else:
                color = mode_color
            x0, y0, x1, y1 = box[0], box[1], box[2], box[3]
            ax.add_patch(rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                                   color=color, linewidth=1.5))
            if not self.hide_distance:
                ax.text(x0, max(0, y0 - 4), f'{self.dds[idx]:.1f} m',
                        color='white', fontsize=8,
                        bbox=dict(facecolor=color, alpha=0.8, pad=1))

    def _draw_bird(self, ax):
        # Only rows that pass the gt/show_all filter and sit inside the
        # visible z range get markers, bars and arrows.
        visible = [i for i in self.drawn
                   if 0 < self.xz_centers[i][1] <= self.z_max]
        for idx in visible:
            x, z = self.xz_centers[idx]
            color = self.colors[idx] if self.colors[idx] == 'r' else (
                'deepskyblue' if self.modes[idx] == 'stereo' else 'darkorange')
            ax.plot(x, z, 'o', color=color, markersize=6)
            ax.text(x + 0.2, z + 0.2, str(idx + 1), fontsize=9, color=color)
        centers = [self.xz_centers[i] for i in visible]
        # epistemic bars (MC dropout) behind the aleatoric ones
        epi = [self.stds_epi[i] for i in visible]
        if any(e > 0 for e in epi):
            draw_uncertainty(ax, centers, epi, color='coral')
        draw_uncertainty(ax, centers, [self.stds_ale[i] for i in visible])
        if any(abs(self.angles[i]) > 1e-9 for i in visible):
            draw_orientation(ax, centers, [],
                             [self.angles[i] for i in visible],
                             [self.colors[i] for i in visible], mode='bird')
        for xyz in self.xyz_real:
            if 0 < xyz[2] <= self.z_max:
                ax.plot(xyz[0], xyz[2], 'kx', markersize=6)
