"""Result figures of the KITTI evaluation (`EvalKitti.printer` under
`--save`/`--show`): a host copy of `monoloco_tpu/visuals/figures.py`.

ALE against distance per method (`show_results`), the aleatoric spread
(`show_spread`), the task-error floor from the adult-height mixture
(`show_task_error`, `calculate_gmm`) and the per-cluster box plot of the
stereo net (`show_box_plot`), written as `figures/results/results_<net>.png`,
`spread_<net>.png`, `task_error.png` and `box_plot.png`. matplotlib is
imported inside the drawing functions on the Agg backend, never when the
module is imported (the card's machine may not have it).
"""

import os

import numpy as np

from ..utils import get_pixel_error, get_task_error
from .pifpaf_show import _pyplot

FIGSIZE = (9, 6)
FONTSIZE = 12

METHOD_STYLES = {
    'monoloco_pp': dict(color='darkorange', marker='o', label='MonoLoco++'),
    'monstereo': dict(color='b', marker='o', label='MonStereo'),
    'monoloco': dict(color='r', marker='s', label='MonoLoco'),
    'geometric': dict(color='purple', marker='x', label='Geometric'),
    'pose': dict(color='olive', marker='^', label='Pose'),
    'reid': dict(color='brown', marker='v', label='ReID'),
    'm3d': dict(color='gray', marker='.', label='Mono3D'),
    'monopsr': dict(color='pink', marker='.', label='MonoPSR'),
    'smoke': dict(color='c', marker='.', label='SMOKE'),
    'monodis': dict(color='m', marker='.', label='MonoDIS'),
    '3dop': dict(color='g', marker='*', label='3DOP'),
    'pseudo-lidar': dict(color='k', marker='+', label='Pseudo-LiDAR'),
    'e2e': dict(color='y', marker='1', label='E2E-PL'),
    'oc-stereo': dict(color='teal', marker='2', label='OC-Stereo'),
    'psf': dict(color='navy', marker='3', label='PSF'),
}


def get_distances(clusters):
    """Distance-bin centers from cluster edge labels ('3', '5', ... '31')."""
    excl = ('all', 'easy', 'moderate', 'hard', '49')
    numeric = [int(c) for c in clusters if c not in excl]
    return [x + 1 for x in numeric[:-1]] + [numeric[-1] + 1] if numeric else []


def _numeric_clusters(clusters):
    excl = ('all', 'easy', 'moderate', 'hard', '49')
    return [c for c in clusters if c not in excl]


def show_results(dic_stats, clusters, net, dir_fig, show=False, save=False):
    """ALE vs ground-truth distance per method, with the analytic floors."""
    phase = 'test'
    num_clusters = _numeric_clusters(clusters)
    xxs = get_distances(clusters)
    xx = np.linspace(3, 31, 100)

    plt = _pyplot()
    plotted = {}
    fig = plt.figure(figsize=FIGSIZE)
    plt.grid(linewidth=0.3)
    for method, style in METHOD_STYLES.items():
        stats = dic_stats[phase].get(method)
        if not stats:
            continue
        errs = [stats[clst]['mean'] for clst in num_clusters[:-1]]
        if not errs or all(e in (0, -1) for e in errs):
            continue
        n = min(len(xxs), len(errs))
        plotted[method] = (list(xxs[:n]), [float(e) for e in errs[:n]])
        plt.plot(xxs[:n], errs[:n], marker=style['marker'], label=style['label'],
                 color=style['color'])
    plt.plot(xx, get_task_error(xx), '--', label='Task error',
             color='lightgreen', linewidth=2.5)
    if net == 'monstereo':
        plt.plot(xx, [get_pixel_error(z) for z in xx], linewidth=1.4, color='k',
                 label='Pixel error')
    plt.xlabel('Ground-truth distance [m]', fontsize=FONTSIZE)
    plt.ylabel('Average localization error (ALE) [m]', fontsize=FONTSIZE)
    plt.legend(loc='upper left', prop={'size': FONTSIZE - 2})
    _finish(fig, os.path.join(dir_fig, f'results_{net}.png'), show, save)
    return plotted


def show_spread(dic_stats, clusters, net, dir_fig, show=False, save=False):
    """Aleatoric spread (bi) and error vs distance."""
    phase = 'test'
    num_clusters = _numeric_clusters(clusters)
    xxs = get_distances(clusters)
    stats = dic_stats[phase].get(net)
    if not stats:
        return
    plt = _pyplot()
    fig = plt.figure(figsize=FIGSIZE)
    errs = [stats[clst]['mean'] for clst in num_clusters[:-1]]
    bis = [stats[clst].get('std_ale', 0) for clst in num_clusters[:-1]]
    n = min(len(xxs), len(errs))
    plt.plot(xxs[:n], errs[:n], marker='o', label='ALE', color='b')
    plt.fill_between(xxs[:n], [max(0, e - b) for e, b in zip(errs[:n], bis[:n])],
                     [e + b for e, b in zip(errs[:n], bis[:n])],
                     alpha=0.25, color='b', label='Spread b')
    xx = np.linspace(3, 31, 100)
    plt.plot(xx, get_task_error(xx), '--', color='lightgreen', label='Task error')
    plt.xlabel('Ground-truth distance [m]', fontsize=FONTSIZE)
    plt.ylabel('Error / spread [m]', fontsize=FONTSIZE)
    plt.legend(prop={'size': FONTSIZE - 2})
    _finish(fig, os.path.join(dir_fig, f'spread_{net}.png'), show, save)
    return (list(xxs[:n]), [float(e) for e in errs[:n]],
            [float(b) for b in bis[:n]])


def calculate_gmm(n_samples=10_000_000, seed=0):
    """Sample the adult-height mixture (N(178,7) men + N(165,7) women, 1e7
    draws in the reference) and return the expected relative depth error of
    assuming the mean height: mm = E|1 - mu/h| (reference figures.py:227-239;
    this is where the 0.046·d task-error bound comes from — at 1e7 samples
    mm_gmm = 0.0459)."""
    rng = np.random.default_rng(seed)
    men = rng.normal(178, 7, size=n_samples // 2)
    women = rng.normal(165, 7, size=n_samples // 2)
    heights = np.concatenate([men, women])
    mu = float(heights.mean())
    mm = float(np.mean(np.abs(1 - mu / heights)))
    return heights, mu, mm


def show_task_error(dir_fig, show=False, save=False):
    """Monocular localization floor from human-height variation."""
    plt = _pyplot()
    heights, mu, mm = calculate_gmm(n_samples=1_000_000)
    xx = np.linspace(0, 40, 100)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].hist(heights, bins=120, density=True, color='steelblue', alpha=0.8)
    axes[0].axvline(mu, color='k', linestyle='--', label=f'mean {mu:.0f} cm')
    axes[0].set_xlabel('Height [cm]')
    axes[0].set_ylabel('Density')
    axes[0].legend()
    axes[1].plot(xx, get_task_error(xx), color='lightgreen', linewidth=2.5,
                 label='Task error (0.046 d)')
    axes[1].plot(xx, mm * xx, '--', color='gray', label=f'GMM bound ({mm:.3f} d)')
    axes[1].set_xlabel('Distance [m]')
    axes[1].set_ylabel('Expected error [m]')
    axes[1].legend()
    _finish(fig, os.path.join(dir_fig, 'task_error.png'), show, save)
    return mu, mm


def show_box_plot(dic_errors, clusters, dir_fig, show=False, save=False):
    """Per-distance-cluster error box plots for the stereo model."""
    num_clusters = _numeric_clusters(clusters)
    xxs = get_distances(clusters)
    plt = _pyplot()
    fig = plt.figure(figsize=FIGSIZE)
    for method in ('monstereo', 'monoloco_pp', 'pseudo-lidar'):
        if method not in dic_errors:
            continue
        data = [dic_errors[method][clst] for clst in num_clusters[:-1]]
        if not any(data):
            continue
        bp = plt.boxplot(data, positions=xxs[:len(data)], widths=1.2,
                         showfliers=False, patch_artist=True)
        color = METHOD_STYLES.get(method, {}).get('color', 'b')
        for box in bp['boxes']:
            box.set(facecolor=color, alpha=0.4)
        break  # one method per figure keeps it readable
    plt.xlabel('Ground-truth distance [m]', fontsize=FONTSIZE)
    plt.ylabel('Localization error [m]', fontsize=FONTSIZE)
    _finish(fig, os.path.join(dir_fig, 'box_plot.png'), show, save)


def _finish(fig, path, show, save):
    plt = _pyplot()
    if save:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fig.tight_layout()
        fig.savefig(path)
        print(f'Saved figure {path}')
    if show:
        plt.show()
    plt.close(fig)
