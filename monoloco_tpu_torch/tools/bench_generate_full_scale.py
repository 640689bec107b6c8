"""KITTI txt generation at the real validation split's size, on one CUDA card.

Counterpart of the JAX package's `tools/bench_generate_full_scale.py`. The
real KITTI val split has 3769 images; this writes a synthetic KITTI root of
that many val scenes (`tools.make_synthetic_kitti`, seed 13, 8 train
scenes, images included, as the JAX tool does), then times the port's
GenerateKitti over it (annotations -> 64-image chunks through the engine
-> one txt an image) and prints the wall and images/s. Without `--model` a
random-init checkpoint at the production size (hidden 1024, 3 stages,
numpy seed 0) is written first: generation's speed does not depend on the
weights. `--dp_devices N` runs it on a mesh of N ranks
(`parallel/launch.py`: NCCL on N cards, gloo with `--disable-cuda`).

    python -m monoloco_tpu_torch.tools.bench_generate_full_scale [ROOT]
        [--mode mono|stereo] [--n_val 3769] [--model CKPT] [--dp_devices N]
        [--disable-cuda]

Without ROOT the root is a temporary directory, removed afterwards. A ROOT
that already holds a dataset keeps it, and the image count is read from its
split. Prints the dataset's wall, then one JSON line with the JAX tool's
keys (metric, n_images, txt_written, dp_devices, wall_s, images_per_sec),
the dispatches, the kernel launches and the device. Without a card and
without `--disable-cuda` it raises (`default_device()`).
"""

import argparse
import json
import os
import tempfile
import time

from . import device_name, sync
from .make_synthetic_kitti import make_dataset

GEN_HIDDEN, GEN_STAGES = 1024, 3


def _generate(mesh, gen_args):
    """GenerateKitti on one rank (the whole run without a mesh): (wall of
    `run()`, dispatches, dyn8-routed dispatches)."""
    from ..eval import GenerateKitti
    gen_args.mesh = mesh
    gen = GenerateKitti(gen_args)
    t0 = time.perf_counter()
    gen.run()
    sync(gen.model.device)
    return time.perf_counter() - t0, gen.model.n_dispatches, gen.model.n_dispatches_int8


def random_checkpoint(path, mode):
    """A random-init checkpoint at the production size for `mode`."""
    from ..models import init_loco_params, save_checkpoint
    in_dim, out_dim = (68, 10) if mode == 'stereo' else (34, 9)
    params, bn = init_loco_params(0, in_dim, out_dim, GEN_HIDDEN, GEN_STAGES)
    net = 'monstereo' if mode == 'stereo' else 'monoloco_pp'
    save_checkpoint(path, params, bn, meta={'net': net})
    return path


def run(root, mode='mono', n_val=3769, model=None, dp_devices=None, disable_cuda=False):
    """Build (or reuse) the dataset under `root`, generate its txts, and
    return the JSON record."""
    if not disable_cuda:
        from ..network.engine import default_device
        default_device()
    root = os.path.abspath(root)
    model = os.path.abspath(model) if model else None
    t0 = time.time()
    val_split = os.path.join(root, 'splits', 'kitti_val.txt')
    if not os.path.exists(val_split):
        make_dataset(root, n_train=8, n_val=n_val, seed=13)
    with open(val_split) as f:
        n_val = len([ln for ln in f if ln.strip()])
    print(f'dataset ({n_val} val scenes): {time.time() - t0:.1f}s', flush=True)
    old = os.getcwd()
    os.chdir(root)
    try:
        if model is None:
            model = random_checkpoint(os.path.join(root, 'data', 'outputs', 'fullscale.pkl'),
                                      mode)
        gen_args = argparse.Namespace(
            mode=mode, model=model, dir_ann='annotations', n_dropout=0, dropout=0.2,
            hidden_size=GEN_HIDDEN, n_stage=GEN_STAGES, baselines=False,
            generate_official=False, verbose=False, save=False, show=False,
            disable_cuda=disable_cuda)
        out_dir = os.path.join('data', 'kitti', 'monoloco_pp' if mode == 'mono' else 'monstereo')
        if os.path.isdir(out_dir):
            for name in os.listdir(out_dir):     # stale txts would fake txt_written
                if name.endswith('.txt'):
                    os.remove(os.path.join(out_dir, name))
        from ..ops import launches
        before = dict(launches)
        if dp_devices is None:
            wall, dispatches, int8 = _generate(None, gen_args)
        else:
            from ..parallel import launch
            wall, dispatches, int8 = launch(_generate, dp_devices, 1, args=(gen_args,),
                                            device_type='cpu' if disable_cuda else 'cuda')
        ran = {k: v - before[k] for k, v in launches.items() if v != before[k]}
        n_txt = (len([f for f in os.listdir(out_dir) if f.endswith('.txt')])
                 if os.path.isdir(out_dir) else -1)
    finally:
        os.chdir(old)
    return {'metric': f'generate_kitti_{mode}_full_scale', 'n_images': n_val,
            'txt_written': n_txt, 'dp_devices': dp_devices or 1, 'wall_s': round(wall, 2),
            'images_per_sec': round(n_val / wall, 1), 'dispatches': dispatches,
            'dispatches_int8': int8, 'launches': ran,
            'device': device_name(disable_cuda)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('root', nargs='?', help='dataset root (default: a temporary directory)')
    parser.add_argument('--mode', default='mono', choices=('mono', 'stereo'))
    parser.add_argument('--dp_devices', type=int, help='generate on a mesh of N ranks')
    parser.add_argument('--n_val', type=int, default=3769)
    parser.add_argument('--model', default=None)
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    args = parser.parse_args(argv)
    if args.dp_devices is not None and args.dp_devices < 1:
        raise SystemExit("--dp_devices takes a positive number of devices")
    kwargs = dict(mode=args.mode, n_val=args.n_val, model=args.model,
                  dp_devices=args.dp_devices, disable_cuda=args.disable_cuda)
    if args.root:
        record = run(args.root, **kwargs)
    else:
        with tempfile.TemporaryDirectory(prefix='fullscale_kitti_') as root:
            record = run(root, **kwargs)
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
