"""One run of one cell: set-up, the window, the trace, the check, the
result line.

`run(workload, seed, seconds, trace)` is what `run.py` calls. Tests call it
with `device='cpu'` (no look for a card) and their own `spec` (a small
configuration), and with `wrap` to break the timed path underneath.
"""

import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from benchmark import check, flops, manifest, trace as trace_mod

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'monoloco_tpu')
CACHE = manifest.ROOT / 'build' / 'benchmark_cache'


class NoDevice(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    pass


def set_environment(traffic):
    """What the program reads from the environment: the precision from the
    traffic file, and every build and kernel cache at a fixed path inside
    the checkout."""
    os.environ['MONOLOCO_TPU_PRECISION'] = traffic['precision']
    os.environ.pop('MONOLOCO_TPU_INT8_MIN_ROWS', None)
    for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


def _device(chips):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {chips}")
    return torch.device('cuda', 0)


def power_limit():
    try:
        res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=20)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f'nvidia-smi: {err}'


def reference(cfg):
    """The configuration's plain reference module (`reference/<name>.py`)."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def build_engine(spec, weights, device):
    """The program under test: a `Loco` on a copy of the weights."""
    from monoloco_tpu_torch.network.engine import Loco
    cfg, traffic = spec['config'], spec['traffic']
    clone = reference(cfg).clone
    return Loco((clone(weights[0]), clone(weights[1])), mode=cfg['mode'], net=cfg['net'],
                device=device, n_dropout=traffic.get('n_dropout', 0),
                p_dropout=cfg['p_dropout'], linear_size=cfg['linear_size'],
                n_stage=cfg['num_stage'])


def prepare(spec, seed, device):
    """The pool of frames and the weights, both from the seed."""
    cfg, traffic = spec['config'], spec['traffic']
    gen = importlib.import_module(f"benchmark.generators.{traffic['generator']}")
    pool = gen.make_pool(traffic, seed)
    ref = reference(cfg)
    weights = ref.make_weights(cfg, seed, device, ref.calibration_rows(cfg, pool[0], device))
    return pool, weights


def drive(spec, engine, pool, seconds, seed, traced, dev):
    """The loop's window, traced or not. Returns (window record, profiler
    or None). The profiler starts after the warm-up and before the window
    (its start-up, seconds on the card, is set-up) and stops after the
    window's last finalize."""
    traffic = spec['traffic']
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    if not traced:
        return loop.run(engine, pool, traffic, seconds, seed), None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=False, with_stack=False)

    @contextlib.contextmanager
    def traced_window():
        prof.start()
        try:
            with record_function(trace_mod.WINDOW):
                yield
            if dev.type == 'cuda':
                torch.cuda.synchronize()
        finally:
            prof.stop()

    window = loop.run(engine, pool, traffic, seconds, seed, span=record_function,
                        on_window=traced_window)
    return window, prof


def compare(spec, weights, pool, samples, device):
    """The check's numbers over the sampled chunks."""
    cfg, traffic = spec['config'], spec['traffic']
    numbers = check.Numbers('counts_r' in pool[0], traffic.get('n_dropout', 0) > 0)
    ref_mode = spec['limits'].get('reference', 'f32')
    for pidx, outs in samples:
        check.compare_chunk(cfg, traffic, weights, pool[pidx], outs, device, numbers, ref_mode)
    return numbers


def run_record(spec, pool, window, setup_s, traced_summary):
    """What the metric readers read."""
    cfg, traffic = spec['config'], spec['traffic']
    n_drop = traffic.get('n_dropout', 0)
    per_pool = [(sum(c['counts']), flops.chunk_ops(cfg, c, n_drop)) for c in pool]
    t_end = window['t0'] + window['seconds']
    chunks = []
    for c in window['chunks']:
        dets, ops = per_pool[c['pool']]
        chunks.append({**c, 'detections': dets, 'ops': ops,
                       'in_window': c['ok'] and c['t_done'] <= t_end})
    peak_ops, peak_name = flops.peak(traffic['precision'])
    return {'setup_s': setup_s, 'window_s': window['seconds'], 'chunks': chunks,
            'trace': traced_summary, 'peak_ops_per_s': peak_ops, 'peak_name': peak_name}


def run(workload, seed, seconds, traced, t_start, spec=None, device=None, wrap=None,
        log=sys.stderr):
    """One run. Returns the result dict (the last line's object) or raises
    NoDevice / ForbiddenModules. `wrap(engine)` may replace the engine the
    window drives (tests plant faults with it)."""
    spec = spec or manifest.resolve(workload)
    traffic, cell = spec['traffic'], spec['cell']
    set_environment(traffic)
    import torch
    # One intra-op thread: the host's torch work is on small arrays. Where
    # the process and its threads run is left to the machine.
    torch.set_num_threads(1)
    phases = {'imports': time.perf_counter() - t_start}
    dev = torch.device(device) if device is not None else _device(cell['chips'])
    torch.zeros(1, device=dev)                      # the CUDA context
    phases['device'] = time.perf_counter() - t_start
    pool, weights = prepare(spec, seed, dev)
    phases['frames_weights'] = time.perf_counter() - t_start
    engine = build_engine(spec, weights, dev)
    phases['engine'] = time.perf_counter() - t_start
    driven = wrap(engine) if wrap else engine
    window, prof = drive(spec, driven, pool, seconds, seed, traced, dev)
    setup_s = window['t0'] - t_start
    phases['warmup'] = setup_s
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    summary = trace_mod.reduce(prof) if prof is not None else None
    from monoloco_tpu_torch import ops
    counters = {'n_dispatches': engine.n_dispatches,
                'n_dispatches_int8': engine.n_dispatches_int8,
                'launches': {k: v for k, v in ops.launches.items() if v}}
    del engine, driven, prof
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(spec, weights, pool, window['samples'], dev)
    check_s = time.perf_counter() - t_check

    record = run_record(spec, pool, window, setup_s, summary)
    names = spec['per_layer'] if traced else spec['end_to_end']
    metrics = {}
    for m in names:
        value = manifest.reader(m['name'])(record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    ok, rows = check.judge(numbers.values, spec['limits']['limits'])
    attempted = len(window['chunks'])
    correct = ok and window['failed'] == 0 and attempted > 0
    if window['first_error']:
        print(window['first_error'], file=log)
    in_window = [c for c in record['chunks'] if c['in_window']]
    per_second = np.bincount([int(c['t_done'] - window['t0']) for c in in_window],
                             minlength=int(window['seconds'])).tolist()
    details = {
        'workload': cell['name'], 'seed': seed, 'precision': traffic['precision'],
        'chunks_in_window': len(in_window), 'chunks_attempted': attempted,
        'chunks_each_second': per_second,
        'detections_in_window': sum(c['detections'] for c in in_window),
        'rows_useful_per_chunk': float(np.mean([flops.useful_rows(c, traffic.get('n_dropout', 0))
                                                for c in pool])),
        'rows_padded_per_chunk': float(np.mean([flops.padded_rows(c, traffic.get('n_dropout', 0))
                                                for c in pool])),
        'counters': counters, 'peak': record['peak_name'],
        'setup_phases_s': {k: round(v, 4) for k, v in phases.items()},
        'power': power_limit() if dev.type == 'cuda' else 'cpu',
        'compared_frames': numbers.frames, 'compared_detections': numbers.detections,
        'numbers': numbers.values, 'raw_err_channel': numbers.raw_err_channel,
        'epi_worst': numbers.epi_worst,
        'check_s': check_s}
    device_info = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                   'kind': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
                   'count': cell['chips'], 'memory_peak_bytes': int(peak_bytes)}
    result = {'correct': bool(correct), 'attempted': attempted, 'failed': window['failed'],
              'metrics': metrics, 'device': device_info}
    if traced and summary is not None:
        device_info['busy_s'] = summary['busy_s']
        device_info['window_s'] = summary['window_s']
        result['breakdown'] = {'device_ops': summary['device_ops'],
                               'idle_gaps': summary['idle_gaps'][:10]}
    result['checks'] = {name: {'value': v, 'limit': lim} for name, v, lim in rows}
    # Last, once every reader has been loaded and run: nothing of JAX, Flax
    # or the JAX package may be in the process that prints the result.
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded that the benchmark forbids: {found}")
    print(json.dumps(details), flush=True)
    for name, v, lim in rows:
        print(f'check {name} {v!r} limit {lim!r}', file=log)
    log.flush()
    return result
