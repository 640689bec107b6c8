"""Load-test the port's micro-batching server (monoloco_tpu_torch/serve.py).

Counterpart of the JAX package's `tools/bench_serve.py`, with its flags and
JSON lines. Starts an in-process Server on the card (random weights from
`init_loco_params(0, 34, 9, 1024, 3)`, or `--model`), fires --clients
concurrent closed-loop clients each issuing --requests POSTs of an
--dets-detection image, and reports requests/s, inferences/s, latency
percentiles and the achieved coalescing (mean/max batch per dispatch, the
per-dispatch device round trip) from /metrics. MONOLOCO_TPU_PRECISION
selects the engine's path, as for the server.

  --sweep R1,R2,..   open-loop offered-load sweep over HTTP (fixed arrival
                     rate, keep-alive pool), p50/p99 and 503 sheds per level;
  --direct           with --sweep: offer the load to Batcher.submit()
                     directly, without HTTP;
  --expect-int8      exit nonzero unless the dyn8 kernel routed at least one
                     measured dispatch (warm-up excluded).

Usage: python -m monoloco_tpu_torch.tools.bench_serve [--model CKPT]
           [--clients 32] [--requests 20] [--dets 4] [--window-ms 2]
           [--max-batch 64] [--max-queue N] [--sweep R,..] [--duration S]
           [--direct] [--expect-int8]
It refuses to run without a CUDA card.
"""

import argparse
import http.client
import json
import statistics
import threading
import time
import urllib.request

import numpy as np
import torch

KK = [[718.3351, 0.0, 600.3891], [0.0, 718.3351, 181.5122], [0.0, 0.0, 1.0]]


def run_sweep(args, port, body):
    """Open-loop offered-load sweep over HTTP: requests fire at a fixed
    arrival rate, independent of completions, for --duration seconds per
    level. Below capacity latency stays near the batch window; past it the
    bounded queue sheds with 503 and the p99 of accepted requests stays
    bounded. Requests ride a keep-alive connection pool; any fully read
    response (a 503 included) returns its connection to the pool, and only
    transport errors (counted as 599) drop it. Returns the level records."""
    pool, pool_lock = [], threading.Lock()

    def post_once(results, lock):
        t1 = time.perf_counter()
        with pool_lock:
            conn = pool.pop() if pool else None
        if conn is None:
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
        try:
            conn.request('POST', '/v1/predict', body=body,
                         headers={'Content-Type': 'application/json'})
            resp = conn.getresponse()
            code = resp.status
            json.loads(resp.read())
            with pool_lock:
                pool.append(conn)
        except (OSError, http.client.HTTPException, ValueError):
            code = 599
            conn.close()
        with lock:
            results.append((code, time.perf_counter() - t1))

    max_fired = 3000          # bounds the thread count at high offered rates
    records = []
    for rps in (float(x) for x in args.sweep.split(',')):
        results, lock = [], threading.Lock()
        threads = []
        interval = 1.0 / rps
        t0 = time.perf_counter()
        n_fired = 0
        while time.perf_counter() - t0 < args.duration and n_fired < max_fired:
            delay = t0 + n_fired * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=post_once, args=(results, lock))
            th.start()
            threads.append(th)
            n_fired += 1
        for th in threads:
            th.join(timeout=180)
        ok = sorted(dt for code, dt in results if code == 200)
        shed = sum(1 for code, _ in results if code == 503)
        other = sum(1 for code, _ in results if code not in (200, 503))
        wall = time.perf_counter() - t0
        rec = {'offered_rps': rps, 'achieved_rps': round(len(ok) / wall, 1),
               'fired': n_fired, 'ok': len(ok), 'shed_503': shed,
               'other_errors': other}
        if ok:
            n = len(ok)
            rec['latency_ms'] = {'p50': round(ok[n // 2] * 1e3, 2),
                                 'p90': round(ok[int(0.9 * (n - 1))] * 1e3, 2),
                                 'p99': round(ok[int(0.99 * (n - 1))] * 1e3, 2)}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def run_direct_sweep(args, net, Batcher):
    """Open-loop offered-load sweep calling Batcher.submit() directly: no
    HTTP, no per-request handler threads. One pacing thread offers requests
    at a fixed rate; the bounded queue, the collator and the device dispatch
    do the rest, and sheds are submit() returning None. Latency percentiles
    come from the batcher's enqueue-to-done clock, device_ms is the
    per-dispatch round trip. Returns the level records and the routing
    record."""
    rng = np.random.RandomState(0)
    kps = np.asarray(rng.rand(args.dets, 3, 17) * 300, np.float32)
    kk = np.asarray(KK, np.float32)

    batcher = Batcher(net, window_ms=args.window_ms, max_batch=args.max_batch,
                      max_queue=args.max_queue)
    records = []
    for rps in (float(x) for x in args.sweep.split(',')):
        batcher.latencies_s.clear()
        batcher.device_s.clear()
        batcher.batch_sizes.clear()
        shed = accepted = 0
        pending = []
        interval = 1.0 / rps
        t0 = time.perf_counter()
        n_fired = 0
        while time.perf_counter() - t0 < args.duration:
            delay = t0 + n_fired * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            r = batcher.submit(kps, kk)
            n_fired += 1
            if r is None:
                shed += 1
            else:
                accepted += 1
                pending.append(r)
        for r in pending:
            r.event.wait(timeout=120)
        wall = time.perf_counter() - t0
        lat = sorted(batcher.latencies_s)
        dev = sorted(batcher.device_s)
        sizes = list(batcher.batch_sizes)
        rec = {'offered_rps': rps, 'fired': n_fired, 'ok': accepted,
               'shed': shed, 'achieved_rps': round(accepted / wall, 1),
               'mean_batch': round(sum(sizes) / max(1, len(sizes)), 2),
               'max_batch': max(sizes, default=0)}
        if lat:
            n = len(lat)
            rec['latency_ms'] = {'p50': round(lat[n // 2] * 1e3, 2),
                                 'p99': round(lat[int(0.99 * (n - 1))] * 1e3, 2)}
        if dev:
            n = len(dev)
            rec['device_ms'] = {'p50': round(dev[n // 2] * 1e3, 2),
                                'p99': round(dev[int(0.99 * (n - 1))] * 1e3, 2)}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    batcher.stop()
    rec = {'int8_dispatches': net.n_dispatches_int8,
           'dispatches': net.n_dispatches,
           'int8_kernel_packed': net.mlp_weights['packed_int8'] is not None}
    print(json.dumps(rec), flush=True)
    records.append(rec)
    return records


def warm_batch_buckets(net, max_batch, dets):
    """Run every power-of-two batch bucket a sweep can hit once (plus the
    engine's rounded-up bucket for a non-power-of-two max_batch), so that no
    level pays a first dispatch's set-up; one definition shared by the
    --direct and --sweep branches."""
    kps1 = np.zeros((dets, 3, 17), np.float32)
    kk = np.asarray(KK, np.float32)
    b = 1
    while b <= max_batch:
        net.forward_batch([kps1] * b, [kk] * b)
        b *= 2
    if b // 2 != max_batch:
        net.forward_batch([kps1] * max_batch, [kk] * max_batch)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default=None,
                    help='checkpoint path (default: random-init hidden 1024)')
    ap.add_argument('--clients', type=int, default=32)
    ap.add_argument('--requests', type=int, default=20)
    ap.add_argument('--dets', type=int, default=4,
                    help='detections per request image')
    ap.add_argument('--window-ms', type=float, default=2.0)
    ap.add_argument('--max-batch', type=int, default=64)
    ap.add_argument('--max-queue', type=int, default=None,
                    help='bounded queue depth (default 8 * max_batch)')
    ap.add_argument('--sweep', default=None,
                    help='comma list of offered req/s: run an OPEN-LOOP load '
                         'sweep and report p50/p99 + shed (503) counts per level')
    ap.add_argument('--duration', type=float, default=10.0,
                    help='seconds per sweep level')
    ap.add_argument('--direct', action='store_true',
                    help='with --sweep: offer load to the Batcher directly (no HTTP)')
    ap.add_argument('--expect-int8', action='store_true',
                    help='exit nonzero unless the dyn8 kernel routed at least one '
                         'measured dispatch')
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_serve measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    from ..models import init_loco_params
    from ..network import Loco
    from ..serve import Batcher, Server

    if args.model:
        net = Loco(model=args.model, mode='mono')
    else:
        net = Loco(init_loco_params(0, 34, 9, 1024, 3), mode='mono')

    def check_int8_engagement():
        print(f'int8: packed={net.mlp_weights["packed_int8"] is not None} '
              f'dispatches_int8={net.n_dispatches_int8}/{net.n_dispatches}',
              flush=True)
        if args.expect_int8 and net.n_dispatches_int8 == 0:
            raise SystemExit('--expect-int8: the dyn8 kernel never routed (dispatch '
                             'rows stayed below the floor, or the kernel is not packed)')

    if args.direct:
        if not args.sweep:
            raise SystemExit('--direct requires --sweep rates')
        # Every bucket a level can hit, so a routing one loads the kernels.
        print('warming all batch buckets...', flush=True)
        warm_batch_buckets(net, args.max_batch, args.dets)
        net.n_dispatches = net.n_dispatches_int8 = 0   # exclude warm-up
        records = run_direct_sweep(args, net, Batcher)
        check_int8_engagement()
        return records

    server = Server(net, port=0, window_ms=args.window_ms,
                    max_batch=args.max_batch, max_queue=args.max_queue)
    server.warmup()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.port

    rng = np.random.RandomState(0)
    kps = (rng.rand(args.dets, 3, 17) * 300).tolist()
    body = json.dumps({'keypoints': kps, 'kk': KK}).encode()
    tls = threading.local()

    def post():
        # One persistent keep-alive connection per client thread: measures
        # the serving path, not TCP handshakes.
        conn = getattr(tls, 'conn', None)
        if conn is None:
            conn = tls.conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
        try:
            conn.request('POST', '/v1/predict', body=body,
                         headers={'Content-Type': 'application/json'})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
        except (OSError, http.client.HTTPException, ValueError):
            conn.close()
            tls.conn = None
            raise
        if resp.status != 200:
            raise RuntimeError(f'HTTP {resp.status}: {payload}')

    if args.sweep:
        # (The closed-loop warm-up below is skipped: at a small --max-queue
        # it would itself be shed with 503s.)
        print('warming all batch buckets...', flush=True)
        warm_batch_buckets(net, args.max_batch, args.dets)
        # A full-bucket warm-up dispatch can route int8 and would satisfy
        # --expect-int8 even if no measured request ever does.
        net.n_dispatches = net.n_dispatches_int8 = 0
        records = run_sweep(args, port, body)
        server.shutdown()
        check_int8_engagement()
        return records

    print('warming up (serve buckets)...', flush=True)
    t0 = time.time()
    warm = [threading.Thread(target=post) for _ in range(args.clients)]
    for t in warm:
        t.start()
    for t in warm:
        t.join()
    post()
    print(f'warmup done in {time.time() - t0:.1f}s', flush=True)
    net.n_dispatches = net.n_dispatches_int8 = 0   # exclude warm-up

    lat, errors = [], []
    lock = threading.Lock()

    def client():
        try:
            for _ in range(args.requests):
                t1 = time.perf_counter()
                post()
                dt = time.perf_counter() - t1
                with lock:
                    lat.append(dt)
        except (OSError, http.client.HTTPException, ValueError, RuntimeError) as exc:
            with lock:
                errors.append(repr(exc))

    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    with urllib.request.urlopen(f'http://127.0.0.1:{port}/metrics', timeout=30) as resp:
        metrics = json.loads(resp.read())
    server.shutdown()
    if errors:
        raise RuntimeError(f'{len(errors)} clients failed, first: {errors[0]}')

    lat.sort()
    n = len(lat)
    rec = {'metric': 'serve_requests_per_sec',
           'value': round(n / wall, 1),
           'clients': args.clients,
           'dets_per_request': args.dets,
           'window_ms': args.window_ms,
           'latency_ms': {'p50': round(statistics.median(lat) * 1e3, 2),
                          'p90': round(lat[int(0.9 * (n - 1))] * 1e3, 2),
                          'p99': round(lat[int(0.99 * (n - 1))] * 1e3, 2)},
           'mean_batch': round(metrics['mean_batch'], 2),
           'max_batch': metrics['max_batch'],
           'device_ms': metrics.get('device_ms'),
           'inferences_per_sec': round(n * args.dets / wall, 1),
           'precision': net.precision_raw,
           'device': torch.cuda.get_device_name(0)}
    print(json.dumps(rec), flush=True)
    check_int8_engagement()
    return [rec]


if __name__ == '__main__':
    main()
