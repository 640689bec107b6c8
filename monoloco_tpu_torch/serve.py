"""Micro-batching HTTP server over the engine, on one CUDA card.

Counterpart of the JAX package's `monoloco_tpu/serve.py`, with the same
endpoints, payloads, status codes and keep-alive rules, so a client of the
JAX server reads this one's responses unchanged. Concurrent requests are
coalesced into ONE `Loco.forward_batch_async` call: the first request opens
a short batching window (default 2 ms) and everything arriving inside it
joins the same dispatch. Images pad to shared detection buckets, so the
MLP sees a real batch instead of per-request row vectors, and under
MONOLOCO_TPU_PRECISION=int8 a coalesced dispatch of at least the engine's
floor of padded rows runs the dyn8 kernel (under bf16 every dispatch runs
K1-bf16).

    request threads --(queue)--> collator thread --forward_batch_async--> card
          ^                                                  |
          +------------------ per-request Event <- finalize -+

stdlib only (ThreadingHTTPServer + queue).

Endpoints:
  POST /v1/predict   {"keypoints": [[m,3,17]], "kk": [[3,3]],
                      "keypoints_r": optional, "boxes": optional}
                     -> forward outputs (+ post_process outputs when boxes
                     are supplied), JSON lists.
  GET  /healthz      model, precision and int8 routing info.
  GET  /metrics      request/batch counters and latency percentiles.

Usage: python -m monoloco_tpu_torch.serve --model <ckpt> [--mode mono]
           [--port 8080] [--window-ms 2] [--max-batch 64]
The card is required: without one the engine raises (no CPU fallback).
"""

import argparse
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _to_jsonable(dic_out):
    """Serialize a forward()/post_process() output dict to JSON-safe types."""
    out = {}
    for k, v in dic_out.items():
        if k == 'yaw':
            out['yaw'] = [np.asarray(v[0]).tolist(), np.asarray(v[1]).tolist()]
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (list, tuple)):
            out[k] = [x.tolist() if isinstance(x, np.ndarray) else x for x in v]
        else:
            out[k] = v
    return out


class _Request:
    __slots__ = ('keypoints', 'kk', 'keypoints_r', 'event', 'result', 'error',
                 't_enqueue')

    def __init__(self, keypoints, kk, keypoints_r):
        self.keypoints = keypoints
        self.kk = kk
        self.keypoints_r = keypoints_r
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.perf_counter()


class Batcher:
    """Coalesce concurrent requests into single forward_batch dispatches.

    Backpressure: the request queue is bounded (`max_queue`, default
    8 * max_batch). When offered load exceeds the card's throughput the
    queue fills and submit() returns None; the HTTP layer sheds that request
    with 503 + Retry-After instead of letting latency grow without bound.
    The shed count is exported in /metrics.
    """

    def __init__(self, net, window_ms=2.0, max_batch=64, max_queue=None):
        self.net = net
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.max_queue = max_queue if max_queue is not None else 8 * max_batch
        # queue.Queue(maxsize<=0) means UNBOUNDED in Python, the failure
        # mode the bounded queue exists to prevent. Refuse it.
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        self._queue = queue.Queue(maxsize=self.max_queue)
        self._shed_lock = threading.Lock()
        self._stop = threading.Event()
        # metrics
        self.n_requests = 0
        self.n_batches = 0
        self.n_shed = 0
        self.batch_sizes = deque(maxlen=1000)
        self.latencies_s = deque(maxlen=1000)
        # Wall time of the device round trip per dispatch (host-side batch
        # padding + host->device copy + launches + execution + fetch): where
        # a precision's difference shows on the serving surface even when
        # requests/s is host-bound. The first dispatch that routes to a
        # kernel pays the library's load unless warmup() ran first.
        self.device_s = deque(maxlen=1000)
        self._thread = threading.Thread(target=self._collate, daemon=True)
        self._thread.start()

    def submit(self, keypoints, kk, keypoints_r=None):
        """Enqueue a request, or return None when the server is saturated
        (queue full) or shutting down: the caller sheds with 503."""
        req = _Request(keypoints, kk, keypoints_r)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            # += on an attribute is a non-atomic read-modify-write; handler
            # threads would lose increments and /metrics 'shed' would
            # disagree with the number of 503s returned.
            with self._shed_lock:
                self.n_shed += 1
            return None
        # A request enqueued concurrently with the drain loop of stop() would
        # otherwise be neither dispatched nor failed: re-drain after the put
        # once shutdown has begun.
        if self._stop.is_set():
            self._fail_pending()
        return req

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # Fail pending requests instead of leaving their handler threads to
        # wait out the timeout during shutdown.
        self._fail_pending()

    def _fail_pending(self):
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = 'server shutting down'
            req.event.set()

    def _collate(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _dispatch(self, batch):
        kps = [b.keypoints for b in batch]
        kks = [b.kk for b in batch]
        stereo = self.net.net == 'monstereo'
        kps_r = [b.keypoints_r for b in batch] if stereo else None
        try:
            t_dev = time.perf_counter()
            # This thread runs the engine: forward_batch_async enters
            # torch.inference_mode itself (the mode is per thread).
            finalize = self.net.forward_batch_async(kps, kks, kps_r)
            outs = finalize()
            self.device_s.append(time.perf_counter() - t_dev)
        except Exception as exc:  # noqa: BLE001 — surfaced per request as 500
            for b in batch:
                b.error = repr(exc)
                b.event.set()
            return
        now = time.perf_counter()
        self.n_batches += 1
        self.n_requests += len(batch)
        self.batch_sizes.append(len(batch))
        for b, o in zip(batch, outs):
            b.result = o
            self.latencies_s.append(now - b.t_enqueue)
            b.event.set()


def _percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))]


def _int8_info(net):
    """/healthz's 'int8_kernel' flag and 'int8' block. A packed kernel can
    be dormant: only dispatches of at least the engine's floor of padded MLP
    rows route to it, so the block reports the live dispatch counters too."""
    from .network import engine
    packed = getattr(net, 'mlp_weights', {}).get('packed_int8')
    n_int8 = getattr(net, 'n_dispatches_int8', 0)
    if packed is None:
        status = 'off'
    elif n_int8 > 0:
        status = 'active'
    else:
        status = ('packed-dormant (no dispatch has reached '
                  f'{engine._INT8_MIN_ROWS} rows yet)')
    info = {'status': status, 'min_rows': engine._INT8_MIN_ROWS,
            'dispatches_int8': n_int8,
            'dispatches_total': getattr(net, 'n_dispatches', 0)}
    if packed is not None:
        # The JAX package's two flavours (VMEM-resident within its stack
        # budget, HBM-streaming above it) are one kernel here, the same
        # launches either way; the flavour is reported by the JAX rule so
        # that clients read the same value.
        from .ops import dyn8_resident_eligible
        info['flavor'] = ('vmem-resident' if dyn8_resident_eligible(packed)
                          else 'hbm-streaming')
    return packed is not None, info


def make_handler(batcher, net, timeout_s=60.0):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: persistent clients reuse one connection (and
        # its server thread) across requests instead of paying a TCP
        # handshake and a thread spawn per request. Safe because every reply
        # goes through _reply, which always sends Content-Length. `timeout`
        # bounds idle keep-alive connections so abandoned clients don't pin
        # threads.
        protocol_version = 'HTTP/1.1'
        timeout = 60

        # Silence default per-request stderr logging (metrics carry counts).
        def log_message(self, fmt, *args):  # noqa: ARG002
            pass

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            try:
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # The client hung up mid-response, routine under overload.
                self.close_connection = True

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == '/healthz':
                packed, int8_info = _int8_info(net)
                self._reply(200, {
                    'status': 'ok', 'net': net.net, 'mode': net.mode,
                    'hidden': net.linear_size, 'n_stage': net.n_stage,
                    'precision': getattr(net, 'precision_raw', 'default'),
                    'serve_storage': getattr(net, 'serve_storage', 'f32'),
                    'int8_kernel': packed,
                    'int8': int8_info})
            elif self.path == '/metrics':
                lat = list(batcher.latencies_s)
                dev = list(batcher.device_s)
                self._reply(200, {
                    'requests': batcher.n_requests,
                    'batches': batcher.n_batches,
                    'shed': batcher.n_shed,
                    'queue_depth': batcher._queue.qsize(),
                    'max_queue': batcher.max_queue,
                    'mean_batch': (sum(batcher.batch_sizes)
                                   / max(1, len(batcher.batch_sizes))),
                    'max_batch': max(batcher.batch_sizes, default=0),
                    'int8_dispatches': getattr(net, 'n_dispatches_int8', 0),
                    'dispatches': getattr(net, 'n_dispatches', 0),
                    'latency_ms': None if not lat else {
                        'p50': round(_percentile(lat, 50) * 1e3, 3),
                        'p90': round(_percentile(lat, 90) * 1e3, 3),
                        'p99': round(_percentile(lat, 99) * 1e3, 3)},
                    'device_ms': None if not dev else {
                        'p50': round(_percentile(dev, 50) * 1e3, 3),
                        'p90': round(_percentile(dev, 90) * 1e3, 3),
                        'p99': round(_percentile(dev, 99) * 1e3, 3)}})
            else:
                self._reply(404, {'error': 'unknown path'})

        def do_POST(self):  # noqa: N802 — http.server API
            # Early replies that skip reading the body must CLOSE the
            # connection: under keep-alive an unread body would desynchronize
            # the stream (the next request line would be parsed from body
            # bytes). 'Connection: close' also sets self.close_connection.
            if self.path != '/v1/predict':
                self._reply(404, {'error': 'unknown path'},
                            headers={'Connection': 'close'})
                return
            if self.headers.get('Transfer-Encoding'):
                # The stdlib handler does not decode chunked bodies.
                self._reply(411, {'error': 'chunked bodies not supported; '
                                           'send Content-Length'},
                            headers={'Connection': 'close'})
                return
            length = int(self.headers.get('Content-Length', 0))
            if length > 64 * 1024 * 1024:
                self._reply(413, {'error': 'request body too large'},
                            headers={'Connection': 'close'})
                return
            try:
                req = json.loads(self.rfile.read(length))
                kps = np.asarray(req['keypoints'], np.float32)
                kk = np.asarray(req['kk'], np.float32)
                if kps.ndim != 3 or kps.shape[1:] != (3, 17):
                    raise ValueError(f'keypoints must be (m, 3, 17), '
                                     f'got {kps.shape}')
                if kk.shape != (3, 3):
                    raise ValueError(f'kk must be (3, 3), got {kk.shape}')
                kps_r = req.get('keypoints_r')
                if kps_r is not None:
                    # Validate here, not in the batcher: a dispatch-time
                    # failure poisons the whole coalesced batch with 500s.
                    kps_r = np.asarray(kps_r, np.float32)
                    if kps_r.ndim != 3 or kps_r.shape[1:] != (3, 17):
                        raise ValueError(f'keypoints_r must be (r, 3, 17), '
                                         f'got {kps_r.shape}')
            except (ValueError, KeyError, json.JSONDecodeError) as exc:
                self._reply(400, {'error': str(exc)})
                return

            r = batcher.submit(kps, kk, kps_r)
            if r is None:
                # Saturated: shed load instead of queueing without bound.
                self._reply(503, {'error': 'server overloaded'},
                            headers={'Retry-After': '1'})
                return
            if not r.event.wait(timeout_s):
                self._reply(504, {'error': 'inference timed out'})
                return
            if r.error is not None:
                self._reply(500, {'error': r.error})
                return
            # The JAX server answers with its forward_batch's keys, which
            # hold no right pose choice.
            payload = {'outputs': _to_jsonable({k: v for k, v in r.result.items()
                                                if k != 'aux_idx'})}
            boxes = req.get('boxes')
            if boxes is not None:
                dic_out = net.post_process(r.result, boxes, kps.tolist(), kk)
                payload['post_process'] = _to_jsonable(dic_out)
            self._reply(200, payload)

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of more concurrent
    # connects than that overflows it, and on loopback the extra clients
    # see their connection reset (64 keep-alive clients starting at once
    # do). Allow a burst of 128.
    request_queue_size = 128


class Server:
    """Composable server object (tests construct it with an in-memory net)."""

    def __init__(self, net, host='127.0.0.1', port=8080, window_ms=2.0,
                 max_batch=64, max_queue=None, timeout_s=60.0):
        self.net = net
        self.batcher = Batcher(net, window_ms=window_ms, max_batch=max_batch,
                               max_queue=max_queue)
        self.httpd = _HTTPServer(
            (host, port), make_handler(self.batcher, net, timeout_s=timeout_s))

    @property
    def port(self):
        return self.httpd.server_address[1]

    def warmup(self):
        """Run the single-image bucket once and, on the card, load the
        kernels' library when the engine holds a kernel pack: the 4-row
        warm-up stays below the int8 floor, and the library is built and
        loaded at first use, which would otherwise stall the collator on the
        first request that routes to a kernel."""
        kps = np.zeros((1, 3, 17), np.float32)
        kk = np.eye(3, dtype=np.float32)
        kps_r = kps if self.net.net == 'monstereo' else None
        self.net.forward_batch([kps], [kk],
                               [kps_r] if kps_r is not None else None)
        weights = self.net.mlp_weights
        has_pack = (weights.get('packed_int8') is not None
                    or weights.get('packed_bf16') is not None)
        if has_pack and self.net.device.type == 'cuda':
            from .ops import _build
            _build.load_library()

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n', 1)[0])
    parser.add_argument('--model', required=True, help='checkpoint path')
    parser.add_argument('--mode', default='mono', choices=('mono', 'stereo'))
    parser.add_argument('--net', default=None)
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--window-ms', type=float, default=2.0,
                        help='micro-batch coalescing window')
    parser.add_argument('--max-batch', type=int, default=64)
    parser.add_argument('--max-queue', type=int, default=None,
                        help='bounded request-queue depth; beyond it requests '
                             'shed with 503 (default 8 * max_batch)')
    parser.add_argument('--n-dropout', type=int, default=0,
                        help='MC-dropout samples for epistemic uncertainty')
    parser.add_argument('--dp_devices', type=int, default=1,
                        help='data-parallel devices; the port serves one card '
                             '(meshes: ROADMAP Queue 1 item 9)')
    args = parser.parse_args(argv)
    if args.dp_devices > 1:
        raise SystemExit(f"--dp_devices {args.dp_devices}: device meshes are not "
                         "ported yet (ROADMAP Queue 1 item 9); the port serves one card")
    # The JAX server's TPU liveness probe and XLA compilation cache have no
    # counterpart here (ROADMAP "Not to port").
    from .network import Loco
    net = Loco(model=args.model, mode=args.mode, net=args.net,
               n_dropout=args.n_dropout)
    server = Server(net, host=args.host, port=args.port,
                    window_ms=args.window_ms, max_batch=args.max_batch,
                    max_queue=args.max_queue)
    print('warming up (the single-image bucket and the kernels\' library)...',
          flush=True)
    server.warmup()
    print(f'serving {net.net} (hidden {net.linear_size}) on '
          f'http://{args.host}:{server.port}  '
          f'[window {args.window_ms} ms, max batch {args.max_batch}, '
          f'precision {net.precision_raw}]', flush=True)
    import signal
    # httpd.shutdown() blocks until serve_forever's loop exits; the handler
    # runs ON the main thread that loop is suspended under, so it must hand
    # the call to another thread or deadlock.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.httpd.shutdown, daemon=True).start())
    try:
        server.serve_forever()      # returns when SIGTERM shuts the httpd down
    except KeyboardInterrupt:
        pass
    server.shutdown()


if __name__ == '__main__':
    main()
