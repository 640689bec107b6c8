"""The port's serving endpoint (monoloco_tpu_torch/serve.py) on the CPU,
against the JAX package's (monoloco_tpu/serve.py).

The port of every `tests/test_serve.py` case that needs no mesh drives a
real ThreadingHTTPServer on an ephemeral port over a CPU `Loco` (hidden 64,
2 stages). The parity cases send the same payloads, made from a numpy seed,
to a JAX `Server` and a port `Server` over the same weights (the JAX
package's `init_loco_params` arrays carried across as numpy, with output
biases that put people 15 m ahead of the camera, as a trained net does:
random biases give z near 0, where the yaw's atan2 magnifies the last ulp).
Tolerances: outputs and post_process within 1e-5 (stereo xyzd 1e-4), two
f32 frameworks with two sum orders; under int8 (the routing floor patched
low in both engines, so that every dispatch routes) the dyn8 plain version
against the JAX kernel in interpret mode by mean (2e-3 of the mean) and max
(1e-2), as `tests/test_torch_engine.py` holds them, since a last-ulp
difference can flip one quantization tie.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu.network import engine as jax_engine
from monoloco_tpu.serve import Server as JaxServer
from monoloco_tpu_torch import serve
from monoloco_tpu_torch.network import Loco, engine
from monoloco_tpu_torch.ops import _build, pack_folded_weights_w8
from monoloco_tpu_torch.serve import Batcher, Server

KK = [[718.0, 0.0, 600.0], [0.0, 718.0, 180.0], [0.0, 0.0, 1.0]]
TOL = 1e-5


def _post(port, payload, timeout=30):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/predict', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}', timeout=30) as resp:
        return json.loads(resp.read())


def _keypoints(m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, 3, 17) * 300).tolist()


def _weights(key, in_dim, out_dim, hidden=64, n_stage=2):
    """JAX init arrays as numpy, people 15 m ahead (theta = psi = pi/2)."""
    params, bn = jax_init(jax.random.PRNGKey(key), in_dim, out_dim, hidden, n_stage)
    params, bn = jax.tree_util.tree_map(np.array, params), jax.tree_util.tree_map(np.array, bn)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    return params, bn


class _Running:
    """A server serving on a daemon thread; shut down on exit."""

    def __init__(self, srv):
        self.srv = srv

    def __enter__(self):
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        return self.srv

    def __exit__(self, *exc):
        self.srv.shutdown()


@pytest.fixture(scope='module')
def server():
    net = Loco(_weights(0, 34, 9), mode='mono', device='cpu')
    # Generous window so the coalescing test can't race; port 0 = ephemeral.
    srv = Server(net, port=0, window_ms=300.0, max_batch=64)
    srv.warmup()
    with _Running(srv):
        yield srv


def test_healthz(server):
    h = _get(server.port, '/healthz')
    assert h['status'] == 'ok'
    assert h['net'] == 'monoloco_pp' and h['hidden'] == 64 and h['n_stage'] == 2
    assert h['precision'] == 'default' and h['int8_kernel'] is False
    assert h['serve_storage'] == 'f32' and h['int8']['status'] == 'off'


def test_healthz_reports_packed_kernel_flavor():
    """With the dyn8 kernel packed, /healthz reports dormant-vs-active status
    and the JAX flavour name (vmem-resident within the 16 MB stack budget)."""
    net = Loco(_weights(0, 34, 9, hidden=128), mode='mono', device='cpu')
    net.mlp_weights['packed_int8'] = pack_folded_weights_w8(net.folded)
    with _Running(Server(net, port=0, window_ms=5.0, max_batch=4)) as srv:
        h = _get(srv.port, '/healthz')
    assert h['int8_kernel'] is True
    assert h['int8']['status'].startswith('packed-dormant')
    assert h['int8']['flavor'] == 'vmem-resident'
    assert h['int8']['min_rows'] == engine._INT8_MIN_ROWS


def test_healthz_reports_the_raw_precision_spelling(monkeypatch):
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'fp32')
    net = Loco(_weights(0, 34, 9), mode='mono', device='cpu')
    with _Running(Server(net, port=0)) as srv:
        h = _get(srv.port, '/healthz')
    assert h['precision'] == 'fp32' and net.precision == 'float32'


def test_predict_single(server):
    o = _post(server.port, {'keypoints': _keypoints(3), 'kk': KK})['outputs']
    assert len(o['xyzd']) == 3 and len(o['xyzd'][0]) == 4
    assert len(o['bi']) == 3
    assert len(o['yaw']) == 2 and len(o['yaw'][0]) == 3
    assert all(np.isfinite(o['bi']))


def test_predict_with_post_process(server):
    boxes = [[10.0, 10.0, 100.0, 200.0, 0.9], [200.0, 20.0, 280.0, 190.0, 0.8]]
    pp = _post(server.port, {'keypoints': _keypoints(2), 'kk': KK, 'boxes': boxes})['post_process']
    assert len(pp['dds_pred']) == len(pp['xyz_pred']) == len(pp['boxes']) == 2


def test_concurrent_requests_coalesce(server):
    """8 concurrent clients inside one 300 ms window land in shared batches."""
    before = server.batcher.n_batches
    results, errs = [], []

    def call(i):
        try:
            results.append(_post(server.port, {'keypoints': _keypoints(2, seed=i), 'kk': KK}))
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errs.append(exc)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and len(results) == 8
    assert all(len(r['outputs']['xyzd']) == 2 for r in results)
    made = server.batcher.n_batches - before
    assert made < 8, f'8 requests used {made} batches: no coalescing happened'
    m = _get(server.port, '/metrics')
    assert m['max_batch'] >= 2
    assert m['latency_ms'] is None or m['latency_ms']['p50'] > 0


def test_malformed_requests(server):
    for payload, msg in (
            ({'kk': KK}, 'missing keypoints'),
            ({'keypoints': [[1.0, 2.0]], 'kk': KK}, 'bad shape'),
            ({'keypoints': _keypoints(1), 'kk': [[1.0]]}, 'bad kk'),
            ({'keypoints': _keypoints(1), 'kk': KK, 'keypoints_r': [[1.0, 2.0]]},
             'bad keypoints_r shape')):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.port, payload)
        assert exc.value.code == 400, msg


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.port, '/nope')
    assert exc.value.code == 404


def test_stop_drains_pending_requests():
    """Requests still queued at shutdown fail at once instead of leaving
    their handler threads to wait out the timeout."""
    batcher = Batcher(net=None)          # net is only touched at dispatch
    batcher._stop.set()
    batcher._thread.join(timeout=5)
    req = batcher.submit(np.zeros((1, 3, 17), np.float32), np.eye(3, dtype=np.float32))
    batcher.stop()
    assert req.event.is_set()
    assert req.error == 'server shutting down'


@pytest.mark.parametrize('bad', [0, -1])
def test_non_positive_max_queue_rejected(bad):
    """queue.Queue(maxsize<=0) means UNBOUNDED: the Batcher refuses it."""
    with pytest.raises(ValueError, match='max_queue'):
        Batcher(net=None, max_queue=bad)


def test_shed_counter_is_thread_safe():
    """Concurrent queue-full submits lose no shed increment; the switch
    interval is shortened so that a lost update would show."""
    import sys
    batcher = Batcher(net=None, max_queue=1)
    batcher._stop.set()                  # collator idle: the queue stays full
    batcher._thread.join(timeout=5)
    batcher._queue.put_nowait(object())
    n_threads, per_thread = 16, 50
    kps, kk = np.zeros((1, 3, 17), np.float32), np.eye(3, dtype=np.float32)
    shed = []

    def shed_many():
        shed.extend(batcher.submit(kps, kk) is None for _ in range(per_thread))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=shed_many) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(shed) and batcher.n_shed == n_threads * per_thread


class _SlowNet:
    """Dispatch-compatible stub whose forward takes `delay_s` per batch, to
    saturate the server without a slow real model."""
    net = 'monoloco_pp'
    mode = 'mono'
    linear_size = 64
    n_stage = 2

    def __init__(self, delay_s=0.2):
        self.delay_s = delay_s

    def forward_batch_async(self, kps_list, kk_list, kps_r_list=None):
        def finalize():
            time.sleep(self.delay_s)
            return [{'d': np.zeros((len(k), 1), np.float32)} for k in kps_list]

        return finalize


def _call_quietly(port, i):
    try:
        _post(port, {'keypoints': _keypoints(1, seed=i), 'kk': KK}, timeout=3)
    except (urllib.error.URLError, OSError):  # these requests only saturate
        pass


def test_overload_sheds_with_503():
    """Offered load beyond throughput sheds with 503 under a bounded queue."""
    codes, lock = [], threading.Lock()

    def call(port, i):
        try:
            _post(port, {'keypoints': _keypoints(1, seed=i), 'kk': KK})
            code = 200
        except urllib.error.HTTPError as exc:
            code = exc.code
        with lock:
            codes.append(code)

    with _Running(Server(_SlowNet(delay_s=0.3), port=0, window_ms=1.0, max_batch=1,
                         max_queue=2)) as srv:
        threads = [threading.Thread(target=call, args=(srv.port, i)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(codes) == 12
        assert codes.count(503) >= 1 and codes.count(200) >= 1, codes
        assert set(codes) <= {200, 503}, codes
        m = _get(srv.port, '/metrics')
        assert m['shed'] == codes.count(503)
        assert m['queue_depth'] <= m['max_queue'] == 2


def test_overload_503_carries_retry_after():
    with _Running(Server(_SlowNet(delay_s=10.0), port=0, window_ms=1.0, max_batch=1,
                         max_queue=1)) as srv:
        for i in range(2):
            threading.Thread(target=_call_quietly, args=(srv.port, i), daemon=True).start()
        # Wait until one request is in dispatch and one holds the depth-1
        # queue slot, read twice 0.3 s apart (the collator polls every
        # 0.1 s, so a free collator would have drained it); top the queue
        # up if a saturating request was shed before the other dispatched.
        stable, m = False, {}
        deadline = time.time() + 30
        while time.time() < deadline and not stable:
            m = _get(srv.port, '/metrics')
            if m['queue_depth'] >= 1:
                time.sleep(0.3)
                stable = _get(srv.port, '/metrics')['queue_depth'] >= 1
                continue
            if m['shed'] > 0:
                threading.Thread(target=_call_quietly, args=(srv.port, 99), daemon=True).start()
                time.sleep(0.1)
            time.sleep(0.05)
        assert stable, f'saturation never stabilized: {m}'
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.port, {'keypoints': _keypoints(1, seed=9), 'kk': KK}, timeout=30)
        assert exc.value.code == 503
        assert exc.value.headers.get('Retry-After') == '1'


def test_stereo_server():
    """MonStereo serving: keypoints_r present and absent (the first left pose
    stands in, as Loco.forward does)."""
    net = Loco(_weights(1, 68, 10), mode='stereo', device='cpu')
    srv = Server(net, port=0, window_ms=50.0, max_batch=16)
    srv.warmup()
    with _Running(srv):
        out = _post(srv.port, {'keypoints': _keypoints(2), 'kk': KK,
                               'keypoints_r': _keypoints(3, seed=5)})
        assert len(out['outputs']['xyzd']) == 2 and len(out['outputs']['aux']) == 2
        out2 = _post(srv.port, {'keypoints': _keypoints(2), 'kk': KK})
        assert len(out2['outputs']['xyzd']) == 2
        assert _get(srv.port, '/healthz')['net'] == 'monstereo'


def test_keepalive_connection_reuse(server):
    """HTTP/1.1 keep-alive: several requests, then a GET, on ONE connection."""
    conn = http.client.HTTPConnection('127.0.0.1', server.port, timeout=30)
    try:
        for i in range(3):
            body = json.dumps({'keypoints': _keypoints(2, seed=i), 'kk': KK}).encode()
            conn.request('POST', '/v1/predict', body=body,
                         headers={'Content-Type': 'application/json'})
            resp = conn.getresponse()
            assert resp.version == 11 and resp.status == 200
            assert len(json.loads(resp.read())['outputs']['xyzd']) == 2
            assert (resp.getheader('Connection') or '').lower() != 'close'
        conn.request('GET', '/healthz')
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())['status'] == 'ok'
    finally:
        conn.close()


def _early_reply(port, send):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=30)
    try:
        send(conn)
        resp = conn.getresponse()
        resp.read()
        return resp.status, (resp.getheader('Connection') or '').lower()
    finally:
        conn.close()


def _wrong_path(conn):
    conn.request('POST', '/nope', body=json.dumps({'keypoints': _keypoints(2), 'kk': KK}).encode(),
                 headers={'Content-Type': 'application/json'})


def _too_large(conn):
    conn.putrequest('POST', '/v1/predict')
    conn.putheader('Content-Type', 'application/json')
    conn.putheader('Content-Length', str(65 * 1024 * 1024))
    conn.endheaders()


def _chunked(conn):
    conn.putrequest('POST', '/v1/predict')
    conn.putheader('Content-Type', 'application/json')
    conn.putheader('Transfer-Encoding', 'chunked')
    conn.endheaders()
    conn.send(b'0\r\n\r\n')


def test_keepalive_early_replies_close_the_connection(server):
    """Replies sent without reading the body (404, 413, 411) carry
    Connection: close, and the server is unharmed after them."""
    for send, code in ((_wrong_path, 404), (_too_large, 413), (_chunked, 411)):
        assert _early_reply(server.port, send) == (code, 'close')
    out = _post(server.port, {'keypoints': _keypoints(2), 'kk': KK})
    assert len(out['outputs']['xyzd']) == 2


def test_warmup_loads_the_kernels_only_for_a_pack_on_the_card(monkeypatch):
    """warmup() loads the kernels' library when the engine holds a kernel
    pack on the card, and never for a CPU engine (the CPU has no nvcc)."""
    loads = []
    monkeypatch.setattr(_build, 'load_library', lambda: loads.append(1))

    class _CardNet:
        net = 'monoloco_pp'

        def __init__(self, weights):
            self.mlp_weights = weights
            self.device = torch.device('cuda')

        def forward_batch(self, *args):
            return [None]

    for weights, n in (({'packed_int8': None, 'packed_bf16': None}, 0),
                       ({'packed_int8': object(), 'packed_bf16': None}, 1),
                       ({'packed_int8': None, 'packed_bf16': object()}, 2)):
        srv = Server(_CardNet(weights), port=0)
        try:
            srv.warmup()
        finally:
            srv.httpd.server_close()
            srv.batcher.stop()
        assert len(loads) == n
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    cpu = Loco(_weights(0, 34, 9, hidden=128), mode='mono', device='cpu')
    assert cpu.mlp_weights['packed_int8'] is not None
    srv = Server(cpu, port=0)
    try:
        srv.warmup()
    finally:
        srv.httpd.server_close()
        srv.batcher.stop()
    assert len(loads) == 2


def test_main_needs_a_card(monkeypatch):
    """serve.main builds the engine on the card and raises without one; it
    never serves on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    served = []
    monkeypatch.setattr(Server, 'serve_forever', lambda self: served.append(self))
    with pytest.raises(RuntimeError, match='no CUDA card'):
        serve.main(['--model', 'tests/goldens/byte_compat/model_tpu.pkl', '--port', '0'])
    assert not served


def test_main_refuses_a_mesh(monkeypatch):
    """The name is kept from when the port refused a mesh: `--dp_devices`
    serves now. A one-rank mesh (gloo, in this process) warms up and
    serves; tests/test_torch_parallel.py serves over two ranks."""
    import signal
    served = []

    def serve_briefly(self):
        # The loop runs on a thread, so that main's shutdown finds it.
        served.append(self)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    monkeypatch.setattr(Server, 'serve_forever', serve_briefly)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        serve.main(['--model', 'tests/goldens/byte_compat/model_tpu.pkl', '--port', '0',
                    '--dp_devices', '1', '--disable-cuda'])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert len(served) == 1 and served[0].net.mesh.dp == 1
    assert served[0].net.n_dispatches == 1


# --- parity with the JAX server ---------------------------------------------

def _pair(weights, mode, **kwargs):
    """(JAX Loco, port Loco) over the same numpy weights."""
    return (JaxLoco(model=weights, mode=mode, **kwargs),
            Loco(model=weights, mode=mode, device='cpu', **kwargs))


def _payloads(n, stereo, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        m = int(rng.randint(1, 5))
        kps = rng.rand(m, 3, 17)
        kps[:, 0] = kps[:, 0] * 800 + 200
        kps[:, 1] = kps[:, 1] * 200 + 80
        kps[:, 2] = rng.uniform(0.3, 1.0, size=(m, 17))
        req = {'keypoints': kps.tolist(), 'kk': KK}
        if stereo and i % 3:
            right = kps.copy()
            right[:, 0] -= 40 + 20 * rng.rand(m, 1)
            req['keypoints_r'] = right[:int(rng.randint(1, m + 1))].tolist()
        if i % 2:
            x0 = rng.uniform(0, 900, size=m)
            req['boxes'] = [[float(x), 50.0, float(x) + 80, 250.0, 0.9] for x in x0]
        out.append(req)
    return out


def _serve_all(net, payloads):
    """Every payload POSTed concurrently (one coalescing window); returns
    the responses in payload order and /metrics."""
    results = [None] * len(payloads)
    with _Running(Server(net, port=0, window_ms=200.0, max_batch=16)) as srv:
        def call(i):
            results[i] = _post(srv.port, payloads[i], timeout=300)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        metrics = _get(srv.port, '/metrics')
    assert all(r is not None for r in results)
    return results, metrics


def _assert_close(ours, ref, key, rule):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, key
    if a.size == 0:
        return
    if rule == 'int8':
        diff = np.abs(a - b)
        assert diff.mean() <= 2e-3 * max(np.abs(b).mean(), 1e-6) and diff.max() <= 1e-2, key
    else:
        np.testing.assert_allclose(a, b, rtol=rule, atol=rule, err_msg=key)


def _assert_responses_match(ours, refs, stereo, int8=False):
    for o, j in zip(ours, refs):
        assert set(o) == set(j)
        assert set(o['outputs']) == set(j['outputs'])
        for key, v in j['outputs'].items():
            rule = 'int8' if int8 else (1e-4 if stereo and key == 'xyzd' else TOL)
            _assert_close(o['outputs'][key], v, key, rule)
        if 'post_process' in j:
            assert set(o['post_process']) == set(j['post_process'])
            for key, v in j['post_process'].items():
                if key in ('gt', 'indices', 'boxes', 'uv_kps', 'uv_centers', 'uv_shoulders',
                           'uv_heads'):
                    assert o['post_process'][key] == v, key
                else:
                    rule = 'int8' if int8 else (1e-4 if stereo and key in (
                        'xyz_pred', 'confs') else TOL)
                    _assert_close(o['post_process'][key], v, key, rule)


@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_responses_match_the_jax_server(mode):
    stereo = mode == 'stereo'
    weights = _weights(1, 68, 10) if stereo else _weights(0, 34, 9)
    jnet, net = _pair(weights, mode)
    payloads = _payloads(6, stereo)
    refs, _ = _serve_all(jnet, payloads)
    ours, metrics = _serve_all(net, payloads)
    _assert_responses_match(ours, refs, stereo)
    assert metrics['requests'] == 6 and metrics['int8_dispatches'] == 0


def test_int8_responses_match_the_jax_server(monkeypatch):
    """int8 with the floor at the smallest padded dispatch in both engines:
    every dispatch routes, the port's dyn8 (plain version on the CPU)
    against the JAX kernel in interpret mode."""
    monkeypatch.setattr(jax_engine, '_INT8', True)
    monkeypatch.setattr(jax_engine, '_INT8_MIN_ROWS', 4)
    monkeypatch.setattr(engine, '_INT8_MIN_ROWS', 4)
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    jnet, net = _pair(_weights(0, 34, 9, hidden=128), 'mono')
    assert net.mlp_weights['packed_int8'] is not None
    payloads = _payloads(6, False, seed=5)
    refs, jmetrics = _serve_all(jnet, payloads)
    ours, metrics = _serve_all(net, payloads)
    _assert_responses_match(ours, refs, False, int8=True)
    assert metrics['int8_dispatches'] == metrics['dispatches'] >= 1
    assert jmetrics['int8_dispatches'] == jmetrics['dispatches'] >= 1


def _key_sets(d, prefix=''):
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= _key_sets(v, prefix + k + '.')
    return keys


@pytest.mark.parametrize('int8', [False, True])
def test_healthz_and_metrics_keys_are_the_jax_servers(monkeypatch, int8):
    if int8:
        monkeypatch.setattr(jax_engine, '_INT8', True)
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    # One floor in both, so that the routing status reads alike.
    monkeypatch.setattr(jax_engine, '_INT8_MIN_ROWS', engine._INT8_MIN_ROWS)
    jnet, net = _pair(_weights(0, 34, 9, hidden=128), 'mono')
    assert (net.mlp_weights['packed_int8'] is not None) == int8
    seen = []
    for n in (jnet, net):
        with _Running(Server(n, port=0) if n is net else JaxServer(n, port=0)) as srv:
            _post(srv.port, {'keypoints': _keypoints(2), 'kk': KK})
            seen.append((_get(srv.port, '/healthz'), _get(srv.port, '/metrics')))
    (jh, jm), (h, m) = seen
    assert _key_sets(h) == _key_sets(jh)
    assert _key_sets(m) == _key_sets(jm)
    assert h['int8']['status'] == jh['int8']['status']
    assert h['int8'].get('flavor') == jh['int8'].get('flavor')


def _status_codes(port):
    """The codes (and Connection headers of the early replies) that bad
    requests get."""
    row = []
    for payload in ({'kk': KK}, {'keypoints': [[1.0, 2.0]], 'kk': KK},
                    {'keypoints': _keypoints(1), 'kk': [[1.0]]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, payload)
        row.append(exc.value.code)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(port, '/nope')
    row.append(exc.value.code)
    return row + [_early_reply(port, send) for send in (_wrong_path, _too_large, _chunked)]


def test_status_codes_are_the_jax_servers(server):
    with _Running(JaxServer(JaxLoco(model=_weights(0, 34, 9), mode='mono'), port=0)) as jsrv:
        ref = _status_codes(jsrv.port)
    assert _status_codes(server.port) == ref == [400, 400, 400, 404, (404, 'close'),
                                                 (413, 'close'), (411, 'close')]


def test_dispatch_counters_count_as_the_jax_engine():
    """One count a forward_batch call, its MC dispatch included, in both."""
    weights = _weights(0, 34, 9)
    jnet, net = _pair(weights, 'mono', n_dropout=3)
    kps = [np.asarray(_keypoints(2, seed=i), np.float32) for i in range(3)]
    for n in (jnet, net):
        n.forward_batch(kps, [np.asarray(KK, np.float32)] * 3)
        n.forward(kps[0], np.asarray(KK, np.float32))
    assert (net.n_dispatches, net.n_dispatches_int8) == (jnet.n_dispatches,
                                                         jnet.n_dispatches_int8) == (2, 0)
