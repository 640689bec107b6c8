"""Start a mesh: dp x tp processes, one a device, in one process group.

`launch(fn, dp, tp, args, kwargs, device_type)` runs `fn(mesh, *args,
**kwargs)` on every
rank and returns rank 0's result. Rank 0 is the calling process: it prints,
writes files and handles signals as the single-device entry point does.
Ranks 1.. are processes started with `torch.multiprocessing`'s spawn
context; their standard output goes nowhere and their logging is off, so
that rank 0 alone speaks. The group meets through a `file://` store in a
fresh temporary directory, so launches in parallel (test workers) never
share a port or a file. On the card each rank takes the card of its number
and the group is NCCL's; on the CPU it is gloo's.

No fallback: a mesh asked for on the card with more ranks than
`torch.cuda.device_count()` exits with the JAX CLI's message, and nothing
drops to gloo, to the CPU or to fewer ranks.

`timeout` (seconds) bounds every collective and the wait for the other
ranks: a rank that dies or hangs makes the launch raise instead of hanging.
"""

import datetime
import logging
import os
import queue
import shutil
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh_2d

DEFAULT_TIMEOUT_S = 1800.0          # torch.distributed's own default


def check_devices(dp, tp, device_type):
    """Exit with the JAX CLI's message when the card's machine has fewer
    devices than the mesh needs."""
    if device_type == 'cuda':
        have = torch.cuda.device_count()
        if have < dp * tp:
            raise SystemExit(f"--dp_devices {dp} x --tp_devices {tp} requested but only "
                             f"{have} devices are available")


def _join(rank, dp, tp, device_type, init, timeout, threads):
    if device_type == 'cuda':
        torch.cuda.set_device(rank)
        device, backend = torch.device('cuda', rank), 'nccl'
    else:
        torch.set_num_threads(threads)
        device, backend = torch.device('cpu'), 'gloo'
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=dp * tp,
                            timeout=datetime.timedelta(seconds=timeout))
    return make_mesh_2d(dp, tp, device)


def _leave():
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, dp, tp, device_type, init, timeout, threads, fn, args, kwargs, errors):
    """Ranks 1..: silent, report a failure to rank 0 through `errors`."""
    sys.stdout = open(os.devnull, 'w')
    logging.disable(logging.INFO)
    try:
        fn(_join(rank, dp, tp, device_type, init, timeout, threads), *args, **kwargs)
    except BaseException:  # noqa: BLE001 — reported to rank 0, then the rank exits non-zero
        errors.put((rank, traceback.format_exc()))
        raise
    finally:
        _leave()


def launch(fn, dp, tp=1, args=(), kwargs=None, device_type='cuda', timeout=None):
    """Run `fn(mesh, *args, **kwargs)` on a dp x tp mesh (`fn` importable by name: the
    other ranks are spawned); returns rank 0's result. Raises when a rank
    fails, or when the other ranks are not done `timeout` seconds after
    rank 0."""
    check_devices(dp, tp, device_type)
    timeout = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)
    world = dp * tp
    kwargs = kwargs or {}
    ctx = mp.get_context('spawn')
    errors = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix='monoloco_mesh_')
    init = 'file://' + os.path.join(store_dir, 'store')
    threads_before = torch.get_num_threads()
    threads = max(1, threads_before // world)
    procs = [ctx.Process(target=_rank_main, args=(rank, dp, tp, device_type, init, timeout,
                                                    threads, fn, args, kwargs, errors))
             for rank in range(1, world)]
    try:
        for p in procs:
            p.start()
        try:
            result = fn(_join(0, dp, tp, device_type, init, timeout, threads), *args, **kwargs)
        except BaseException as exc:
            failed = _failures(procs, errors, wait_s=5.0)
            if failed:
                raise RuntimeError(f"mesh rank failed: {failed}") from exc
            raise
        finally:
            _leave()
        failed = _failures(procs, errors, wait_s=timeout)
        if failed:
            raise RuntimeError(f"mesh rank failed: {failed}")
        return result
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(5)
        torch.set_num_threads(threads_before)
        shutil.rmtree(store_dir, ignore_errors=True)


def _failures(procs, errors, wait_s):
    """Join the spawned ranks within `wait_s` seconds in all; the failures
    as text (a traceback, a non-zero exit code, or a rank still running)."""
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=wait_s)
    for p in procs:
        p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    messages = []
    while True:
        try:
            rank, text = errors.get(timeout=0.1)
        except queue.Empty:
            break
        messages.append(f"rank {rank}:\n{text}")
    for rank, p in enumerate(procs, start=1):
        if p.is_alive():
            messages.append(f"rank {rank} still running after {wait_s:.0f} s")
        elif p.exitcode != 0 and not any(m.startswith(f"rank {rank}:") for m in messages):
            messages.append(f"rank {rank} exited with code {p.exitcode}")
    return '\n'.join(messages)
