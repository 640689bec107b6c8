"""The host's time inside `Loco.forward_batch_async` (packing, the copies
to the device, the launches), mean over the window's chunks, from the
harness's span around the call (host clock, traced run)."""


def read(run):
    spans = [c['dispatch_s'] for c in run['chunks'] if c['in_window']]
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
