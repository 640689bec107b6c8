"""Left-view detections whose outputs `finalize()` returned inside the
window, over the window's seconds (host clock): all of the window's work
over all of its time."""


def read(run):
    chunks = [c for c in run['chunks'] if c['in_window']]
    if not chunks:
        return None
    return sum(c['detections'] for c in chunks) / run['window_s']
