"""The program's own spans and counters over a traced window, for the
readers of the per-layer metrics that read them.

The program (`monoloco_tpu_torch/utils/trace.py`) keeps a span record while
a torch.profiler session records. The harness's profiler runs over the
window and the finalizes after it, so the window's dispatches are the last
`loco.dispatch` roots kept, one a chunk of the run record, and each chunk's
`loco.finalize` root and every child span carry its dispatch id. A program
without the tracer (a commit before it) has nothing to read: `window`
then returns None, and so does every reader.
"""

DISPATCH, FINALIZE = 'loco.dispatch', 'loco.finalize'


def window(run):
    """{DISPATCH: [root records], FINALIZE: [root records], 'spans': [every
    record of those dispatches]} of the run's window, or None."""
    try:
        from monoloco_tpu_torch.utils import trace
    except ImportError:
        return None
    n = len(run['chunks'])
    recs = trace.records()
    roots = [r for r in recs if r['name'] == DISPATCH and r['parent'] is None][-n:]
    if n == 0 or not roots:
        return None
    ids = {r['dispatch'] for r in roots}
    spans = [r for r in recs if r['dispatch'] in ids]
    return {DISPATCH: roots, 'spans': spans,
            FINALIZE: [r for r in spans if r['name'] == FINALIZE and r['parent'] is None]}


def span_ms(run, name, root):
    """The time in span `name`, summed over the window, a `root` (DISPATCH
    or FINALIZE) root: its mean a chunk, in ms."""
    w = window(run)
    if w is None or not w[root]:
        return None
    parents = {r['id'] for r in w[root]}
    total = sum(r['end_ns'] - r['start_ns'] for r in w['spans']
                if r['name'] == name and r['parent'] in parents)
    return total / len(w[root]) * 1e-6


def counter(run, root, key):
    """Counter `key` of each `root` root of the window (None where absent),
    or None."""
    w = window(run)
    if w is None or not w[root]:
        return None
    return [r['attrs'].get(key) for r in w[root]]
