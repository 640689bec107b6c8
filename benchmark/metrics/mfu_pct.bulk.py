"""The whole dispatch's share of the chip's peak: the operations the
useful rows need over the traced window's wall times the published peak of
the cell's precision, in %."""


def read(run):
    tr = run['trace']
    if not tr or tr['window_s'] <= 0:
        return None
    ops = sum(c['ops'] for c in run['chunks'] if c['ok'])
    if ops == 0:
        return None
    return 100.0 * ops / (tr['window_s'] * run['peak_ops_per_s'])
