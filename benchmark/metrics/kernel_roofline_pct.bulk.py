"""The operations the useful rows need (`benchmark/flops.py`), over the
device's kernel time (the union of the traced window's kernels) times the
published peak of the cell's precision (`benchmark/peaks.json`), in %."""


def read(run):
    tr = run['trace']
    if not tr or tr['kernel_busy_s'] <= 0:
        return None
    ops = sum(c['ops'] for c in run['chunks'] if c['ok'])
    if ops == 0:
        return None
    return 100.0 * ops / (tr['kernel_busy_s'] * run['peak_ops_per_s'])
