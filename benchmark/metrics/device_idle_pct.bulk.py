"""The share of the traced window in which no operation ran on the device
(torch.profiler: the union of kernels, copies and sets), in %."""


def read(run):
    tr = run['trace']
    if not tr or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
