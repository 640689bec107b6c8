"""The 95th percentile, over every chunk completed in the window, of the
time from its `forward_batch_async` call to its `finalize()` returning
(host clock, linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [c['t_done'] - c['t_dispatch'] for c in run['chunks'] if c['in_window']]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
