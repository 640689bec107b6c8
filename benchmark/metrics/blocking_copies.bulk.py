"""The blocking copies a chunk makes between host and device: the mean
over the traced window of `h2d_copies` (`loco.dispatch`) plus that of
`d2h_copies` (`loco.finalize`) (the program's counters)."""

from benchmark import program_trace


def read(run):
    h2d = program_trace.counter(run, program_trace.DISPATCH, 'h2d_copies')
    d2h = program_trace.counter(run, program_trace.FINALIZE, 'd2h_copies')
    if h2d is None or d2h is None or None in h2d or None in d2h:
        return None
    return sum(h2d) / len(h2d) + sum(d2h) / len(d2h)
