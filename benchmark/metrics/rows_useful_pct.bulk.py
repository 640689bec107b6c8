"""The MLP rows the window's chunks needed over the rows the engine ran,
in %: the `loco.dispatch` counters `rows_useful` (sum L, or L x R, a frame)
and `rows_run` (the padded bucket), summed over the traced window (the
program's counters). Padding shows as a lower share."""

from benchmark import program_trace


def read(run):
    useful = program_trace.counter(run, program_trace.DISPATCH, 'rows_useful')
    ran = program_trace.counter(run, program_trace.DISPATCH, 'rows_run')
    if useful is None or None in useful or None in ran or sum(ran) == 0:
        return None
    return 100.0 * sum(useful) / sum(ran)
