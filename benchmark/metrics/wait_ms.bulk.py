"""The host's time in `loco.wait`, inside `finalize()`: waiting for the
chunk's own device work; mean a chunk over the traced window, in ms (the
program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.wait', program_trace.FINALIZE)
