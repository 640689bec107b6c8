"""The host's time in `loco.unpack`, inside `finalize()`: slicing the
outputs frame by frame; mean a chunk over the traced window, in ms (the
program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.unpack', program_trace.FINALIZE)
