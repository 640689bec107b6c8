"""The host's time in `loco.h2d`, inside `Loco.forward_batch_async`: the
blocking copies of the padded arrays to the device; mean a chunk over the
traced window, in ms (the program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.h2d', program_trace.DISPATCH)
