"""The host's time in `loco.d2h`, inside `finalize()`: the blocking copies
of the outputs to the host, with any wait behind work queued on the stream
after the chunk's (the next chunk's); mean a chunk over the traced window,
in ms (the program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.d2h', program_trace.FINALIZE)
