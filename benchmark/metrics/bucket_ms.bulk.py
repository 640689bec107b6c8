"""The host's time in `loco.bucket`, inside `Loco.forward_batch_async`:
the buckets, the padded host arrays and their per-frame fills; mean a
chunk over the traced window, in ms (the program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.bucket', program_trace.DISPATCH)
