"""The host's time in `loco.launch`, inside `Loco.forward_batch_async`:
enqueueing preprocess, the MLP, the argmax, decode and the MC passes; mean a
chunk over the traced window, in ms (the program's span)."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, 'loco.launch', program_trace.DISPATCH)
