"""Process start to the first timed chunk's dispatch (host clock): CUDA
start-up, the kernels' library from the build cache (built on a checkout's
first run), the frames and the weights, `Loco` (BN fold, int8 or bf16
pack), the warm-up chunks, and in a traced run the profiler's start."""


def read(run):
    return run['setup_s']
