"""Process start to the first timed submit: imports, the CUDA context, the
kernels' build or load, the weights (trained on a checkout's first run,
loaded from its cache after), the traffic and the warm-up iterations."""


def read(run, name):
    return run.setup_s
