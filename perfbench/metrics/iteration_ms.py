"""The window over the benchmark's own count of ``serve_steps``
iterations in it: the serving engine's and scheduler's time an
iteration, host and card together."""


def read(run, name):
    if not run.iterations:
        return None
    return run.window_s / run.iterations * 1e3
