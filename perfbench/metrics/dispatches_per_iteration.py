"""Steps and admission calls the engine issued in the window
(``loop_stats()["n_dispatches"]``, its difference over the window) per
``serve_steps`` iteration."""


def read(run, name):
    if not run.iterations:
        return None
    return run.dispatches / run.iterations
