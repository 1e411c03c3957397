"""The 95th percentile of the latencies of every query completed in the
window: from its ``submit`` to the end of the iteration that returned it
(host clock)."""

import numpy as np


def read(run, name):
    if not run.completions:
        return None
    lat = np.array([c.latency_s for c in run.completions])
    return float(np.percentile(lat, 95)) * 1e3
