"""entry.p95_ms: the 95th percentile of submit-to-completion latency, on
the harness's clock, over every query completed inside the window."""

import numpy as np


def read(run):
    if not run.window:
        return None
    lat = np.asarray([d.latency_s for d in run.window], np.float64)
    return float(np.percentile(lat, 95) * 1e3)
