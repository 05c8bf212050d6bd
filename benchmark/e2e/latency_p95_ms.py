"""latency_p95_ms: the 95th percentile, over every request of the window,
of the time from the call's start to its detections on the host (linear
interpolation between order statistics), host clock."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([(r["t1"] - r["t0"]) * 1e3 for r in run.requests], 95))
