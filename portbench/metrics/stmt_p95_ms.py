"""stmt_p95_ms: the 95th percentile of every statement's latency in the
window, host clock from the execute call to its return, in ms."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
