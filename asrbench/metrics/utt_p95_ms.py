"""utt_p95_ms: the 95th percentile of the same delays (host clock)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 95))
