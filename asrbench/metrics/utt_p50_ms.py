"""utt_p50_ms: the median delay from handing a call its features to its
results, over every call of the window (host clock; one utterance a
call in the cells that report it)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 50))
