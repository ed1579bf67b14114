"""Log-space arithmetic helpers.

The reference uses a table-driven log-add (`libsent/src/phmm/addlog.c`) to
accumulate Gaussian mixture likelihoods; on TPU we use exact vectorised
logsumexp (a handful of transcendentals on the VPU is cheap), so no table is
needed.  Scores follow the reference's conventions: acoustic likelihoods are
natural-log, N-gram probabilities are base-10 log as read from ARPA files
(the LM weight absorbs the base difference, like Julius's tuned defaults).
"""

from __future__ import annotations

import math

import numpy as np

# Large negative stand-in for log(0) that survives f32 arithmetic without
# producing NaN on subtraction (reference LOG_ZERO semantics).
LOG_ZERO = -1.0e10
LOG_TEN = math.log(10.0)


def logsumexp_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Numerically stable logsumexp treating <= LOG_ZERO/2 as -inf."""
    m = np.max(x, axis=axis, keepdims=True)
    safe = np.where(m <= LOG_ZERO / 2, 0.0, m)
    s = np.sum(np.exp(x - safe), axis=axis, keepdims=True)
    out = np.where(m <= LOG_ZERO / 2, LOG_ZERO, safe + np.log(np.maximum(s, 1e-300)))
    return np.squeeze(out, axis=axis)
