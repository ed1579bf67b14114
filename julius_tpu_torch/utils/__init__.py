from julius_tpu_torch.utils.jlog import jlog, set_log_output, LogLevel  # noqa: F401
from julius_tpu_torch.utils.logadd import LOG_ZERO, LOG_TEN, logsumexp_np  # noqa: F401
