"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card (the profiler's device activity)."""


def read(run):
    if run.trace_window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
