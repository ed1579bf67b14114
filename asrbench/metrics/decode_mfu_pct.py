"""decode_mfu_pct: the least time of all the untraced window's work (the
DNN, every utterance's pass-1 frames, every A* round's word scans, each
at its peak FLOP rate or HBM bandwidth, asrbench/counts.py) over that
window's wall time: the whole decode's share of the card's peak.  In a
traced run the window is the untraced one before the profiled window,
so the spans' synchronisation does not move it."""


def read(run):
    least = sum(run.plain_least_s.values())
    if run.plain_window_s <= 0 or least <= 0:
        return None
    return 100.0 * least / run.plain_window_s
