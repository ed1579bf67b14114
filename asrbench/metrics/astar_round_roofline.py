"""astar_round_roofline: the least time of the word scans of every
A* round the card ran (asrbench/counts.py scan_bytes / scan_ops at the
round's K pops, its window W and chain length N) over the device time
of everything launched in the A* span and its `prepare`."""


def read(run):
    dev = run.device_s.get("astar", 0.0) + run.device_s.get("prepare", 0.0)
    if dev <= 0 or run.least_s.get("astar", 0.0) <= 0:
        return None
    return 100.0 * run.least_s["astar"] / dev
