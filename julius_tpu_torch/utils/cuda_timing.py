"""Device time of a call on an NVIDIA card, between CUDA events."""

from __future__ import annotations

import statistics

import torch


def time_ms(fn, n: int = 60, warm: int = 5) -> float:
    """Median device time of one fn() call, in ms.  A sleep kernel is
    queued first so the host enqueues every call before the card reaches
    them: the events then bracket device work only, not host gaps."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    evs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)
