"""Device time of a call on an NVIDIA card, between CUDA events."""

from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 100_000_000   # a head start for the host (about 50 ms)


def time_ms(fn, n: int = 60, warm: int = 5, before=None) -> float:
    """Median device time of one fn() call, in ms.  A sleep kernel is
    queued first so the host enqueues every call before the card reaches
    them: the events then bracket device work only, not host gaps.
    `before()`, if given, runs ahead of each call outside its events
    (an `l2_flush` for a cold-cache time)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    evs = []
    for _ in range(n):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def chain_ms(step, state, n: int = 60, warm: int = 5) -> float:
    """Device time of one link of a chain of n dependent calls, in ms:
    state = step(state) n times (each call fed the previous one's
    outputs, as a frame loop feeds them), one event pair around the whole
    chain, after a sleep kernel as in `time_ms`."""
    for _ in range(warm):
        state = step(state)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        state = step(state)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def l2_flush(device, mb: int = 96):
    """A callable that leaves the card's L2 (50 MB on an H100) cold for
    the next kernel: it writes `mb` MB, then reads another `mb` MB, so
    the cache holds only clean lines of a buffer no kernel uses."""
    w = torch.empty(mb << 18, dtype=torch.float32, device=device)
    r = torch.zeros_like(w)
    out = torch.empty((), dtype=torch.float32, device=device)

    def flush():
        w.fill_(1.0)
        torch.sum(r, dim=0, out=out)
    return flush
