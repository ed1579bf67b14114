"""The program's own spans in a traced window: the reading that the
benchmark's per-layer metrics of the port's spans need.

The port records host spans at its layer boundaries
(`julius_tpu_torch/utils/trace.py`, off unless switched on) and, while
a `torch.profiler` records, opens each as a `julius.<name>` range in
the profile, in the same event stream and on the same clock as the
kernels.  Two readings:

* `per_audio_second(self_s, audio_s)`: the host milliseconds per second
  of audio of the spans the metrics in `METRICS` read, from each span
  name's self seconds (the tracer's `totals`, handed over by
  `asrbench/program.py`, the benchmark's one importer of the port);
* `program_activity(prof)`: the card's idle seconds inside the
  `astar.rounds` ranges with those ranges' length, and the window's
  idle seconds by the innermost program range the host was in.

Neither changes what `asrbench/trace.py` `device_activity` reads: the
`julius.` ranges are not `asrbench.` spans, and their device-side
user annotations are not device activity.  The harness does not call
this module yet (see PERF.md, Open questions).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "julius."
#: per-layer metric -> the span whose self time it reads, in host ms
#: per second of audio
METRICS = {
    "features_h2d_ms_per_s": "features.h2d",
    "trellis_readback_ms_per_s": "pass1.readback",
    "prepare_suffix_ms_per_s": "prepare.suffix",
    "prepare_prune_ms_per_s": "prepare.prune",
    "prepare_seed_ms_per_s": "prepare.seed",
    "astar_wait_ms_per_s": "astar.wait",
    "astar_retry_ms_per_s": "astar.retry",
}
#: the span whose device idle share `astar_rounds_idle_pct` reads
ROUNDS = "astar.rounds"


def per_audio_second(self_s: Dict[str, float],
                     audio_s: float) -> Dict[str, float]:
    """{metric: host ms per audio second} of METRICS' spans that ran;
    none where no audio was decoded."""
    if audio_s <= 0:
        return {}
    return {m: 1e3 * self_s[span] / audio_s for m, span in METRICS.items()
            if span in self_s}


def rounds_idle_pct(activity: dict) -> Optional[float]:
    """The card's idle share of the `astar.rounds` ranges, in %; None
    where the window has no such range or no device activity."""
    if activity.get("rounds_s", 0.0) <= 0 or not activity.get("busy"):
        return None
    return 100.0 * activity["rounds_idle_s"] / activity["rounds_s"]


def _events(prof):
    """(device activity [(start, end)], program ranges [(start, end,
    name)]) of a profile, in ns."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(("asrbench.", PREFIX)) \
                    or e.is_user_annotation():
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name[len(PREFIX):]))
    return dev, ranges


def _busy(dev) -> np.ndarray:
    """[n, 2] disjoint busy intervals, in order: the union of `dev`."""
    if not dev:
        return np.zeros((0, 2), np.int64)
    a = np.asarray(sorted(dev), np.int64)
    reach = np.maximum.accumulate(a[:, 1])
    new = np.r_[True, a[1:, 0] > reach[:-1]]
    starts = a[new, 0]
    ends = np.r_[reach[:-1][new[1:]], reach[-1]]
    return np.stack([starts, ends], axis=1)


def _covered(busy: np.ndarray, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the busy intervals cover."""
    if hi <= lo or not len(busy):
        return 0
    s = np.clip(busy[:, 0], lo, hi)
    e = np.clip(busy[:, 1], lo, hi)
    return int(np.sum(e - s))


def _innermost(points: np.ndarray,
               ranges: List[Tuple[int, int, str]]) -> List[Optional[str]]:
    """The name of the innermost range holding each point (sorted), or
    None.  The ranges of one thread nest, so the open range that began
    last (the longer first where two begin together) is the innermost."""
    order = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[Optional[str]] = []
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for p in points.tolist():
        while j < len(order) and order[j][0] <= p:
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def program_activity(prof) -> dict:
    """Of one profiled window: `rounds_s`, the `astar.rounds` ranges'
    length, `rounds_idle_s`, the card's idle seconds inside them, and
    `idle_by_span`, the window's idle seconds by the innermost program
    range the host was in (the ten largest; "outside" for none)."""
    dev, ranges = _events(prof)
    busy = _busy(dev)
    rounds = [(s, e) for s, e, n in ranges if n == ROUNDS]
    rounds_ns = sum(e - s for s, e in rounds)
    rounds_idle = rounds_ns - sum(_covered(busy, s, e) for s, e in rounds)
    idle: Dict[str, float] = defaultdict(float)
    if len(busy) > 1:
        lo, hi = int(busy[0, 0]), int(busy[-1, 1])
        # the idle gaps of the window (first activity to last) cut at
        # every range's ends, each piece charged to its innermost range
        g_lo, g_hi = busy[:-1, 1], busy[1:, 0]
        marks = [g_lo, g_hi]
        if ranges:
            r = np.asarray([(s, e) for s, e, _ in ranges], np.int64)
            marks.append(np.clip(r.ravel(), lo, hi))
        pts = np.unique(np.concatenate(marks))
        mids = (pts[:-1] + pts[1:]) // 2
        k = np.searchsorted(g_lo, mids, side="right") - 1
        at = (k >= 0) & (mids < g_hi[np.maximum(k, 0)])
        lens = np.diff(pts)[at]
        for name, n in zip(_innermost(mids[at], ranges), lens.tolist()):
            idle[name or "outside"] += n * 1e-9
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy=bool(len(busy)), rounds_s=rounds_ns * 1e-9,
                rounds_idle_s=rounds_idle * 1e-9,
                idle_by_span=[[k, v] for k, v in top])
