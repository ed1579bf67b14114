"""Spans around the program's layer calls, and the reading of a traced
window's device activity.

`Spans` wraps five calls of one `Engine` from the benchmark's side:
`decode_features` (the whole decode), `_outprob` (DNN scoring),
`_pass1` (pass 1), `_device_astar` (pass 2 on the device, with its
retry net) and the module function `search.pass2_device.prepare` (the
A*'s host preparation).  In a traced run each call is a
`torch.profiler.record_function` range, synchronised with the card at
both ends, and its host seconds are summed by name; untraced, a wrapper
only hands each call's result to the `keep` hooks.

`device_activity` reads the profiler's events of the window: every
kernel, copy and set on the card, the busy time (their union), each
span's device time (the activity launched inside it, its innermost
span by the launch's host time), the device operations that took most
time, and the idle time split by the span the host was in.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

PREFIX = "asrbench."
#: span names, outermost first
SPANS = ("decode", "dnn", "pass1", "astar", "prepare")


class Spans:
    """The benchmark's spans on one engine (see the module docstring)."""

    def __init__(self, eng, traced: bool):
        from julius_tpu_torch.search import pass2_device as p2d
        self.traced = traced
        self.host_s: Dict[str, float] = defaultdict(float)
        self.keep: Dict[str, Optional[Callable]] = {n: None for n in SPANS}
        self._eng, self._p2d = eng, p2d
        self._sync = (torch.cuda.synchronize if eng.device.type == "cuda"
                      else lambda: None)
        self._prepare = p2d.prepare
        for name, attr in (("decode", "decode_features"), ("dnn", "_outprob"),
                           ("pass1", "_pass1"), ("astar", "_device_astar")):
            setattr(eng, attr, self._wrap(name, getattr(eng, attr)))
        p2d.prepare = self._wrap("prepare", self._prepare)

    def close(self) -> None:
        """Put the module function back (the engine goes with its
        wrappers)."""
        self._p2d.prepare = self._prepare

    def _wrap(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            if not self.traced:
                out = fn(*args, **kwargs)
            else:
                self._sync()
                t0 = time.perf_counter()
                with torch.profiler.record_function(PREFIX + name):
                    out = fn(*args, **kwargs)
                    self._sync()
                self.host_s[name] += time.perf_counter() - t0
            hook = self.keep[name]
            if hook is not None:
                hook(out)
            return out
        return call


def _innermost(ts: np.ndarray, spans) -> np.ndarray:
    """Index into `spans` ((start, end, name)) of the innermost span
    holding each time, -1 for none.  Spans of one name never overlap,
    and a name later in SPANS is never outside an earlier one that
    overlaps it, so later names override earlier ones."""
    out = np.full(len(ts), -1, np.int64)
    by_depth = defaultdict(list)
    for i, (s, e, name) in enumerate(spans):
        by_depth[SPANS.index(name) if name in SPANS else 0].append((s, e, i))
    for depth in sorted(by_depth):
        lst = sorted(by_depth[depth])
        starts = np.asarray([x[0] for x in lst], np.int64)
        ends = np.asarray([x[1] for x in lst], np.int64)
        ids = np.asarray([x[2] for x in lst], np.int64)
        k = np.searchsorted(starts, ts, side="right") - 1
        ok = (k >= 0) & (ts < ends[np.maximum(k, 0)])
        out[ok] = ids[k[ok]]
    return out


def device_activity(prof) -> dict:
    """Device busy seconds, window seconds, device seconds by span, and
    the breakdown of one profiled window."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    launch_ts: Dict[int, int] = {}
    spans = []
    dev = []
    for e in events:
        if e.device_type() == cuda:
            if e.name().startswith(PREFIX) or e.is_user_annotation():
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id(), e.name()))
            continue
        name = e.name()
        if name.startswith(PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(PREFIX):]))
        elif name.startswith("cu"):
            launch_ts[e.correlation_id()] = e.start_ns()
    if not dev:
        return dict(busy_s=0.0, window_s=0.0, span_device_s={},
                    device_ops=[], idle_gaps=[])
    start = np.asarray([d[0] for d in dev], np.int64)
    end = np.asarray([d[1] for d in dev], np.int64)
    lo, hi = int(start.min()), int(end.max())
    window_s = (hi - lo) * 1e-9
    order = np.argsort(start, kind="stable")
    s_sorted, e_sorted = start[order], end[order]
    reach = np.maximum.accumulate(e_sorted)
    gap_lo = reach[:-1]
    gap_hi = s_sorted[1:]
    is_gap = gap_hi > gap_lo
    busy = float((reach[-1] - s_sorted[0])
                 - np.sum((gap_hi - gap_lo)[is_gap])) * 1e-9
    # each activity's span, by its launch's host time
    launch = np.asarray([launch_ts.get(d[2], d[0]) for d in dev], np.int64)
    which = _innermost(launch, spans)
    dur = (end - start) * 1e-9
    span_device_s: Dict[str, float] = defaultdict(float)
    for idx, d in zip(which.tolist(), dur.tolist()):
        if idx >= 0:
            span_device_s[spans[idx][2]] += d
    ops: Dict[str, float] = defaultdict(float)
    for d, t in zip(dev, dur.tolist()):
        ops[d[3][:160]] += t
    # idle time inside the window, split by the innermost span the host
    # was in at each moment of it
    g_lo = np.concatenate([[lo], gap_lo[is_gap], [reach[-1]]])
    g_hi = np.concatenate([[s_sorted[0]], gap_hi[is_gap], [hi]])
    keep = g_hi > g_lo
    g_lo, g_hi = g_lo[keep], g_hi[keep]
    marks = [g_lo, g_hi]
    if spans:
        sp = np.asarray([(a, b) for a, b, _ in spans], np.int64)
        marks.append(np.clip(sp.ravel(), lo, hi))
    pts = np.unique(np.concatenate(marks))
    mids = (pts[:-1] + pts[1:]) // 2
    lens = np.diff(pts)
    k = np.searchsorted(g_lo, mids, side="right") - 1
    idle_at = (k >= 0) & (mids < g_hi[np.maximum(k, 0)])
    owner = _innermost(mids[idle_at], spans)
    idle: Dict[str, float] = defaultdict(float)
    for idx, n in zip(owner.tolist(), lens[idle_at].tolist()):
        idle[spans[idx][2] if idx >= 0 else "outside"] += n * 1e-9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=window_s,
                span_device_s=dict(span_device_s),
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in gaps])
