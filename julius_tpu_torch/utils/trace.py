"""Host spans at the port's layer boundaries.

Off by default; `enable(True)` turns it on for the whole process.

Off, `span(name)` tests one module flag and returns one shared no-op
context manager: no allocation, no profiler call, no synchronisation.

On, each span records its name, start and end (`time.perf_counter_ns`),
its own id, its parent's id (0 for none) and its call id in memory, up
to CAP records (later spans are only counted, `dropped()`); `drain()`
hands the records over and clears them.  Open spans form a stack per
thread, so threads decoding at once never parent each other's spans.  A
span opened with no span open on its thread is a root and starts a new
call: `Engine.decode_features`, `decode_outprob` and `recognize_batch`
open the root `decode`, and every span under it carries its call id.
While a `torch.profiler` records on the span's thread, the span also
opens a user range `julius.<name>` (the range `torch.profiler.
record_function` opens, made directly: through the operator dispatcher
its enter and exit cost tens of microseconds a span under the
profiler), so that a profile holds each span as a range in the same
event stream, on the same clock, as the kernels its host code launched.

Spans never synchronise the card: they time what the host does, and a
profile gives the device time of what each one launched.

On, `count(name, n)` also adds n to a counter of `COUNTERS`, summed
over calls until `drain_counts()` hands them over and clears them; off
it records nothing.  The program's other counters (the graph caches'
`captures` and `capture_s`, `pass2_device.LAST_STATS`,
`Engine.last_pass2`) stay where they are.

The spans, each with its parent (`PARENT`):

* `decode`: a decode call (engine.py), the root;
* `features.h2d` [decode]: `decode_features`' copy of the features to
  the engine's device;
* `dnn` [decode]: `Engine._outprob`, the senone scores;
* `dnn.pseudo` [dnn]: `Engine._extend`'s aggregation of the senone
  scores into the pseudo phone sets' set-state columns (networks with
  pseudo sets only; under `decode` where `decode_outprob` extends rows
  it was handed);
* `pass1` [decode]: `Engine._pass1`;
* `pass1.readback` [decode]: `Engine._results`' copy of the trellis to
  the host, where the host waits for pass 1's replays;
* `astar` [decode]: `Engine._device_astar`, the device A* with its
  retry net;
* `astar.setup` [astar]: `pass2_device._setup`: `prepare`, the frames'
  best outprob read back and the inputs uploaded;
* `astar.prepare` [astar.setup]: `pass2_device.prepare`;
* `prepare.suffix` [astar.prepare]: an utterance's suffix estimate
  (`_suffix_estimate_np`, `_best_path_rest`); where the DP runs on the
  card, an utterance's `_best_path_rest`, and once a batch the kernel's
  launch and, after the atom tables, the wait for it and its read-back;
* `prepare.prune` [astar.prepare]: an utterance's candidate prune;
* `prepare.seed` [astar.prepare]: the padded tables, the frame-0 stacks
  and the packed candidate columns of the batch;
* `astar.rounds` [astar]: the rounds, from the graph cache's lookup to
  the last read of the stop flag (`_graphed`, `_eager`);
* `astar.capture` [astar.rounds]: the eager round 1 and the capture of
  a new round graph;
* `astar.wait` [astar.rounds]: one read of the stop flag on the host;
* `astar.collect` [astar]: the scores' read-back and `_collect`;
* `astar.retry` [astar]: the retry net's host re-scan and checks.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, NamedTuple

import torch

#: records kept between two drains; later spans are only counted
CAP = 1_000_000
#: prefix of a span's profiler range
PREFIX = "julius."
#: every span of the program and its parent (None: a root)
PARENT = {
    "decode": None,
    "features.h2d": "decode",
    "dnn": "decode",
    "dnn.pseudo": "dnn",
    "pass1": "decode",
    "pass1.readback": "decode",
    "astar": "decode",
    "astar.setup": "astar",
    "astar.prepare": "astar.setup",
    "prepare.suffix": "astar.prepare",
    "prepare.prune": "astar.prepare",
    "prepare.seed": "astar.prepare",
    "astar.rounds": "astar",
    "astar.capture": "astar.rounds",
    "astar.wait": "astar.rounds",
    "astar.collect": "astar",
    "astar.retry": "astar",
}

#: every counter of the program, and what it adds a call (the sizes
#: behind them are the engine's: Q' and L in `Engine._pseudo`, the
#: strict head classes in `pass2_device.LAST_STATS`)
COUNTERS = {
    "pseudo.rows": "dnn.pseudo: the frame rows aggregated",
    "pseudo.chunks": "dnn.pseudo: the row chunks that ran: the plain "
                     "version's (ops/gmm.py CHUNK_BYTES) on the CPU, the "
                     "kernel's launches on a card",
    "pseudo.kernel": "dnn.pseudo: launches of the pseudo kernel "
                     "(ops/pseudo_kernel.py)",
}


class Record(NamedTuple):
    """One finished span."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int         # the enclosing span's id, 0 for a root
    call: int           # the root's id


class Totals(NamedTuple):
    """Spans of one name: how many, their seconds, and their self
    seconds (each span's duration less the part its children cover)."""

    count: int
    total_s: float
    self_s: float


class _Stack(threading.local):
    """The open spans of the calling thread."""

    def __init__(self):
        self.open: List["_Span"] = []


_ON = False
_NULL = nullcontext()
_ids = itertools.count(1)
_lock = threading.Lock()
_records: List[Record] = []
_dropped = 0
_counts: Dict[str, int] = defaultdict(int)
_stack = _Stack()


def enable(on: bool) -> None:
    """Turn the tracer on or off; spans already open still record."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def span(name: str):
    """A context manager timing its block as span `name` (PARENT)."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add n to counter `name` (COUNTERS) while the tracer is on."""
    if not _ON:
        return
    with _lock:
        _counts[name] += int(n)


def drain_counts() -> Dict[str, int]:
    """The counters since the last `drain_counts`; clears them."""
    global _counts
    with _lock:
        out, _counts = dict(_counts), defaultdict(int)
    return out


def drain() -> List[Record]:
    """The records since the last drain, in the order the spans ended;
    clears them and the dropped count."""
    global _records, _dropped
    with _lock:
        out, _records, _dropped = _records, [], 0
    return out


def dropped() -> int:
    """Spans ended since the last drain that found CAP records kept."""
    return _dropped


def totals(records: List[Record]) -> Dict[str, Totals]:
    """Count, seconds and self seconds of `records` by span name.  A
    span's children ran on its thread one after another, so its self
    time is its duration less theirs."""
    child_ns: Dict[int, int] = defaultdict(int)
    for r in records:
        if r.parent:
            child_ns[r.parent] += r.end_ns - r.start_ns
    acc: Dict[str, List[float]] = {}
    for r in records:
        a = acc.setdefault(r.name, [0, 0, 0])
        a[0] += 1
        a[1] += r.end_ns - r.start_ns
        a[2] += r.end_ns - r.start_ns - child_ns.get(r.id, 0)
    return {k: Totals(n, t * 1e-9, s * 1e-9) for k, (n, t, s) in acc.items()}


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack.open
        self.id = next(_ids)
        if st:
            self.parent, self.call = st[-1].id, st[-1].call
        else:
            self.parent, self.call = 0, self.id
        st.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack.open.pop()
        global _dropped
        with _lock:
            if len(_records) < CAP:
                _records.append(Record(self.name, self.start, end, self.id,
                                       self.parent, self.call))
            else:
                _dropped += 1
        return False
