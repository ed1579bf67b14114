"""The port's tracer (`utils/trace.py`) on the CPU.

A small flagship engine (120 words, a 2 x 128 matched-filter DNN, the
device A* with its retry net, as tests/test_torch_engine.py builds it
from the port's own synth builders) decodes three utterances.  Off, the
tracer records nothing and `span` hands out one shared object.  On, a
decode gives exactly the documented tree (`trace.PARENT`): every child
inside its parent, one call id a call; under `torch.profiler` each
record is one `julius.<name>` range with the same nesting and about the
same duration; threads keep their own stacks; and the results are the
same bit for bit with the tracer on or off.  The A*'s graph path, run
on the CPU with a stand-in capture, records its capture and one
`astar.wait` a host read of the stop flag.  Pass 1 counts its frames
and the frames that copied their state back: none of `pass1_batch`'s,
eager or graphed, and every row of a stream chunk.
"""

import contextlib
import dataclasses
import gc
import threading
import types
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.tools import synth as tsynth
from julius_tpu_torch.utils import trace

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
N_UTTS = 3


@pytest.fixture(scope="module")
def decoding():
    """(engine, features, frame counts) of three 2-5 word utterances."""
    eng, protos = tsynth.flagship_engine(trained=True, device="cpu", **SIZE)
    eng.search_cfg = dataclasses.replace(eng.search_cfg, pass2_rescan=True)
    assert eng._device_astar_ok()
    _, wins, lens = tsynth.make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, N_UTTS, 120, 11,
        min_words=2, max_words=5, seed=1)
    feats = np.zeros((N_UTTS, max(lens), 120 * 11), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, feats, np.asarray(lens, np.int32)


@pytest.fixture
def tracer():
    """The tracer on, emptied before and after."""
    trace.drain()
    trace.enable(True)
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.drain()


def results(res):
    return [(r.word_ids, r.score, r.am_score, r.lm_score, r.from_pass,
             r.valid) for r in res]


def children(records):
    """{parent id: [child records by start]}."""
    kids = defaultdict(list)
    for r in sorted(records, key=lambda r: r.start_ns):
        kids[r.parent].append(r)
    return kids


def expected_children(name, stats, entry="decode_features"):
    """The documented children of span `name` in one decode of the
    fixture's batch, by name and in order (`stats`: LAST_STATS)."""
    head = ["features.h2d", "dnn"] if entry == "decode_features" else []
    return {
        "decode": head + ["pass1", "pass1.readback", "astar"],
        "astar": ["astar.setup", "astar.rounds", "astar.collect",
                  "astar.retry"],
        "astar.setup": ["astar.prepare"],
        "astar.prepare": ["prepare.suffix"] * (N_UTTS + 2)
        + ["prepare.prune"] * N_UTTS + ["prepare.seed"],
        "astar.rounds": ["astar.capture"] * stats["captured"]
        + ["astar.wait"] * stats["waits"],
    }.get(name, [])


def assert_call_tree(records, root, stats, entry="decode_features"):
    """The records under `root` form the documented tree: parents as
    trace.PARENT names them, children in the documented order, each
    inside its parent, all of one call id."""
    kids = children(records)
    todo = [root]
    seen = 0
    while todo:
        r = todo.pop()
        seen += 1
        assert r.call == root.id
        assert r.start_ns <= r.end_ns
        got = kids.get(r.id, [])
        assert [c.name for c in got] == expected_children(r.name, stats,
                                                          entry), r.name
        for c in got:
            assert trace.PARENT[c.name] == r.name
            assert r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns
        todo.extend(got)
    return seen


def test_off_records_nothing_and_shares_one_object(decoding):
    eng, feats, lens = decoding
    trace.enable(False)
    trace.drain()
    a, b = trace.span("decode"), trace.span("astar.wait")
    assert a is b
    assert not isinstance(a, trace._Span)
    with a:
        with b:
            pass
    eng.decode_features(feats, lens)
    assert trace.drain() == [] and trace.dropped() == 0


def test_one_decode_gives_the_documented_tree(decoding, tracer):
    eng, feats, lens = decoding
    eng.decode_features(feats, lens)
    stats = dict(tp2d.LAST_STATS)
    records = tracer.drain()
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ["decode"]
    assert assert_call_tree(records, roots[0], stats) == len(records)
    # the fixture's monophones have no pseudo phone sets to aggregate
    assert set(r.name for r in records) == set(trace.PARENT) - {
        "astar.capture", "dnn.pseudo"}
    assert stats["waits"] == stats["rounds"] + 1     # the eager loop


def test_decode_outprob_opens_its_own_call(decoding, tracer):
    eng, feats, lens = decoding
    rows = eng._outprob(torch.from_numpy(feats))
    tracer.drain()
    eng.decode_outprob(rows, lens)
    stats = dict(tp2d.LAST_STATS)
    records = tracer.drain()
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ["decode"]
    assert assert_call_tree(records, roots[0], stats,
                            entry="decode_outprob") == len(records)


def test_two_calls_have_two_call_ids(decoding, tracer):
    eng, feats, lens = decoding
    eng.decode_features(feats, lens)
    eng.decode_features(feats[:1], lens[:1])
    records = tracer.drain()
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ["decode", "decode"]
    assert roots[0].call != roots[1].call
    calls = Counter(r.call for r in records)
    assert set(calls) == {roots[0].call, roots[1].call}
    # the second call's batch holds one utterance: 2 best-path curves
    # and 2 prunes fewer, the suffix DP's start and read-back the same
    n = {c: Counter(r.name for r in records if r.call == c) for c in calls}
    first, second = n[roots[0].call], n[roots[1].call]
    assert first["prepare.suffix"] == N_UTTS + 2
    assert second["prepare.suffix"] == 3
    assert (first["prepare.prune"], second["prepare.prune"]) == (N_UTTS, 1)


def test_results_are_the_same_with_the_tracer_on(decoding):
    eng, feats, lens = decoding
    trace.enable(False)
    off = results(eng.decode_features(feats, lens))
    trace.enable(True)
    try:
        on = results(eng.decode_features(feats, lens))
    finally:
        trace.enable(False)
        trace.drain()
    assert on == off
    assert all(r[4] == 2 for r in on)


def test_profiler_ranges_match_the_records(decoding, tracer):
    """Each record is one `julius.<name>` range of the profile, nested
    as the records are, its duration within 50 us + 5% of the record's."""
    eng, feats, lens = decoding
    eng.decode_features(feats, lens)
    tracer.drain()
    acts = [torch.profiler.ProfilerActivity.CPU]
    # a collection inside a range's enter or exit would charge one side
    # with its pause
    gc.disable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            eng.decode_features(feats, lens)
    finally:
        gc.enable()
    records = tracer.drain()
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            ranges[e.name()[len(trace.PREFIX):]].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    by_name = defaultdict(list)
    for r in records:
        by_name[r.name].append(r)
    assert {k: len(v) for k, v in ranges.items()} == \
        {k: len(v) for k, v in by_name.items()}
    where = {}
    for name, recs in by_name.items():
        recs.sort(key=lambda r: r.start_ns)
        for r, (s, e) in zip(recs, sorted(ranges[name])):
            where[r.id] = (s, e)
            dur = r.end_ns - r.start_ns
            assert abs((e - s) - dur) <= 50_000 + 0.05 * dur, name
    for r in records:
        if r.parent:
            s, e = where[r.id]
            ps, pe = where[r.parent]
            assert ps <= s <= e <= pe, r.name


def test_threads_keep_their_own_stacks(tracer):
    """Two threads open spans in turns: each span's parent is the span
    its own thread has open."""
    steps = [threading.Event() for _ in range(4)]

    def worker(me, other):
        with trace.span("decode"):
            steps[me].set()
            assert steps[other].wait(10)
            with trace.span("dnn"):
                steps[me + 2].set()
                assert steps[other + 2].wait(10)

    threads = [threading.Thread(target=worker, args=(0, 1)),
               threading.Thread(target=worker, args=(1, 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    records = tracer.drain()
    roots = {r.id: r for r in records if r.name == "decode"}
    dnn = [r for r in records if r.name == "dnn"]
    assert len(roots) == 2 and len(dnn) == 2
    assert sorted(r.parent for r in dnn) == sorted(roots)
    assert all(r.call == r.parent for r in dnn)
    # each child opened while both threads had their root open
    assert min(d.start_ns for d in dnn) > max(r.start_ns
                                              for r in roots.values())


def test_two_threads_decoding_at_once(decoding, tracer):
    eng, feats, lens = decoding
    want = results(eng.decode_features(feats, lens))
    tracer.drain()
    start = threading.Barrier(2)
    got = [None, None]
    stats = [None, None]

    def worker(i):
        start.wait(10)
        got[i] = results(eng.decode_features(feats, lens))
        stats[i] = dict(tp2d.LAST_STATS)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert got == [want, want]
    records = tracer.drain()
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ["decode", "decode"]
    # the decodes overlapped, and each call is its own whole tree
    assert max(r.start_ns for r in roots) < min(r.end_ns for r in roots)
    assert sum(assert_call_tree(records, r, stats[0]) for r in roots) \
        == len(records)


def test_totals_and_the_cap(tracer, monkeypatch):
    R = trace.Record
    recs = [R("pass1.readback", 12, 15, 3, 1, 1),
            R("astar", 15, 20, 4, 1, 1),
            R("decode", 10, 30, 1, 0, 1),
            R("decode", 40, 50, 5, 0, 5)]
    t = trace.totals(recs)
    assert t["decode"] == pytest.approx((2, 30e-9, 22e-9), abs=1e-15)
    assert t["astar"] == pytest.approx((1, 5e-9, 5e-9), abs=1e-15)
    monkeypatch.setattr(trace, "CAP", 3)
    for _ in range(5):
        with trace.span("decode"):
            pass
    assert trace.dropped() == 2
    assert len(tracer.drain()) == 3
    assert trace.dropped() == 0


@pytest.fixture
def graph_path(monkeypatch):
    """The device A* on the CPU through `_graphed`, its capture a
    stand-in that runs the step once (the eager round 1) and replays it
    by running it again, and the stop flag read from the CPU tensor."""
    def capture(cache, device, step):
        step()
        return [types.SimpleNamespace(replay=step)]

    monkeypatch.setattr(tp2d, "_eager", tp2d._graphed)
    monkeypatch.setattr(tp2d, "_capture", capture)
    monkeypatch.setattr(tp2d, "_host_flag", lambda flag: bool(flag))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())


def test_graph_path_records_its_capture_and_waits(decoding, graph_path,
                                                  tracer):
    """A first batch captures its round (one `astar.capture` before the
    waits), the same batch again replays it (none); one `astar.wait` a
    host read of the stop flag."""
    eng, feats, lens = decoding
    eng.device_chains.graphs.entries.clear()
    for captured in (1, 0):
        eng.decode_features(feats, lens)
        stats = dict(tp2d.LAST_STATS)
        assert stats["graphed"] and stats["captured"] == captured
        records = tracer.drain()
        root, = [r for r in records if r.parent == 0]
        assert assert_call_tree(records, root, stats) == len(records)
        n = Counter(r.name for r in records)
        assert n["astar.capture"] == captured
        assert n["astar.wait"] == stats["waits"] >= 1


def pass1_inputs(eng, feats, lens):
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats))
    return out, torch.as_tensor(lens)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_pass1_counts_frames_and_no_state_copies(decoding, tracer,
                                                 monkeypatch, graphed):
    """pass1_batch counts its T frames, and no state copy, in the eager
    loop and through `_graphed` (a stand-in capture, whose eager runs
    of the two steps are no frames of the batch), a batch again through
    the same entry likewise."""
    eng, feats, lens = decoding
    out, n = pass1_inputs(eng, feats, lens)

    def capture(cache, device, *steps):
        for step in steps:
            step()
        return [types.SimpleNamespace(replay=step) for step in steps]

    if graphed:
        monkeypatch.setattr(tp1, "_eager", tp1._graphed)
        monkeypatch.setattr(tp1, "_capture", capture)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        eng.dev_net.graphs.entries.clear()
    trace.drain_counts()
    for _ in range(2):
        tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg, out, n)
        assert trace.drain_counts() == {"pass1.frames": out.shape[1],
                                        "pass1.state_copies": 0}
    assert len(eng.dev_net.graphs.entries) == int(graphed)
    eng.dev_net.graphs.entries.clear()


def test_stream_chunk_counts_its_state_copies(decoding, tracer):
    """A stream chunk counts each of its rows as a frame and as a state
    copy, its padding rows past n_valid too."""
    eng, feats, lens = decoding
    out, _ = pass1_inputs(eng, feats, lens)
    state = tp1.pass1_stream_start(eng.dev_net, eng.p1_cfg, out[:1, 0])
    trace.drain_counts()
    tp1.pass1_stream_chunk(eng.dev_net, eng.ngram_dev, eng.p1_cfg, state,
                           out[0, 1:9], 6)
    assert trace.drain_counts() == {"pass1.frames": 8,
                                    "pass1.state_copies": 8}


def test_pass1_counts_nothing_with_the_tracer_off(decoding):
    eng, feats, lens = decoding
    trace.enable(False)
    trace.drain_counts()
    out, n = pass1_inputs(eng, feats, lens)
    tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg, out, n)
    state = tp1.pass1_stream_start(eng.dev_net, eng.p1_cfg, out[:1, 0])
    tp1.pass1_stream_chunk(eng.dev_net, eng.ngram_dev, eng.p1_cfg, state,
                           out[0, 1:9], 8)
    eng.decode_features(feats, lens)
    assert trace.drain_counts() == {}
