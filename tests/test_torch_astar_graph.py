"""Port vs reference: the device A* built on its gated round.

The port runs the device A* as one round step (`search/pass2_device.py`
`_Rounds.step`) over fixed tensors, gated on the device by the
reference's loop condition (some utterance active, fewer than
max_rounds run), so that a CUDA card can capture the round once as a
graph and replay it, reading the stop flag once every STOP_EVERY
replays, as the reference's jitted `lax.while_loop` runs its body.  On
the CPU the same step runs once a round from Python (`_eager`).  Here,
on the pass-2 fixtures of tests/test_torch_pass2_device.py (the small
flagship's "short" and "long" batches, N-best 1 and 3) and one
strict-heads case at tests/test_torch_lvcsr.py's size, both packages
search the same lattices with the same outprob cache, and:

  * (a) the gated step run `rounds + k` times (k = 0..3), and up to
    max_rounds + 2 times on a configuration whose -m budget makes
    max_rounds 32 (one batch ends before it, one at it), leaves every
    array of the search bit-equal to the eager loop's, and its N-best
    lists equal the reference's run_batch (ids, bounds, rounds and pops
    equal, scores within atol 1e-4);
  * (b) `_graphed`'s own bookkeeping, with the capture replaced by a
    stand-in whose replay runs the step, for STOP_EVERY = 1, 2, 7 and
    one larger than the rounds: results bit-equal to the eager loop, at
    most ceil(rounds / G) + 1 host waits and G - 1 rounds past the end,
    on a first batch (captured) and on a second one (replayed);
  * (c) a batch of another NA takes a new entry, and the cache keeps at
    most GRAPHS_KEPT entries, dropping the oldest one's tensors;
  * (d) run_batch on the CPU never reaches torch.cuda's graphs.
"""

import contextlib
import dataclasses
import gc
import math
import types
import weakref

import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search import pass2 as jp2
from julius_tpu.search import pass2_device as jp2d
from julius_tpu.tools.synth import (flagship_engine, lvcsr_engine,
                                    make_lvcsr_utts)
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d

from test_torch_pass2_device import (SIZE, assert_same_nbest,
                                     converted_engine, reference_batch,
                                     reference_outputs)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

LVCSR_SIZE = dict(n_words=400, hidden=256, n_layers=2)

#: case -> (batch, search overrides); the two "cap" cases set -m so that
#: max_rounds is 32: short-1 ends before it, long-3 at it
CASES = {"short-1": ("short", dict(nbest=1)),
         "short-3": ("short", dict(nbest=3)),
         "long-1": ("long", dict(nbest=1)),
         "strict-1": ("strict", dict(nbest=1)),
         "short-1-cap": ("short", dict(nbest=1, max_hypo_pop=100)),
         "long-3-cap": ("long", dict(nbest=3, max_hypo_pop=100))}
STEPPED = ("short-1", "short-3", "long-1", "strict-1", "long-3-cap")

#: the arrays of the search, besides the stack
STATE = ("g_store", "beg_store", "arena_w", "arena_t", "arena_parent",
         "arena_lm_sum", "res_score", "res_arena", "res_seqh", "n_pops",
         "active", "env_cnt", "env_seen", "round_i", "more")


@pytest.fixture(scope="module")
def flagship():
    eng, protos = flagship_engine(trained=True, **SIZE)
    return eng, {"short": reference_batch(eng, protos, 3, 2, 5, seed=1),
                 "long": reference_batch(eng, protos, 4, 6, 12, seed=2)}


@pytest.fixture(scope="module")
def strict():
    eng, protos = lvcsr_engine(**LVCSR_SIZE)
    truths, wins, lens = make_lvcsr_utts(eng, protos, 4, 120, 11,
                                         min_words=3, max_words=6, seed=11)
    return eng, {"strict": (truths,) + reference_outputs(eng, wins, lens)}


#: the eager loop as the module defines it (the graph tests replace it)
EAGER = tp2d._eager


class Case:
    """One case's inputs to both packages, the reference's N-best lists
    and statistics, and the port's engine and lattices."""

    def __init__(self, eng, batch, search):
        _, _, lens, self.out_ext, trs = batch
        cfg = dataclasses.replace(eng.search_cfg, **search)
        self.strict = cfg.strict_iwcd2
        self.want = jp2d.run_batch(
            [jp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
            eng.device_chains, eng.ngram_dev, eng._wid2lm_p2,
            eng._cprob_arr(), jnp.asarray(self.out_ext),
            eng._rescan_strategy(), cfg,
            iwcd2=eng.iwcd2_tables if self.strict else None)
        self.want_stats = dict(jp2d.LAST_STATS)
        self.teng = converted_engine(eng, **search)
        self.lats = [tp2.TrellisLattice(tr, int(n))
                     for tr, n in zip(trs, lens)]
        self._eager = None

    def args(self, tabs=None):
        """run_batch's arguments on the port's side (its chain tables
        replaced by `tabs` where given)."""
        t = self.teng
        return (self.lats, tabs or t.device_chains, t.ngram_dev, t._wid2lm,
                t._cprob_arr(), torch.from_numpy(self.out_ext),
                t._rescan_strategy(), t.search_cfg)

    def kw(self):
        return dict(iwcd2=self.teng.iwcd2_tables if self.strict else None)

    def rounds_of(self):
        """(dims, inputs, tables, N-gram, strict heads) of `_Rounds`."""
        a = self.args()
        d, x = tp2d._setup(a[0], a[1], a[3], a[4], a[5], a[6], a[7], None)
        return d, x, a[1], a[2], self.kw()["iwcd2"]

    def eager(self):
        """The eager loop's (N-best lists, rounds, pops)."""
        if self._eager is None:
            d, x, tabs, ng, iwcd2 = self.rounds_of()
            with EAGER(tabs, ng, iwcd2, d, x) as (r, info):
                assert info["replayed"] == int(r.round_i)
                self._eager = (collect(r, self), int(r.round_i),
                               r.n_pops.tolist())
        return self._eager


@pytest.fixture(scope="module")
def cases(request):
    """case name -> Case, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            batch, search = CASES[name]
            eng, batches = request.getfixturevalue(
                "strict" if batch == "strict" else "flagship")
            built[name] = Case(eng, batches[batch], search)
        return built[name]
    return get


def state_of(r):
    return {**{f: getattr(r, f) for f in STATE},
            **{f"stack{i}": a for i, a in enumerate(r.stack)}}


def collect(r, case):
    return tp2d._collect(r, r.res_score.numpy(), case.lats,
                         case.teng.search_cfg)


def assert_reference(case, got, rounds, n_pops):
    """The reference's N-best lists, rounds and pops."""
    assert_same_nbest(got, case.want)
    assert all(got)
    assert rounds == case.want_stats["rounds"]
    assert n_pops == case.want_stats["n_pops"]


@pytest.fixture(scope="module")
def stepped(cases):
    """case name -> {extra steps: (fields that differ from the eager
    loop, N-best lists, rounds, pops)}, the gated step run past the
    eager loop's end: 0..3 rounds, and to max_rounds + 2 on the cap
    cases.  One pass a case; the eager loop's state is dropped after."""
    out = {}

    def get(name):
        if name not in out:
            case = cases(name)
            d, x, tabs, ng, iwcd2 = case.rounds_of()
            with EAGER(tabs, ng, iwcd2, d, x) as (eager, info):
                pass
            rounds = int(eager.round_i)
            assert info["replayed"] == rounds
            want = state_of(eager)
            steps = {k: rounds + k for k in range(4)}
            if "cap" in name:
                steps["max"] = d.max_rounds + 2
            r = tp2d._Rounds(tabs, ng, iwcd2, d, x)
            r.load(x)
            res, n = {}, 0
            for k, n_steps in sorted(steps.items(), key=lambda kv: kv[1]):
                while n < n_steps:
                    r.step()
                    n += 1
                got = state_of(r)
                differ = [f for f in want if not (
                    got[f].dtype == want[f].dtype
                    and torch.equal(got[f], want[f]))]
                res[k] = (differ, collect(r, case), int(r.round_i),
                          r.n_pops.tolist())
            out[name] = res
        return out[name]
    return get


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("name", STEPPED)
def test_gated_step_past_the_end_is_exact(stepped, cases, name, extra):
    differ, got, rounds, n_pops = stepped(name)[extra]
    assert not differ
    assert_reference(cases(name), got, rounds, n_pops)


@pytest.mark.parametrize("name", ["short-1-cap", "long-3-cap"])
def test_gated_step_to_max_rounds_is_exact(stepped, cases, name):
    """Replays up to max_rounds + 2: a batch that ends before the cap
    (20 gated rounds after it) and one that reaches it (its gated rounds
    clamp their arena slots onto the last round's)."""
    case = cases(name)
    differ, got, rounds, n_pops = stepped(name)["max"]
    assert not differ
    assert_reference(case, got, rounds, n_pops)
    assert (rounds == case.want_stats["max_rounds"]) == (name == "long-3-cap")


@pytest.fixture
def graph_path(monkeypatch):
    """run_batch on the CPU through `_graphed`, its capture a stand-in
    that runs the step once (the eager round 1) and replays it by
    running it again, and the stop flag read from the CPU tensor; ->
    the lists of captures made and of host waits."""
    seen = types.SimpleNamespace(captures=[], waits=[])

    def capture(cache, device, step):
        seen.captures.append(device)
        step()
        return [types.SimpleNamespace(replay=step)]

    monkeypatch.setattr(tp2d, "_eager", tp2d._graphed)
    monkeypatch.setattr(tp2d, "_capture", capture)
    monkeypatch.setattr(tp2d, "_host_flag",
                        lambda flag: seen.waits.append(1) or bool(flag))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return seen


@pytest.mark.parametrize("every", [1, 2, 7, "more"])
@pytest.mark.parametrize("name", ["short-1", "strict-1"])
def test_graphed_bookkeeping(cases, graph_path, monkeypatch, name, every):
    case = cases(name)
    want, rounds, n_pops = case.eager()
    G = rounds + 5 if every == "more" else every
    monkeypatch.setattr(tp2d, "STOP_EVERY", G)
    tabs = case.teng.device_chains
    tabs.graphs.entries.clear()
    for first in (True, False):           # captured, then replayed
        graph_path.waits.clear()
        got = tp2d.run_batch(*case.args(), **case.kw())
        stats = dict(tp2d.LAST_STATS)
        assert [[dataclasses.astuple(r) for r in x] for x in got] == \
            [[dataclasses.astuple(r) for r in x] for x in want]
        assert stats["graphed"] and stats["stop_every"] == G
        assert stats["captured"] == int(first)
        assert len(graph_path.captures) == 1
        assert stats["rounds"] == rounds and stats["n_pops"] == n_pops
        assert stats["waits"] == len(graph_path.waits) \
            <= math.ceil(rounds / G) + 1
        # the rounds the card ran: the capture's eager round 1, then
        # whole groups of G replays
        ran = 1 + G * math.ceil((rounds - 1) / G) if first \
            else G * math.ceil(rounds / G)
        assert stats["replayed"] == ran
        assert 0 <= stats["replayed"] - rounds <= G - 1
    assert len(tabs.graphs.entries) == 1
    assert_reference(case, got, rounds, n_pops)


def test_the_cache_is_bounded(cases, graph_path):
    """Batches of four keys (two NA and T, N-best 1 and 3, two -m) on one
    set of chain tables, then the first again: at most GRAPHS_KEPT
    entries, the oldest dropped with its tensors, the first batch
    captured anew, each result the eager loop's."""
    names = ["short-1", "long-1", "short-3", "long-3-cap", "short-1"]
    tabs = cases("short-1").teng.device_chains   # the cases' are equal
    tabs.graphs.entries.clear()
    kept = []
    for i, name in enumerate(names):
        case = cases(name)
        got = tp2d.run_batch(*case.args(tabs), **case.kw())
        stats = dict(tp2d.LAST_STATS)
        assert stats["captured"] == 1
        assert len(graph_path.captures) == i + 1
        entries = tabs.graphs.entries
        assert len(entries) == min(i + 1, tp2d.GRAPHS_KEPT)
        key, entry = list(entries.items())[-1]
        assert key[1].NA == stats["NA"]
        kept.append(weakref.ref(entry.rounds))
        assert [[dataclasses.astuple(r) for r in x] for x in got] == \
            [[dataclasses.astuple(r) for r in x] for x in case.eager()[0]]
    gc.collect()
    # the first entry went at the fourth batch, the second at the fifth
    assert [k() is None for k in kept] == [True, True, False, False, False]


def test_another_na_takes_a_new_entry(cases, graph_path):
    short, long = cases("short-1"), cases("long-1")
    tabs = short.teng.device_chains
    tabs.graphs.entries.clear()
    for case in (short, long, short):
        tp2d.run_batch(*case.args(tabs), **case.kw())
    keys = list(tabs.graphs.entries)
    assert len(graph_path.captures) == 2 and len(keys) == 2
    assert keys[0][1].NA != keys[1][1].NA


@pytest.mark.parametrize("name", ["short-1", "strict-1"])
def test_cpu_never_reaches_cuda_graphs(cases, monkeypatch, name):
    def refuse(*a, **kw):
        raise AssertionError("the CPU reached a CUDA graph")

    for attr in ("graph", "CUDAGraph", "graph_pool_handle", "Stream",
                 "device", "Event"):
        monkeypatch.setattr(torch.cuda, attr, refuse)
    for attr in ("_graphed", "_capture", "_host_flag"):
        monkeypatch.setattr(tp2d, attr, refuse)
    case = cases(name)
    tabs = case.teng.device_chains
    before = tabs.graphs.captures
    got = tp2d.run_batch(*case.args(), **case.kw())
    stats = dict(tp2d.LAST_STATS)
    assert_reference(case, got, stats["rounds"], stats["n_pops"])
    assert not stats["graphed"] and stats["captured"] == 0
    assert tabs.graphs.captures == before
