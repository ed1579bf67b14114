"""Port vs reference: pass 1 built on its device-t frame step.

The port runs pass 1 as one frame step (`search/pass1.py` `_frame`)
whose frame index is a device tensor, so that a CUDA card can capture
the step once as a graph and replay it once a frame, as the reference's
jitted `lax.scan` runs its step.  On the CPU the same step runs once a
frame from Python.  Here, on the reference's small fixtures (the models
of tests/test_torch_pass1_unfused.py), the port's pass1_batch is held
against the reference's pass1_batch on the same seeded outprob rows and
ragged lengths (frames past an utterance's end included), two ways:

  * the eager loop, as the CPU runs it;
  * the graph path's own bookkeeping (`_graphed`: the fixed tensors of a
    power-of-two frame capacity with two state sets, the two captured
    steps from set 0 to 1 and back, each run once by the capture as
    frames 1 and 2, T - 2 replays of the steps in turn, the cache of
    graphs), with the capture replaced by a stand-in whose replays run
    the steps.  A second batch of other lengths and values reuses the
    first batch's entry, a longer one takes a new capacity, and each
    equals the eager loop on its own bit for bit, at T = 1, odd and
    even T and T equal to the capacity, and with batches of either
    parity through one entry.

Branches: the kernel path (the reference's Pallas kernel through its
interpreter, the port's plain version of the kernel), the unfused
N-gram step, a DFA grammar, isolated words, factoring 2, the score
envelope, per-context head rows and the arc gather.  The rule is
tests/test_pass1_fused.py's: word ids equal everywhere, other integer
fields equal and scores within atol 1e-5 where a word survived.  And
pass1_batch on the CPU never reaches torch.cuda's graphs.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.search import pass1 as jp1
from julius_tpu_torch.search import pass1 as tp1

from test_torch_pass1 import trellis_equal
from test_torch_pass1_unfused import (CASES, NGRAM_SENTS, build_engines,
                                      reference_rows)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

#: case -> (CASES entry and its search overrides, use_kernel); "fused"
#: and "ngram_unfused" are the N-gram configuration the kernel serves
BRANCHES = {"fused": ("envelope", dict(beam_width=0), True),
            "ngram_unfused": ("envelope", dict(beam_width=0), False),
            **{c: (c, None, True) for c in sorted(CASES)}}


def reference(jeng, out, lens, fused):
    old = jp1.FUSE_PASS1
    jp1.FUSE_PASS1 = fused      # True: the Pallas kernel, interpreted
    try:
        ref = jp1.pass1_batch(jeng.dev_net, jeng.ngram_dev, jeng.p1_cfg,
                              jnp.asarray(out), jnp.asarray(lens))
    finally:
        jp1.FUSE_PASS1 = old
    return jax.tree_util.tree_map(np.asarray, ref)


def port(teng, out, lens, use_kernel):
    got = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                          torch.from_numpy(out), torch.from_numpy(lens),
                          use_kernel=use_kernel)
    return tp1.Trellis(*[a.numpy() for a in got])


@pytest.fixture
def graph_path(monkeypatch):
    """pass1_batch on the CPU through `_graphed`, its capture a stand-in
    that runs each step once (the eager frame before each capture) and
    replays a step by running it again; -> the list of captures made
    (one a call, whatever its number of steps)."""
    captures = []

    def capture(cache, device, *steps):
        captures.append(device)
        for step in steps:
            step()
        return [types.SimpleNamespace(replay=step) for step in steps]

    monkeypatch.setattr(tp1, "_eager", tp1._graphed)
    monkeypatch.setattr(tp1, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return captures


def same_trellis(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def batches(jeng, sents):
    """Two batches at one frame count (ragged lengths, frames past each
    end), the second of other values and lengths."""
    out, lens = reference_rows(jeng, sents)
    T = out.shape[1]
    lens = np.minimum(lens, T - 2).astype(np.int32)  # frames past every end
    out2 = np.ascontiguousarray(out[::-1])
    out2[0] = out2[0][np.random.default_rng(3).permutation(T)]
    lens2 = np.maximum(lens[::-1] - np.asarray([0, 5, 9]), 2).astype(
        np.int32)
    assert not np.array_equal(lens, lens2) and (lens2 < T).all()
    return [(out, lens), (out2, lens2)]


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_loop_matches_reference(branch, graph_path, monkeypatch):
    case, extra, use_kernel = BRANCHES[branch]
    jeng, teng = build_engines(case, extra)
    fused = use_kernel and tp1.fused_ok(teng.dev_net, teng.p1_cfg)
    assert fused == (branch == "fused")
    assert (teng.dev_net.local_k < 0) == (case == "gather")
    calls = []
    real = tp1._frame
    monkeypatch.setattr(tp1, "_frame", lambda *a: calls.append(1) or
                        real(*a))
    data = batches(jeng, CASES[case][6])
    graphed = []
    for out, lens in data:
        calls.clear()
        graphed.append(port(teng, out, lens, use_kernel))
        assert len(calls) == out.shape[1]       # one step a frame
    assert len(graph_path) == len(teng.dev_net.graphs.entries) == 1
    monkeypatch.undo()
    (out, lens), (out2, lens2) = data
    ref = reference(jeng, out, lens, fused)
    assert (ref.word >= 0).sum() > 20
    trellis_equal(ref, graphed[0])
    trellis_equal(ref, port(teng, out, lens, use_kernel))   # the eager loop
    # the second batch, through the first's fixed tensors, equals the
    # eager loop on its own
    same_trellis(graphed[1], port(teng, out2, lens2, use_kernel))


def test_longer_batch_takes_a_new_capacity(graph_path, monkeypatch):
    """Batches of T, then more than the first capacity, then T again: two
    captures, each trellis the eager loop's."""
    jeng, teng = build_engines("envelope", dict(beam_width=0))
    (out, lens), (out2, lens2) = batches(jeng, NGRAM_SENTS)
    T = out.shape[1]
    cap = max(tp1.MIN_T_BUCKET, 1 << (T - 1).bit_length())
    long = np.concatenate([out, out2], axis=1)[:, :cap + 3]
    long_lens = (lens + lens2).astype(np.int32)
    assert long.shape[1] > cap and (long_lens < long.shape[1]).all()
    data = ((out, lens), (long, long_lens), (out2, lens2))
    graphed = [port(teng, o, n, True) for o, n in data]
    assert len(graph_path) == 2
    caps = sorted(k[-1] for k in teng.dev_net.graphs.entries)
    assert caps == [cap, 2 * cap]
    monkeypatch.undo()
    for (o, n), got in zip(data, graphed):
        same_trellis(got, port(teng, o, n, True))


def frames_of(out, lens, T):
    """The first T frames of a batch, each utterance cut to them, the
    last ones shorter (at T > 2)."""
    lens = np.minimum(lens, T) - np.minimum([0, 1, 3], T - 1)
    return np.ascontiguousarray(out[:, :T]), lens.astype(np.int32)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["fused", "ngram_unfused"])
@pytest.mark.parametrize("T", [1, 7, 10, tp1.MIN_T_BUCKET])
def test_graphed_equals_eager_at_every_frame_count(graph_path, monkeypatch,
                                                   T, use_kernel):
    """T = 1, an odd and an even T and T equal to the capacity, each the
    first batch of its entry (the capture's two eager steps are its
    first frames; at T = 1 the second is a masked frame) and again
    through that entry: the graph path ends on either state set, and its
    trellis equals the eager loop's bit for bit."""
    jeng, teng = build_engines("envelope", dict(beam_width=0))
    (out, lens), _ = batches(jeng, NGRAM_SENTS)
    out, lens = frames_of(out, lens, T)
    assert tp1.MIN_T_BUCKET == max(tp1.MIN_T_BUCKET,
                                   1 << (T - 1).bit_length())
    calls = []
    real = tp1._frame
    monkeypatch.setattr(tp1, "_frame", lambda *a: calls.append(1) or
                        real(*a))
    got = port(teng, out, lens, use_kernel)
    assert len(calls) == max(T, 2)
    calls.clear()
    again = port(teng, out, lens, use_kernel)
    assert len(calls) == T and len(graph_path) == 1
    monkeypatch.undo()
    want = port(teng, out, lens, use_kernel)
    same_trellis(got, want)
    same_trellis(again, want)
    assert want.word.shape == (3, T, teng.p1_cfg.n_atoms)
    assert (want.word >= 0).sum() > 0 or T == 1   # no word ends at frame 0


@pytest.mark.parametrize("T", [1, 3])
def test_launches_count_the_frames_of_a_capturing_batch(graph_path,
                                                        monkeypatch, T):
    """The kernels' LAUNCHES, with a stand-in that counts a launch of
    each kernel a frame run from Python and a captured one a captured
    step: a batch that captures its entry counts T frames of launches
    (at T = 1 the capture's masked frame 2 is left out), and so does a
    batch that replays it."""
    jeng, teng = build_engines("envelope", dict(beam_width=0))
    (out, lens), _ = batches(jeng, NGRAM_SENTS)
    out, lens = frames_of(out, lens, T)
    replaying = []
    real = tp1._frame

    def frame(*a):
        if not replaying:
            for m in tp1.KERNELS:
                m.LAUNCHES += 1
        return real(*a)

    def capture(cache, device, *steps):
        for step in steps:
            step()
            for m in tp1.KERNELS:
                m.CAPTURED += 1
        replaying.append(1)
        return [types.SimpleNamespace(replay=step) for step in steps]

    monkeypatch.setattr(tp1, "_frame", frame)
    monkeypatch.setattr(tp1, "_capture", capture)
    for m in tp1.KERNELS:
        monkeypatch.setattr(m, "LAUNCHES", 0)
        monkeypatch.setattr(m, "CAPTURED", 0)
    port(teng, out, lens, True)
    assert [m.LAUNCHES for m in tp1.KERNELS] == [T, T]
    port(teng, out, lens, True)
    assert [m.LAUNCHES for m in tp1.KERNELS] == [2 * T, 2 * T]


def test_one_entry_takes_batches_of_either_parity(graph_path, monkeypatch):
    """Batches of odd, even, odd and T = capacity frames through one
    entry: no batch starts from the state set the last one ended on,
    and each trellis is the eager loop's."""
    jeng, teng = build_engines("envelope", dict(beam_width=0))
    (out, lens), (out2, lens2) = batches(jeng, NGRAM_SENTS)
    cap = tp1.MIN_T_BUCKET
    data = [frames_of(out, lens, 9), frames_of(out2, lens2, 12),
            frames_of(out2, lens2, 11), frames_of(out, lens, cap),
            frames_of(out, lens, 9)]
    graphed = [port(teng, o, n, True) for o, n in data]
    assert len(graph_path) == 1
    assert [k[-1] for k in teng.dev_net.graphs.entries] == [cap]
    monkeypatch.undo()
    for (o, n), got in zip(data, graphed):
        same_trellis(got, port(teng, o, n, True))
    same_trellis(graphed[0], graphed[-1])


def test_cpu_never_reaches_cuda_graphs(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CPU reached a CUDA graph")

    for name in ("graph", "CUDAGraph", "graph_pool_handle", "Stream",
                 "device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(tp1, "_graphed", refuse)
    monkeypatch.setattr(tp1, "_capture", refuse)
    jeng, teng = build_engines("envelope", dict(beam_width=0))
    out, lens = reference_rows(jeng, NGRAM_SENTS)
    for use_kernel in (True, False):
        got = port(teng, out, lens, use_kernel)
        assert got.word.shape == (3, out.shape[1], teng.p1_cfg.n_atoms)
        assert (got.word >= 0).sum() > 20
    assert not teng.dev_net.graphs.entries
    assert teng.dev_net.graphs.captures == 0
