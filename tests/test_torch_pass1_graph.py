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
    power-of-two frame capacity, the eager first frame, T-1 replays, the
    cache of graphs), with the capture replaced by a stand-in whose
    replay runs the step.  A second batch of other lengths and values
    reuses the first batch's entry, a longer one takes a new capacity,
    and each equals the eager loop on its own bit for bit.

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
    that runs the step once (the eager first frame) and replays it by
    running it again; -> the list of captures made."""
    captures = []

    def capture(cache, device, step):
        captures.append(device)
        step()
        return types.SimpleNamespace(replay=step)

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
