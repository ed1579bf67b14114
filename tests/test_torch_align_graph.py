"""Port vs reference: the alignment Viterbi as a frame loop over fixed,
padded tensors (search/align.py `_Viterbi`), the body that a CUDA card
captures once per bucket of chain sizes and replays once a frame.

On the CPU the same body runs from Python:

* at N_cap in {N, the next power of two, twice that}, each at T_cap = T
  and at a larger T_cap, against the unpadded run (`viterbi_chain` on
  the CPU) and the reference's `viterbi_chain` on the same outprob rows
  (the reference scorer's), with `cut` 0 and 7 frames past n_frames:
  backpointers bit-equal, best node equal, the score equal to the
  unpadded run's and within atol 1e-4 of the reference's (the
  tolerance of tests/test_torch_align.py);
* on a chain whose every path dies before the end (strictly left to
  right, fewer nodes than frames), where the dead nodes' backpointers
  come from float32 sums near LOG_ZERO;
* through `_graphed`'s bookkeeping with the capture replaced by a
  stand-in whose replay runs the step: two transcripts of different N
  in one bucket share one cache entry (one capture), each equal to its
  eager run bit for bit; another bucket takes another entry, and past
  GRAPHS_KEPT the oldest entry goes.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.search import align as jalign
from julius_tpu_torch.search import align as talign
from julius_tpu_torch.search.pass1 import GraphCache

from test_torch_align import (engines, flagship, lvcsr,  # noqa: F401
                              mono)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

LOG_ZERO = -1e10
DTYPES = (torch.int64, torch.int64, torch.float32, torch.float32,
          torch.float32)


def tables(args):
    """(score_idx, in_src, in_lp, entry_lp, exit_lp) as the loop takes
    them."""
    return [torch.as_tensor(np.asarray(a)).to(dt)
            for a, dt in zip(args, DTYPES)]


def padded_run(args, out_ext, n, n_cap, t_cap):
    """The loop body at n_cap nodes and t_cap frames, from Python."""
    tabs = tables(args)
    T = out_ext.shape[0]
    loop = talign._Viterbi(n_cap, tabs[1].shape[1], t_cap, "cpu")
    loop.load(*tabs[:4], out_ext)
    for _ in range(max(0, min(T, n) - 1)):
        loop.step()
    return loop.result(tabs[4], T)


def reference(args, out_ext, n):
    s, bp, best = jalign.viterbi_chain(
        *[jnp.asarray(np.asarray(a)) for a in args],
        jnp.asarray(out_ext.numpy()), jnp.asarray(n))
    return float(s), np.asarray(bp), int(best)


def caps(N, T):
    """N_cap in {N, the next power of two, twice that} at T_cap = T and
    at twice the next power of two of T."""
    p = 1 << (N - 1).bit_length()
    t = 2 << (T - 1).bit_length()
    return [(nc, tc) for nc in (N, p, 2 * p) for tc in (T, t)]


def check_all(args, out_ext, n):
    """Every padding of `caps` against the unpadded run and the
    reference."""
    ws, wbp, wbest = reference(args, out_ext, n)
    us, ubp, ubest = talign.viterbi_chain(*tables(args), out_ext, n)
    assert np.array_equal(ubp.numpy(), wbp)
    assert int(ubest) == wbest
    assert float(us) == pytest.approx(ws, abs=1e-4)
    N, T = len(args[0]), out_ext.shape[0]
    for n_cap, t_cap in caps(N, T):
        gs, gbp, gbest = padded_run(args, out_ext, n, n_cap, t_cap)
        assert gbp.shape == (T, N)
        assert torch.equal(gbp, ubp), (n_cap, t_cap)
        assert int(gbest) == wbest
        assert torch.equal(gs, us)
        assert float(gs) == pytest.approx(ws, abs=1e-4)
    return ws


@pytest.mark.parametrize("cut", [0, 7])
def test_padded_body_matches_unpadded_and_reference(engines, cut):
    _, jeng, utts = engines
    for ids, frames in utts:
        chain = jalign.build_chain(jeng.hmm, jeng.voca, ids,
                                   pseudo=jeng.net.pseudo)
        out_ext = torch.as_tensor(np.asarray(
            jeng._outprob_jit(jnp.asarray(frames)[None])[0]))
        args = [chain.score_idx, chain.in_src, chain.in_lp, chain.entry_lp,
                chain.exit_lp]
        assert np.isfinite(check_all(args, out_ext, out_ext.shape[0] - cut))


def hand_chain(N, Din, loops, seed, R=20):
    """A left-to-right chain of N nodes: node n's in-arcs come from
    n-1 .. n-Din+1 (and from itself where `loops`), the missing ones
    padded as build_chain pads them (the node itself at LOG_ZERO); entry
    at node 0, exit at node N-1; emission columns drawn from R."""
    rng = np.random.default_rng(seed)
    in_src = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, Din))
    in_lp = np.full((N, Din), LOG_ZERO, np.float32)
    for n in range(N):
        srcs = ([n] if loops else []) + [n - k for k in range(1, Din)]
        for d, s in enumerate(x for x in srcs[:Din] if x >= 0):
            in_src[n, d] = s
            in_lp[n, d] = -float(rng.integers(1, 4))
    entry = np.full(N, LOG_ZERO, np.float32)
    entry[0] = 0.0
    exit_lp = np.full(N, LOG_ZERO, np.float32)
    exit_lp[N - 1] = -0.5
    sidx = rng.integers(0, R, N).astype(np.int32)
    return [sidx, in_src, in_lp, entry, exit_lp]


def rows(T, R, seed):
    # integer-valued rows make exact ties common
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-6, 0, (T, R)).astype(np.float32))


@pytest.mark.parametrize("cut", [0, 7])
def test_dying_chain_matches_reference(cut):
    """12 nodes without self-loops over 40 frames: every path has walked
    off the chain's end long before the last frame, so every final score
    is dead, and the padded body still gives the reference's
    backpointers."""
    args = hand_chain(12, 3, loops=False, seed=5)
    out_ext = rows(40, 20, seed=6)
    ws = check_all(args, out_ext, 40 - cut)
    assert ws <= LOG_ZERO / 2
    s, _, _ = padded_run(args, out_ext, 12, 12, 40)
    assert float(s) > LOG_ZERO / 2       # alive at frame 11: a real chain


def graph_path(monkeypatch):
    """viterbi_chain on the CPU through `_graphed`, its capture a
    stand-in that runs the step once and replays it by running it again;
    -> the list of captures made."""
    captures = []

    def capture(cache, device, step):
        captures.append(device)
        step()
        return [types.SimpleNamespace(replay=step)]

    monkeypatch.setattr(talign, "_eager", talign._graphed)
    monkeypatch.setattr(talign, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return captures


def test_one_bucket_shares_one_entry(monkeypatch):
    """Chains of 70 and 100 nodes over 40 and 55 frames share the
    (128, 64) entry; a 20-node chain takes (64, 64); a hit moves its
    entry last; with GRAPHS_KEPT 1 a 300-node chain drops the others.
    Every run equals its eager run bit for bit."""
    cases = [(hand_chain(70, 2, True, seed=1), rows(40, 20, 2), 40),
             (hand_chain(100, 2, True, seed=3), rows(55, 20, 4), 50),
             (hand_chain(20, 2, True, seed=5), rows(55, 20, 6), 55),
             (hand_chain(300, 2, True, seed=7), rows(40, 20, 8), 33)]
    want = [talign.viterbi_chain(*tables(args), out_ext, n)
            for args, out_ext, n in cases]
    captures = graph_path(monkeypatch)
    monkeypatch.setattr(talign, "GRAPHS_KEPT", 2)
    cache = GraphCache()

    def run(i):
        args, out_ext, n = cases[i]
        got = talign.viterbi_chain(*tables(args), out_ext, n, graphs=cache)
        gs, gbp, gbest = got
        ws, wbp, wbest = want[i]
        assert torch.equal(gbp, wbp)
        assert int(gbest) == int(wbest)
        assert torch.equal(gs, ws)
        return [k[1:] for k in cache.entries]

    assert run(0) == run(1) == [(128, 2, 64)]
    assert len(captures) == cache.captures == 1
    assert next(iter(cache.entries))[0] == torch.device("cpu")
    assert run(2) == [(128, 2, 64), (64, 2, 64)]
    assert run(0) == [(64, 2, 64), (128, 2, 64)]
    assert cache.captures == 2
    monkeypatch.setattr(talign, "GRAPHS_KEPT", 1)
    assert run(3) == [(512, 2, 64)]
    assert len(captures) == cache.captures == 3


def test_cpu_runs_the_eager_loop(monkeypatch):
    """On the CPU viterbi_chain never reaches a capture, with a cache
    or without."""
    monkeypatch.setattr(talign, "_capture", None)
    args = hand_chain(30, 2, True, seed=9)
    out_ext = rows(25, 20, 10)
    a = talign.viterbi_chain(*tables(args), out_ext, 25)
    b = talign.viterbi_chain(*tables(args), out_ext, 25, graphs=GraphCache())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
