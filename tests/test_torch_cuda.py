"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the decode on CUDA against the decode on the CPU, for the
default pass 2 (device A*), the host re-scan and the frozen search; the
tied-triphone configuration (pseudo-set outprobs, the strict-head scan,
its decode), the waveform front end, the GMM scorer and the command
line on GMM-HMM model files likewise; pass 1's unfused step (factoring
2, the score envelope, isolated words, a topology with backward arcs)
and a grammar decode on the card against the CPU; the f32 products
that stay full f32 when the caller turns TF32 on; a stream on the card
against the batch decode, the alignment Viterbi on the card against the
CPU, and the native audio-input library built into the package; a
backward N-gram pair and an application LM decoding on the card like
the CPU, the full-utterance scan on the card equal to its plain version
(and its limits raising), and parallel/ on a mesh that repeats the
card; pass 1's frame step captured as a CUDA graph against its eager
oracle on every branch (reuse of a graph, a new frame capacity, launch
counts on replays, a capture beside another thread's allocations, a
capture that meets a host synchronisation), the device A*'s round
captured likewise against its eager oracle (the flagship and strict
heads, launch counts on replays, a capture that meets a host
synchronisation), a stream's pass-1 chunk and the alignment Viterbi
captured likewise (one capture for two streams and no more than one a
bucket of chain sizes, one replay a frame, captures that meet a host
synchronisation), the sharded pass 1's frame step captured likewise
(one graph on a mesh that repeats the card, against its eager oracle
and the CPU; two graphs a card, the gather between them, on two
cards; a capture that meets a host synchronisation), a decode on a
second card from a thread whose current card is the first, and pass 1's
word-end stage (csrc/word_end.cu) bit-equal to its plain version at the
flagship's and the 20k-word configuration's widths, on rows of ties,
with narrow and wide 2-gram keys, at B = 1 and through whole decodes;
at every cluster size its plan can pick (ties across block edges, rows
that are nearly all LOG_ZERO or all one score, fewer exits than
blocks, keys in global scratch, a captured and replayed graph), and a
cluster that cannot be scheduled raising.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the reference package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from julius_tpu_torch.ops import pass1_kernel as tpk
from julius_tpu_torch.ops import scan_kernel as tsk
from julius_tpu_torch.ops import word_end_kernel as twe
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.tools import synth

from torch_fixtures import (LOG_ZERO, assert_same_step, make_step_inputs,
                            make_word_end_inputs, run_step, word_end_args)

pytestmark = pytest.mark.cuda

SMALL = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tie_at_tile_edges(d, plan, K):
    """Exact ties at every tile start t0 > 0 of `plan`: each shifted
    candidate from the previous tile (k = 1..K) ties with the in-tile one
    (k = 0), and in row 2 the entry candidate ties too, so only the
    smallest k may win."""
    d = {k: v.copy() for k, v in d.items()}
    B, N = d["score"].shape
    for t0 in range(plan.tile, N, plan.tile):
        for k in range(K + 1):
            if t0 - k >= 0:
                d["score"][:, t0 - k] = -10.0
            d["loc"][k, t0] = -2.0
        if B > 2:
            d["et"][t0] = -12.0 - d["ent"][2]
    return d


@pytest.mark.parametrize("B", [1, 2, 4, 16, 32, 64])
@pytest.mark.parametrize("K,N", [(1, 5000), (3, 4099), (8, 4099),
                                 (1, 4100), (8, 300)])
def test_kernel_matches_plain(cuda, B, K, N):
    d = make_step_inputs(B + K, B, N, K)
    plan = tpk._plan(torch.device("cuda", 0), B, N, K + 1)
    if N > 300:
        assert plan.n_tiles >= 3
    d = tie_at_tile_edges(d, plan, K)
    for f in range(3):
        before = tpk.LAUNCHES
        got = run_step(d, cuda, tpk.fused_step)
        torch.cuda.synchronize()
        assert tpk.LAUNCHES == before + 1
        want = run_step(d, cuda, tpk.fused_step_plain)
        assert_same_step(got, want)
        assert_same_step(got, run_step(d))            # and the CPU path
        d = dict(d, score=got[0], ctx=got[1], prev=got[2],
                 fv=np.roll(d["fv"], 1))


def test_kernel_rejects_bad_arguments(cuda):
    d = make_step_inputs(0, 2, 600, 1)
    t = {k: torch.tensor(v, device=cuda) for k, v in d.items()}
    args = [t[k] for k in ("score", "ctx", "prev", "loc", "et", "row",
                           "sidx", "ent", "ectx", "eprev", "fv")]
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError, match="ctx"):
        tpk.fused_step(*bad)
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError, match="score_idx"):
        tpk.fused_step(*bad)


def test_kernel_takes_any_row_stride_and_refuses_misaligned_state(cuda):
    """A frame row that is a view of a [B, 3, R] cache at frame 1 (its
    rows 8 bytes off 16-byte alignment) gives the plain version's
    result; state that does not start 16-byte aligned raises."""
    B, N, K, R = 5, 4099, 1, 50
    d = make_step_inputs(9, B, N, K, R=R)
    t = {k: torch.tensor(v, device=cuda) for k, v in d.items()}
    cache = torch.zeros(B, 3, R, device=cuda)
    cache[:, 1] = t["row"]
    args = [t[k] for k in ("score", "ctx", "prev", "loc", "et")]
    tail = [t[k] for k in ("sidx", "ent", "ectx", "eprev", "fv")]
    got = tpk.fused_step(*args, cache[:, 1], *tail)
    want = tpk.fused_step_plain(*args, t["row"], *tail)
    assert_same_step([a.cpu().numpy() for a in got],
                     [a.cpu().numpy() for a in want])
    off = torch.empty(B * N + 1, device=cuda)[1:].view(B, N)
    off.copy_(t["score"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpk.fused_step(off, *args[1:], t["row"], *tail)


def make_scan_inputs(seed, K, W, N, K1, B=3, T=120, R=60):
    """One windowed scan's arrays, integer-valued so that shifted arcs,
    entries and word ends tie; every fifth chain dead (all LOG_ZERO)."""
    rng = np.random.default_rng(seed)
    LZ = np.float32(-1e10)
    loc = rng.integers(-2, 1, (K, K1, N)).astype(np.float32)
    loc[rng.random(loc.shape) < 0.2] = LZ
    ent = rng.integers(-3, 0, (K, N)).astype(np.float32)
    ent[rng.random(ent.shape) < 0.7] = LZ
    ext = rng.integers(-1, 1, (K, N)).astype(np.float32)
    ext[rng.random(ext.shape) < 0.3] = LZ
    for a in (loc, ent, ext):
        a[::5] = LZ
    sidx = rng.integers(0, R, (K, N)).astype(np.int32)
    seed_w = rng.integers(-60, -20, (K, W)).astype(np.float32)
    seed_w[rng.random((K, W)) < 0.6] = LZ
    seed_w[:, 3:9] = LZ
    out = rng.integers(-4, 3, (B, T, R)).astype(np.float32)
    bidx = rng.integers(0, B, K).astype(np.int32)
    t0 = rng.integers(0, T - W + 1, K).astype(np.int32)
    t0[1::3] = T - W
    return (loc, ent, ext, sidx, seed_w, out, bidx, t0)


@pytest.mark.parametrize("K,W,N,K1", [
    (16, 64, 21, 2), (5, 120, 32, 1), (7, 40, 33, 3), (3, 17, 300, 9),
    (2, 9, 1, 1),
    # the edges of the chunked kernel: one frame, a chunk less and more
    # one frame, the whole utterance (W = T), more than 32 nodes, the
    # longest arc span it takes and the first one it leaves to the block
    (16, 1, 21, 2), (16, tsk.CHUNK - 1, 21, 2), (16, tsk.CHUNK + 1, 21, 2),
    (16, 120, 21, 2), (64, 100, 45, 3), (8, 40, 21, 4), (8, 40, 21, 5)])
def test_scan_kernel_matches_plain(cuda, K, W, N, K1):
    arrays = make_scan_inputs(K + W + N, K, W, N, K1)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = tsk.LAUNCHES
    got = tsk.scan_core_win(*args)
    torch.cuda.synchronize()
    assert tsk.LAUNCHES == before + 1
    want = tsk.scan_core_win_plain(*args)
    cpu = tsk.scan_core_win(*[torch.from_numpy(a) for a in arrays])
    for ref in (want, cpu):
        assert float((got[0].cpu() - ref[0].cpu()).abs().max()) <= 1e-5
        assert torch.equal(got[1].cpu(), ref[1].cpu())
        assert float((got[2].cpu() - ref[2].cpu()).abs().max()) <= 1e-5
    assert (got[0][::5] == -1e10).all()


def test_scan_kernel_rejects_bad_arguments(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in make_scan_inputs(0, 4, 10, 21, 2)]
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError, match="sidx"):
        tsk.scan_core_win(*bad)
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError, match="bidx"):
        tsk.scan_core_win(*bad)
    wide = make_scan_inputs(0, 2, 10, 1025, 2)
    with pytest.raises(ValueError, match="1025 nodes"):
        tsk.scan_core_win(*[torch.from_numpy(a).to(cuda) for a in wide])


#: name -> (make_word_end_inputs arguments, Pass1Config fields); the
#: first two are the flagship's (B = 16, 5000 exits, M = 32) and the
#: 20k-word configuration's (B = 32, 20,000 exits, M = 128) widths
WORD_END_CASES = {
    "flagship": (dict(B=16, N=74968, Ex=5000, M=32, V=600, n_lm=400), {}),
    "lvcsr": (dict(B=32, N=299720, Ex=20000, M=128, V=2000, n_lm=400), {}),
    "lvcsr_wide": (dict(B=32, N=299720, Ex=20000, M=128, V=2000, n_lm=400,
                        wide=True), {}),
    "lvcsr_b1": (dict(B=1, N=299720, Ex=20000, M=128, V=2000, n_lm=400), {}),
    "flagship_b1": (dict(B=1, N=74968, Ex=5000, M=32, V=600, n_lm=400), {}),
    "ties": (dict(B=4, N=3000, Ex=700, M=32), {}),
    "ties_wide": (dict(B=4, N=3000, Ex=700, M=32, wide=True), {}),
    "factoring2": (dict(B=4, N=3000, Ex=700, M=32), dict(factoring=2)),
    "no_lm": (dict(B=4, N=3000, Ex=700, M=32, lm=False),
              dict(use_lm=False, lm_penalty=-2.5)),
    "weights": (dict(B=3, N=2000, Ex=600, M=24),
                dict(lm_weight=6.7, lm_penalty=-3.25)),
    "ex_below_2m": (dict(B=3, N=400, Ex=40, M=32), {}),
    "ex_below_m": (dict(B=2, N=300, Ex=20, M=32), {}),
    "m1": (dict(B=2, N=500, Ex=100, M=1, straddle=False), {}),
    "wide_row": (dict(B=2, N=120000, Ex=45000, M=128, V=2000, n_lm=400),
                 {}),
}


def bits_equal(a, b) -> bool:
    """Equal dtypes and shapes, and floats equal bit for bit."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("case", list(WORD_END_CASES))
def test_word_end_kernel_matches_plain(cuda, case):
    """The kernel against its plain version on the card, bit for bit,
    with and without the winner, and against the CPU path; one launch a
    call, at the wrapper's cluster plan."""
    shape, cfg_kw = WORD_END_CASES[case]
    d = make_word_end_inputs(len(case), **shape)
    cfg = tp1.Pass1Config(n_atoms=shape["M"], **cfg_kw)
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    t = torch.tensor([9], dtype=torch.int32, device=cuda)
    before = twe.LAUNCHES
    got, got_e = twe.word_end(dev, ng, cfg, score, ctx, prev, t)
    torch.cuda.synchronize()
    assert twe.LAUNCHES == before + 1
    want, want_e = twe.word_end_plain(dev, ng, cfg, score, ctx, prev, t)
    for name, a, b in zip(tp1.Trellis._fields, got, want):
        assert bits_equal(a, b), name
    assert all(bits_equal(a, b) for a, b in zip(got_e, want_e))
    alone, none = twe.word_end(dev, ng, cfg, score, ctx, prev)
    assert none is None and all(bits_equal(a, b) for a, b in zip(alone, got))
    cdev, cng, cs, cc, cp = word_end_args(d)
    on_cpu, cpu_e = twe.word_end_plain(cdev, cng, cfg, cs, cc, cp,
                                       torch.tensor([9], dtype=torch.int32))
    for a, b in zip((*got, *got_e), (*on_cpu, *cpu_e)):
        if a.dtype == torch.float32:
            assert torch.allclose(a.cpu(), b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a.cpu(), b)
    assert (got.word >= 0).sum() >= min(shape["Ex"], shape["M"])


def test_word_end_kernel_global_keys_and_strided_rows(cuda, monkeypatch):
    """Keys in global scratch instead of shared memory, and a state that
    is a view of wider rows (as pass 1 pads its node axis): equal to the
    plain version; the library's shared-memory size is the wrapper's."""
    shape = WORD_END_CASES["lvcsr"][0]
    d = make_word_end_inputs(5, **shape)
    cfg = tp1.Pass1Config(n_atoms=shape["M"])
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    want = twe.word_end_plain(dev, ng, cfg, score, ctx, prev)[0]
    monkeypatch.setattr(twe, "SMEM_KEYS_MAX", 0)
    got = twe.word_end(dev, ng, cfg, score, ctx, prev)[0]
    assert all(bits_equal(a, b) for a, b in zip(got, want))
    monkeypatch.undo()
    pad = [torch.nn.functional.pad(x, (0, 8), value=v)
           for x, v in ((score, LOG_ZERO), (ctx, -1), (prev, -1))]
    got = twe.word_end(dev, ng, cfg, *[x[:, :-8] for x in pad])[0]
    assert all(bits_equal(a, b) for a, b in zip(got, want))
    lib = twe.build()
    for Ex, M, shared in ((5000, 32, 1), (20000, 128, 1), (45000, 128, 0),
                          (20, 32, 1), (100, 1, 1), (33, 5, 1)):
        for C, threads in ((1, 1024), (2, 512), (4, 256), (8, 512)):
            assert lib.word_end_smem_bytes(Ex, min(2 * M, Ex), C, threads,
                                           shared) == \
                twe.smem_bytes(Ex, M, C, threads, bool(shared))


def edge_rows(d, C):
    """Rows 2 and 3 of make_word_end_inputs arrays rewritten so that the
    k-th key's ties straddle every block edge of a cluster of C: row 2
    nearly all LOG_ZERO (a few live exits at the ends of each block's
    range), row 3 every exit at one score but a few above it at block
    edges."""
    nodes, nlp = d["exit_nodes"], d["exit_nlp"]
    Ex = len(nodes)
    edges = sorted({min(r * Ex // C + o, Ex - 1) for r in range(C)
                    for o in (-2, -1, 0, 1)} - {-2, -1})
    d["score"][2, nodes] = LOG_ZERO
    d["score"][2, nodes[edges]] = -3.0 - nlp[edges]
    d["score"][3, nodes] = -7.0 - nlp
    d["score"][3, nodes[edges[::3]]] = -1.0 - nlp[edges[::3]]
    return d


#: (make_word_end_inputs arguments, Pass1Config fields) of the cluster
#: cases: the paths' widths at B = 16, 32 and 1, ties, wide keys,
#: factoring 2, no LM, Ex not a multiple of C, and fewer exits than C * 32
CLUSTER_CASES = {
    "flagship": (dict(B=16, N=74968, Ex=5000, M=32, V=600, n_lm=400), {}),
    "lvcsr": (dict(B=32, N=299720, Ex=20000, M=128, V=2000, n_lm=400), {}),
    "flagship_b1": (dict(B=1, N=74968, Ex=5000, M=32, V=600, n_lm=400), {}),
    "lvcsr_b1": (dict(B=1, N=299720, Ex=20000, M=128, V=2000, n_lm=400), {}),
    "edges": (dict(B=4, N=3000, Ex=701, M=32), {}),
    "edges_wide": (dict(B=4, N=3000, Ex=997, M=24, wide=True), {}),
    "factoring2": (dict(B=4, N=3000, Ex=700, M=32), dict(factoring=2)),
    "no_lm": (dict(B=4, N=3000, Ex=700, M=32, lm=False),
              dict(use_lm=False, lm_penalty=-2.5)),
    "few_exits": (dict(B=4, N=400, Ex=90, M=32), {}),
    "tiny": (dict(B=4, N=300, Ex=13, M=4), {}),
}


@pytest.mark.parametrize("C,threads", [(1, 1024), (1, 256), (2, 512),
                                       (2, 1024), (4, 512), (4, 1024),
                                       (8, 512), (8, 256)])
@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_word_end_kernel_at_every_cluster_size(cuda, monkeypatch, case, C,
                                               threads):
    """The kernel forced to a cluster of C blocks of `threads` threads a
    row (the C entry's explicit C) is bit-equal to its plain version,
    with and without the winner, on rows whose ties straddle the block
    edges, and with its keys in global scratch; one launch a call."""
    shape, cfg_kw = CLUSTER_CASES[case]
    d = make_word_end_inputs(C + len(case), **shape)
    if shape["B"] >= 4:
        d = edge_rows(d, C)
    cfg = tp1.Pass1Config(n_atoms=shape["M"], **cfg_kw)
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    t = torch.tensor([5], dtype=torch.int32, device=cuda)
    monkeypatch.setattr(twe, "cluster_plan", lambda B, Ex: (C, threads))
    want = twe.word_end_plain(dev, ng, cfg, score, ctx, prev, t)
    for keys_max in (twe.SMEM_KEYS_MAX, 0):
        monkeypatch.setattr(twe, "SMEM_KEYS_MAX", keys_max)
        before = twe.LAUNCHES
        got = twe.word_end(dev, ng, cfg, score, ctx, prev, t)
        alone, none = twe.word_end(dev, ng, cfg, score, ctx, prev)
        torch.cuda.synchronize()
        assert twe.LAUNCHES == before + 2 and none is None
        for name, a, b in zip(tp1.Trellis._fields, got[0], want[0]):
            assert bits_equal(a, b), (name, keys_max)
        assert all(bits_equal(a, b) for a, b in zip(got[1], want[1]))
        assert all(bits_equal(a, b) for a, b in zip(alone, want[0]))


def test_word_end_cluster_kernel_in_a_graph(cuda, monkeypatch):
    """A cluster launch captured into a CUDA graph and replayed on new
    states equals the plain version on them; CAPTURED counts the
    capture and LAUNCHES no launch.  The wrapper's first call of a plan
    (its occupancy query) may come under capture, as a decode's first
    frame graph makes it."""
    shape = CLUSTER_CASES["flagship"][0]
    d = make_word_end_inputs(3, **shape)
    cfg = tp1.Pass1Config(n_atoms=shape["M"])
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    assert twe.cluster_plan(shape["B"], shape["Ex"])[0] > 1
    t = torch.tensor([4], dtype=torch.int32, device=cuda)
    static = [x.clone() for x in (score, ctx, prev)]
    monkeypatch.setattr(twe, "_CLUSTERS", {})
    graph = torch.cuda.CUDAGraph()
    launches, captured = twe.LAUNCHES, twe.CAPTURED
    with torch.cuda.graph(graph):
        out = twe.word_end(dev, ng, cfg, *static, t)
    assert twe.CAPTURED == captured + 1 and twe.LAUNCHES == launches
    for seed in (4, 5):
        e = make_word_end_inputs(seed, **shape)
        _, _, s2, c2, p2 = word_end_args(e, cuda)
        for x, y in zip(static, (s2, c2, p2)):
            x.copy_(y)
        t.fill_(seed)
        graph.replay()
        want = twe.word_end_plain(dev, ng, cfg, s2, c2, p2, t)
        torch.cuda.synchronize()
        for a, b in zip((*out[0], *out[1]), (*want[0], *want[1])):
            assert bits_equal(a, b)


def test_word_end_unschedulable_cluster_raises(cuda, monkeypatch):
    """Where the runtime says no cluster of the plan fits, the wrapper
    raises instead of launching one block a row; at the paths' recorded
    shapes every plan fits its B clusters at once."""
    d = make_word_end_inputs(2, B=2, N=6000, Ex=2048, M=16)
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    cfg = tp1.Pass1Config(n_atoms=16)
    lib = twe.build()
    for B, Ex, M in ((16, 5000, 32), (64, 5000, 32), (1, 5000, 32),
                     (32, 20000, 128), (8, 20000, 128), (1, 20000, 128),
                     (4, 5000, 64)):
        C, threads = twe.cluster_plan(B, Ex)
        smem = twe.smem_bytes(Ex, M, C, threads, True)
        assert twe.max_clusters(lib, cuda, C, threads, smem) >= B, (B, Ex)
    monkeypatch.setattr(twe, "cluster_plan", lambda B, Ex: (4, 1024))
    monkeypatch.setattr(twe, "max_clusters", lambda *a: 0)
    before = twe.LAUNCHES
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        twe.word_end(dev, ng, cfg, score, ctx, prev)
    assert twe.LAUNCHES == before


def test_word_end_kernel_rejects_bad_arguments(cuda):
    d = make_word_end_inputs(2, B=2, N=600, Ex=100, M=8)
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    cfg = tp1.Pass1Config(n_atoms=8)
    with pytest.raises(TypeError, match="ctx"):
        twe.word_end(dev, ng, cfg, score, ctx.long(), prev)
    with pytest.raises(ValueError, match="t on cpu"):
        twe.word_end(dev, ng, cfg, score, ctx, prev,
                     torch.tensor([3], dtype=torch.int32))
    no_info = types.SimpleNamespace(**dict(vars(dev), ctx_info=None))
    with pytest.raises(ValueError, match="ctx_info"):
        twe.word_end(no_info, ng, cfg, score, ctx, prev)
    # 2M = 16,384 candidates outgrow a block's shared memory
    d = make_word_end_inputs(2, B=1, N=30000, Ex=20000, M=8)
    dev, ng, score, ctx, prev = word_end_args(d, cuda)
    with pytest.raises(ValueError, match="M = 8192"):
        twe.word_end(dev, ng, tp1.Pass1Config(n_atoms=8192), score, ctx,
                     prev)


def test_pass1_word_end_kernel_path_matches_plain_path(engines, monkeypatch):
    """The engine's graphed pass 1, the word-end kernel in it, against
    the eager loop with the word-end stage's plain version in it, on the
    kernel path and the unfused step: bit-equal trellises, one word-end
    launch a frame."""
    eng, _, feats, lens = engines
    out = eng._outprob(torch.from_numpy(feats).cuda())
    T = feats.shape[1]
    for use_kernel in (True, False):
        before = twe.LAUNCHES
        got = tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg, out,
                              torch.from_numpy(lens), use_kernel=use_kernel)
        torch.cuda.synchronize()
        assert twe.LAUNCHES == before + T
        with monkeypatch.context() as m:
            m.setattr(twe, "word_end", twe.word_end_plain)
            want = tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                                   out, torch.from_numpy(lens),
                                   use_kernel=use_kernel, eager=True)
        for name, a, b in zip(tp1.Trellis._fields, got, want):
            assert bits_equal(a, b), name


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, protos = synth.flagship_engine(trained=True, device="cuda", **SMALL)
    cpu, _ = synth.flagship_engine(trained=True, device="cpu", **SMALL)
    truths, wins, lens = synth.make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11, min_words=2,
        max_words=5, seed=1)
    feats = np.zeros((3, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, cpu, feats, np.asarray(lens, np.int32)


def test_pass1_kernel_path_matches_plain_path(engines, monkeypatch):
    """The engine's pass 1 (the graphed kernel path) against the eager
    loop with the kernel's plain version in it."""
    eng, _, feats, lens = engines
    out = eng._outprob(torch.from_numpy(feats).cuda())
    before = tpk.LAUNCHES
    got = eng._pass1(out, lens)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES == before + feats.shape[1]
    monkeypatch.setattr(tpk, "fused_step", tpk.fused_step_plain)
    want = tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg, out,
                           torch.from_numpy(lens), eager=True)
    assert torch.equal(got.word, want.word)
    valid = want.word >= 0
    for name in tp1.Trellis._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(torch.where(valid, a, 0), torch.where(valid, b, 0))


def test_decode_on_card_matches_cpu(engines):
    eng, cpu, feats, lens = engines
    got = eng.decode_features(feats, lens)
    want = cpu.decode_features(feats, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)


def test_device_astar_kernel_path_matches_plain_path(engines, monkeypatch):
    eng, _, feats, lens = engines
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats).cuda())
        tr = eng._pass1(out, lens)
    host = tp1.Trellis(*[a.cpu().numpy() for a in tr])
    lats = [tp2.TrellisLattice(tp1.Trellis(*[a[b] for a in host]), int(n))
            for b, n in enumerate(lens)]
    args = (lats, eng.device_chains, eng.ngram_dev, eng._wid2lm,
            eng._cprob_arr(), out, eng._rescan_strategy(), eng.search_cfg)
    before = tsk.LAUNCHES
    got = tp2d.run_batch(*args)
    # the graphed A*: one launch a round the card ran, past the end too
    stats = tp2d.LAST_STATS
    assert tsk.LAUNCHES - before == stats["replayed"] >= stats["rounds"] > 0
    monkeypatch.setattr(tp2d, "scan_core_win", tsk.scan_core_win_plain)
    want = tp2d.run_batch(*args, eager=True)
    assert [[r.word_ids for r in g] for g in got] == \
        [[r.word_ids for r in w] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.score == pytest.approx(b.score, abs=1e-4)
            assert a.bounds == b.bounds


@pytest.mark.parametrize("search", [dict(pass2_device=False),
                                    dict(pass2_rescan=False)])
def test_host_paths_on_card_match_cpu(engines, search):
    eng, cpu, feats, lens = engines
    saved = (eng.search_cfg, cpu.search_cfg)
    eng.search_cfg = dataclasses.replace(saved[0], **search)
    cpu.search_cfg = dataclasses.replace(saved[1], **search)
    try:
        got = eng.decode_features(feats, lens)
        want = cpu.decode_features(feats, lens)
    finally:
        eng.search_cfg, cpu.search_cfg = saved
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)


# ---- the tied-triphone configuration and the waveform front end

LVCSR = dict(n_words=400, hidden=256, n_layers=2)


@pytest.fixture(scope="module")
def lvcsr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, protos = synth.lvcsr_engine(device="cuda", **LVCSR)
    cpu, _ = synth.lvcsr_engine(device="cpu", **LVCSR)
    truths, wins, lens = synth.make_lvcsr_utts(cpu, protos, 4, 120, 11,
                                               min_words=3, max_words=6,
                                               seed=11)
    feats = np.zeros((4, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, cpu, feats, np.asarray(lens, np.int32)


@pytest.mark.parametrize("scheme,nbest", [("max", 1), ("avg", 3),
                                          ("best", 3)])
def test_aggregate_pseudo_on_card_matches_cpu(lvcsr, scheme, nbest):
    from julius_tpu_torch.ops.gmm import aggregate_pseudo
    _, cpu, _, _ = lvcsr
    mem, seg, nq = cpu._pseudo
    rng = np.random.default_rng(nbest)
    rows = rng.integers(-6, 0, (3, 50, cpu.hmm.n_states)).astype(np.float32)
    rows[rng.random(rows.shape) < 0.3] = -1e10
    want = aggregate_pseudo(mem, seg, nq, torch.from_numpy(rows), scheme,
                            nbest)
    got = aggregate_pseudo(mem.cuda(), seg.cuda(), nq,
                           torch.from_numpy(rows).cuda(), scheme, nbest)
    if scheme == "avg":
        assert float((got.cpu() - want).abs().max()) <= 1e-5
    else:
        assert torch.equal(got.cpu(), want)


def test_strict_scan_kernel_matches_plain(lvcsr, monkeypatch):
    """One windowed round with head substitution on the card: the kernel
    against the plain scan, and against the CPU."""
    from julius_tpu_torch.search import scan as tscan
    eng, cpu, feats, lens = lvcsr
    tt = eng.iwcd2_tables
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats).cuda())
    B, T, R = out.shape
    CAP, K, W, A = 48, 40, 64, 6
    rng = np.random.default_rng(3)
    g0 = rng.integers(-300, -100, (CAP, T)).astype(np.float32)
    b0 = rng.integers(0, T, (CAP, T)).astype(np.int32)
    ints = np.zeros((K, 6 + A), np.int32)
    ints[:, 0] = rng.integers(0, eng.voca.n_words, K)
    ints[:, 1] = rng.integers(-1, CAP, K)
    ints[:, 2] = rng.integers(0, B, K)
    ints[:, 3] = rng.permutation(CAP)[:K]              # distinct rows
    ints[:, 4] = rng.integers(0, T - W + 1, K)
    ints[:, 5] = rng.integers(0, tt.head_sidx.shape[1], K)
    ints[:, 6:] = ints[:, 4:5] + rng.integers(0, W, (K, A))
    lm = rng.integers(-20, 0, K).astype(np.float32)

    def run(dev, tabs, heads):
        """Anchor values and the updated stores (with the sink row)."""
        g = torch.from_numpy(np.concatenate([g0, np.zeros((1, T),
                                                          np.float32)]))
        b = torch.from_numpy(np.concatenate([b0, np.zeros((1, T),
                                                          np.int32)]))
        g, b = g.to(dev), b.to(dev)
        res = tscan.scan_words_store_win(
            g, b, tabs, torch.from_numpy(ints).to(dev),
            torch.from_numpy(lm).to(dev), out.to(dev), W,
            head_sidx=heads.head_sidx, head_ns=heads.head_ns)
        return [a.cpu() for a in (*res, g, b)]

    before = tsk.LAUNCHES
    got = run("cuda", eng.device_chains, tt)
    assert tsk.LAUNCHES == before + 1
    cpu_res = run("cpu", cpu.device_chains, cpu.iwcd2_tables)
    monkeypatch.setattr(tscan, "scan_core_win", tsk.scan_core_win_plain)
    plain = run("cuda", eng.device_chains, tt)
    for want in (plain, cpu_res):
        for a, b in zip(got, want):
            if a.dtype.is_floating_point:
                assert float((a - b).abs().max()) <= 1e-5
            else:
                assert torch.equal(a, b)


def test_lvcsr_decode_on_card_matches_cpu(lvcsr):
    eng, cpu, feats, lens = lvcsr
    before = tsk.LAUNCHES
    got = eng.decode_features(feats, lens)
    assert tsk.LAUNCHES > before
    want = cpu.decode_features(feats, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want] \
        == [2, 2, 2, 2]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)


def test_front_end_on_card_matches_cpu(engines):
    from julius_tpu_torch.config import FrontendConfig
    from julius_tpu_torch.frontend import mfcc as tfe
    eng, cpu, _, _ = engines
    rng = np.random.default_rng(9)
    lens = np.asarray([16000, 9000, 300], np.int32)
    wave = np.zeros((3, 16000), np.float32)
    for b, n in enumerate(lens):
        wave[b, :n] = 2000.0 * rng.standard_normal(n)
    spec = (150.0 * np.abs(rng.standard_normal(257))).astype(np.float32)
    for noise in (None, spec):
        eng.set_noise_spectrum(noise)
        cpu.set_noise_spectrum(noise)
        got, gmask = eng._features(torch.from_numpy(wave).cuda(),
                                   torch.from_numpy(lens).cuda())
        want, wmask = cpu._features(torch.from_numpy(wave),
                                    torch.from_numpy(lens))
        assert torch.equal(gmask.cpu(), wmask)
        assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4)
    eng.set_noise_spectrum(None)
    cpu.set_noise_spectrum(None)
    feats, mask = tfe.extract_features(
        torch.from_numpy(wave).cuda(), torch.from_numpy(lens).cuda(),
        tfe.build_tables(FrontendConfig()))
    assert mask.sum(dim=1).tolist() == [98, 54, 0]
    got = eng.recognize_batch(wave, lens)
    want = cpu.recognize_batch(wave, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.valid for r in got] == [True, True, False]


@pytest.fixture(scope="module")
def gmm_task(tmp_path_factory):
    """A small GMM-HMM task written as the command line's files."""
    d = tmp_path_factory.mktemp("gmm_task")
    truths, files = synth.write_gmm_task(
        str(d), n_utts=2, n_words=60, n_phones=24, dim=39, n_mix=4,
        min_words=2, max_words=4)
    return truths, files


@pytest.mark.parametrize("topk,gms", [(0, False), (2, False), (0, True)])
def test_gmm_scorer_on_card_matches_cpu(cuda, gmm_task, topk, gms):
    """gauss_scores / senone_scores (and GMS) on the card against the
    CPU: TF32 off, so within atol 1e-3 (products of 39-wide frames
    summed in another order)."""
    from julius_tpu_torch.io.binhmm import read_binhmm
    from julius_tpu_torch.ops import gmm as tgmm
    from julius_tpu_torch.ops import gms as tgms
    _, files = gmm_task
    hmm = read_binhmm(files["am"])[0]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 40, 39)).astype(np.float32)) + torch.from_numpy(hmm.means[:40])
    out = {}
    for dev in ("cpu", "cuda"):
        tabs = tgmm.build_gmm_tables(hmm, device=dev)
        xd = x.to(dev)
        if gms:
            sel = tgms.build_gms(hmm, read_binhmm(files["gs"])[0], 8,
                                 device=dev)
            out[dev] = tgms.gms_senone_scores(tabs, sel, xd, topk=topk)
        else:
            out[dev] = tgmm.senone_scores(tabs, xd, topk=topk)
        out[dev + "_g"] = tgmm.gauss_scores(tabs, xd)
    for key in ("cuda", "cuda_g"):
        got, want = out[key].cpu(), out[key.replace("cuda", "cpu")]
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-3


def test_cli_on_card_matches_cpu(cuda, gmm_task):
    """The command line on two feature files on the card and on the
    CPU: the same sentences, scores within 1e-2."""
    import contextlib
    import io

    from julius_tpu_torch.tools import recognize
    truths, files = gmm_task
    argv = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"],
            "-input", "mfcfile", "-batchsize", "2"] + files["utts"]
    out = {}
    for dev in ("cuda", "cpu"):
        before = tpk.LAUNCHES
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert recognize.main(argv, device=dev) == 0
        if dev == "cuda":
            assert tpk.LAUNCHES > before
        out[dev] = buf.getvalue().splitlines()
    sent = [[ln for ln in out[d] if ln.startswith("sentence1")]
            for d in out]
    assert sent[0] == sent[1] == [
        "sentence1: " + " ".join(w for w in t if w not in ("<s>", "</s>"))
        for t in truths]
    scores = [[float(ln.split()[1]) for ln in out[d]
               if ln.startswith("score1")] for d in out]
    np.testing.assert_allclose(scores[0], scores[1], rtol=0, atol=1e-2)


def test_tf32_on_keeps_full_f32_products(cuda, gmm_task, engines):
    """A caller that turns TF32 on (the global precision and the matmul
    flag) still gets full-f32 Gaussian scores and features: the card
    within 1e-4 of the CPU, the caller's setting left as it was."""
    from julius_tpu_torch.io.binhmm import read_binhmm
    from julius_tpu_torch.ops import gmm as tgmm
    eng, cpu, _, _ = engines
    hmm = read_binhmm(gmm_task[1]["am"])[0]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 60, 39)).astype(np.float32)) + torch.from_numpy(hmm.means[:60])
    rng = np.random.default_rng(8)
    wave = (2000.0 * rng.standard_normal((2, 16000))).astype(np.float32)
    lens = torch.tensor([16000, 12000])
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        got = tgmm.gauss_scores(tgmm.build_gmm_tables(hmm, device="cuda"),
                                x.cuda()).cpu()
        feats, _ = eng._features(torch.from_numpy(wave).cuda(), lens.cuda())
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    want = tgmm.gauss_scores(tgmm.build_gmm_tables(hmm, device="cpu"), x)
    assert float((got - want).abs().max()) <= 1e-4
    want_f, _ = cpu._features(torch.from_numpy(wave), lens)
    assert torch.allclose(feats.cpu(), want_f, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(factoring=2, expand_k=16),
                                dict(beam_width=150.0),
                                dict(crossword=False)],
                         ids=["factoring2", "envelope", "isolated"])
def test_unfused_pass1_on_card_matches_cpu(engines, kw):
    """Pass 1's unfused step on the card against the CPU on the same
    outprob rows; the beam-update kernel is never launched."""
    eng, cpu, feats, lens = engines
    with torch.no_grad():
        out = cpu._outprob(torch.from_numpy(feats))
    cfg = dataclasses.replace(eng.p1_cfg, **kw)
    assert not tp1.fused_ok(eng.dev_net, cfg)
    before = tpk.LAUNCHES
    got = tp1.pass1_batch(eng.dev_net, eng.ngram_dev, cfg, out.cuda(),
                          torch.from_numpy(lens))
    torch.cuda.synchronize()
    assert tpk.LAUNCHES == before
    want = tp1.pass1_batch(cpu.dev_net, cpu.ngram_dev, cfg, out,
                           torch.from_numpy(lens))
    assert torch.equal(got.word.cpu(), want.word)
    valid = want.word >= 0
    for name in tp1.Trellis._fields:
        a, b = getattr(got, name).cpu(), getattr(want, name)
        if a.dtype.is_floating_point:
            assert float(torch.where(valid, (a - b).abs(), 0.0).max()) \
                <= 1e-5
        else:
            assert torch.equal(torch.where(valid, a, 0),
                               torch.where(valid, b, 0))


def test_gather_topology_on_card_matches_cpu(cuda):
    """A network with backward in-word arcs takes the incoming-arc
    gather: decodes on the card equal the CPU's (the frozen pass 2, as
    the chain scan cannot take such arcs)."""
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    hmm = synth.make_hmmset(n_phones=24, dim=8, seed=4)
    hmm.phone_trans[:, 3, 2] = np.log(0.1)
    voca = synth.make_vocabulary(hmm, n_words=60, seed=5)
    lm = synth.make_ngram(voca, seed=6)
    search = SearchConfig(trellis_topm=16, lm_weight=4.0)
    engs = [Engine(hmm, voca, lm, search=search, device=d)
            for d in ("cuda", "cpu")]
    assert engs[0].dev_net.local_k < 0 and not engs[0]._rescan_ok()
    rows = np.random.default_rng(7).normal(
        -8.0, 3.0, (3, 70, hmm.n_states)).astype(np.float32)
    lens = np.asarray([70, 52, 31], np.int32)
    got, want = (e.decode_outprob(rows, lens) for e in engs)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-3)


def test_grammar_decode_on_card_matches_cpu(engines):
    """A grammar over the small flagship vocabulary: the default pass 2
    (the host re-scan, whose word scans launch the scan kernel) and the
    frozen DFA search on the card against the CPU; every result is
    accepted by the automaton."""
    from julius_tpu_torch import grammar
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.search import pass2_rescan as tp2r
    eng, cpu, _, _ = engines
    gtext, vtext = synth.make_grammar(eng.voca, n_cats=8)
    rev, fwd, voca, wc, _ = grammar.compile_grammar(gtext, vtext)
    wc = np.asarray(wc, np.int32)
    seqs = synth.grammar_sentences(fwd, wc, 3, seed=2)
    protos = synth.trained_dnn_weights(
        eng.hmm.n_states, 1320, 120, 11, SMALL["hidden"],
        SMALL["n_layers"], 3)[4]
    wins, lens = synth.make_word_utts(eng.hmm, voca, protos, seqs, 120, 11)
    feats = np.zeros((3, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    lens = np.asarray(lens, np.int32)
    for rescan in (True, False):
        search = dataclasses.replace(eng.search_cfg, pass2_rescan=rescan)
        res = {}
        for e in (eng, cpu):
            g = Engine(e.hmm, voca, dnn=e.dnn_params, frontend=e.fe_cfg,
                       search=search, dfa=rev, word_cat=wc,
                       device=e.device)
            before = (tsk.LAUNCHES, tp2r.CHUNKS)
            res[e.device.type] = g.decode_features(feats, lens)
            if e is eng and rescan:
                assert tsk.LAUNCHES - before[0] == \
                    tp2r.CHUNKS - before[1] > 0
        got, want = res["cuda"], res["cpu"]
        assert [r.word_ids for r in got] == [r.word_ids for r in want]
        assert [r.from_pass for r in got] == [r.from_pass for r in want]
        for g, w in zip(got, want):
            assert g.score == pytest.approx(w.score, abs=1e-2)
            assert rev.accepts_forward([int(wc[x]) for x in g.word_ids])
        assert [r.word_ids for r in got] == seqs


def test_stream_on_card_matches_batch(engines):
    """A stream with no VAD, fed in 100 ms chunks in 16-frame blocks on
    the card: the words of recognize_batch on the card, the stream on
    the CPU's words, and its pass 2 launches the scan kernel."""
    from julius_tpu_torch.streaming import StreamSession
    eng, cpu, _, _ = engines
    wave = (np.random.default_rng(12).standard_normal(32000) * 2000) \
        .astype(np.float32)
    batch = eng.recognize_batch(wave[None], np.asarray([len(wave)]))[0]
    got = {}
    for e in (eng, cpu):
        before = tsk.LAUNCHES
        sess = StreamSession(e, use_vad=False, block_frames=16)
        res = []
        for ofs in range(0, len(wave), 1600):
            res.extend(sess.feed(wave[ofs:ofs + 1600]))
        res.extend(sess.close())
        got[e.device.type] = res, tsk.LAUNCHES - before
    (card, scans), (host, _) = got["cuda"], got["cpu"]
    assert len(card) == 1 and scans > 0
    assert card[0].words == batch.words == host[0].words
    assert card[0].score == pytest.approx(batch.score, abs=0.5)
    assert card[0].score == pytest.approx(host[0].score, abs=1e-2)


def test_viterbi_chain_on_card_matches_cpu(engines):
    """The alignment Viterbi on the card against the CPU on the same
    outprob rows, and whole alignments of each utterance."""
    from julius_tpu_torch.search import align as talign
    eng, cpu, feats, lens = engines
    res = eng.decode_features(feats, lens)
    for b, r in enumerate(res):
        chain = talign.build_chain(eng.hmm, eng.voca, r.word_ids,
                                   pseudo=eng.net.pseudo)
        out = eng._outprob(torch.from_numpy(feats[b:b + 1]).cuda())[0]
        for n in (int(lens[b]), int(lens[b]) - 5):
            gs, gbp, gbest = talign.viterbi_chain(
                *talign.chain_tensors(chain, "cuda"), out, n)
            ws, wbp, wbest = talign.viterbi_chain(
                *talign.chain_tensors(chain, "cpu"), out.cpu(), n)
            assert torch.equal(gbp.cpu(), wbp) and int(gbest) == int(wbest)
            assert float(gs) == pytest.approx(float(ws), abs=1e-3)
        got = eng.align(feats[b], int(lens[b]), r.word_ids)
        want = cpu.align(feats[b], int(lens[b]), r.word_ids)
        assert (got.words, got.phones, got.states) == \
            (want.words, want.phones, want.states)


@pytest.fixture
def count_replays(monkeypatch):
    """-> a list that gets one entry a CUDA graph replay."""
    replays = []
    real = torch.cuda.CUDAGraph.replay

    def replay(self):
        replays.append(1)
        return real(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    return replays


def test_stream_graph_equals_eager_oracle(engines, count_replays,
                                          monkeypatch):
    """Two sessions of a 10 s stream (16-frame blocks, 100 ms feeds, no
    VAD) on the card: one capture for both; one graph replay a chunk
    row; every chunk's atoms and state, its short last chunk included,
    bit-equal to the eager oracle on the same inputs."""
    from julius_tpu_torch.streaming import StreamSession
    eng, _, _, _ = engines
    cache = eng.dev_net.graphs
    for key in [k for k in cache.entries if k[0] == "stream"]:
        del cache.entries[key]
    calls = []
    real = tp1.pass1_stream_chunk

    def chunk(*a):
        n0 = len(count_replays)
        out = real(*a)
        calls.append((a, out, len(count_replays) - n0))
        return out

    monkeypatch.setattr(tp1, "pass1_stream_chunk", chunk)
    rng = np.random.default_rng(13)
    captures = cache.captures
    for seconds in (10.0, 9.97):
        wave = (rng.standard_normal(int(seconds * 16000)) * 2000) \
            .astype(np.float32)
        sess = StreamSession(eng, use_vad=False, block_frames=16)
        res = []
        for ofs in range(0, len(wave), 1600):
            res.extend(sess.feed(wave[ofs:ofs + 1600]))
        res.extend(sess.close())
        assert len(res) == 1 and res[0].valid
    assert cache.captures == captures + 1
    assert all(n == a[4].shape[0] for a, _, n in calls)   # one a row
    assert any(a[5] < a[4].shape[0] for a, _, _ in calls)  # a short chunk
    assert {a[4].shape[0] for a, _, _ in calls} == {15, 16}
    del count_replays[:]
    for a, (state, atoms), _ in calls:
        want_state, want_atoms = real(*a, eager=True)
        assert all(torch.equal(x, y) for x, y in zip(state, want_state))
        assert all(torch.equal(x, y) for x, y in zip(atoms, want_atoms))
        assert state.t.is_cuda and want_state.t.shape == (1,)
    assert not count_replays


def test_align_graph_equals_eager_and_cpu(engines, count_replays):
    """Alignments of each decoded utterance on the card through the
    engine's graphs: no more captures than buckets, none on a second
    pass; one replay a frame; the Viterbi bit-equal to its eager oracle
    on the card and equal to the CPU's."""
    from julius_tpu_torch.search import align as talign
    eng, cpu, feats, lens = engines
    res = eng.decode_features(feats, lens)
    eng.align_graphs = None
    chains, buckets = [], set()
    for b, r in enumerate(res):
        chain = talign.build_chain(eng.hmm, eng.voca, r.word_ids,
                                   pseudo=eng.net.pseudo)
        out = eng._outprob(torch.from_numpy(feats[b:b + 1]).cuda())[0]
        for n in (int(lens[b]), int(lens[b]) - 5):
            chains.append((chain, out, n))
            buckets.add((talign.buckets(len(chain.score_idx),
                                        out.shape[0]),
                         chain.in_src.shape[1]))
    for rnd in range(2):
        for b, r in enumerate(res):
            got = eng.align(feats[b], int(lens[b]), r.word_ids)
            want = cpu.align(feats[b], int(lens[b]), r.word_ids)
            assert (got.words, got.phones, got.states) == \
                (want.words, want.phones, want.states)
        if rnd == 0:
            captures = eng.align_graphs.captures
            assert 1 <= captures <= len(buckets)
    assert eng.align_graphs.captures == captures
    steps = 0
    for chain, out, n in chains:
        del count_replays[:]
        gs, gbp, gbest = talign.viterbi_chain(
            *talign.chain_tensors(chain, "cuda"), out, n,
            graphs=eng.align_graphs)
        assert len(count_replays) == min(out.shape[0], n) - 1
        steps += len(count_replays)
        es, ebp, ebest = talign.viterbi_chain(
            *talign.chain_tensors(chain, "cuda"), out, n, eager=True)
        ws, wbp, wbest = talign.viterbi_chain(
            *talign.chain_tensors(chain, "cpu"), out.cpu(), n)
        assert torch.equal(gbp, ebp) and torch.equal(gs, es)
        assert int(gbest) == int(ebest) == int(wbest)
        assert torch.equal(gbp.cpu(), wbp)
        assert float(gs) == pytest.approx(float(ws), abs=1e-3)
    assert steps > 0 and eng.align_graphs.captures == captures


def test_native_adin_builds_into_the_package(cuda):
    """The native segmenter builds from the package's own source into
    julius_tpu_torch/_build/ and segments like the Python one."""
    from julius_tpu_torch.adin import native_wrapper as nw
    from julius_tpu_torch.frontend import stream as tst
    assert nw.native_available()
    so = nw.library_path()
    assert so.exists() and so.parent == nw.BUILD_DIR
    assert so.parent.name == "_build" and \
        so.parent.parent.name == "julius_tpu_torch"
    cfg = tst.VADConfig(level=1000, zc_thres=30, head_margin_ms=50,
                        tail_margin_ms=100)
    tone = (8000 * np.sin(2 * np.pi * 300 * np.arange(16000) / 16000)) \
        .astype(np.float32)
    quiet = np.zeros(8000, np.float32)
    kinds = []
    for det in (nw.NativeSpeechDetector(cfg), tst.SpeechDetector(cfg)):
        evs = []
        for c in (quiet, tone, quiet, quiet):
            evs.extend(e["type"] for e in det.feed(c)
                       if e["type"] != "samples")
        kinds.append(evs)
    assert kinds[0] == kinds[1] == ["start", "end"]


class _PortWatch:
    """A log stream that picks serve()'s "module port X, adinnet port Y"
    line out of the log."""

    def __init__(self):
        import queue
        self.ports = queue.Queue()

    def write(self, s):
        import re
        m = re.search(r"module port (\d+), adinnet port (\d+)", s)
        if m:
            self.ports.put((int(m.group(1)), int(m.group(2))))
        return len(s)

    def flush(self):
        pass


def _read_msg(f):
    """One module message (lines until a single '.')."""
    lines = []
    while True:
        line = f.readline()
        if not line:
            return None
        if line.strip() == b".":
            return b"\n".join(lines).decode()
        lines.append(line.rstrip(b"\n"))


def test_server_entry_points_need_cuda_unless_cpu_is_asked(
        cuda, tmp_path, monkeypatch):
    """serve.main and adintool.main raise without CUDA; adintool runs on
    the CPU when asked."""
    import contextlib
    import io

    from fixtures import make_arpa_text, make_dict_text, make_hmmdefs_text
    from julius_tpu_torch.io.wav import write_wav
    from julius_tpu_torch.tools import adintool, serve
    (tmp_path / "am.hmm").write_text(make_hmmdefs_text(dim=26))
    (tmp_path / "words.dict").write_text(make_dict_text())
    (tmp_path / "lm.arpa").write_text(make_arpa_text())
    rng = np.random.default_rng(2)
    wave = np.concatenate([rng.standard_normal(8000) * 30,
                           rng.standard_normal(16000) * 3000,
                           rng.standard_normal(8000) * 30])
    write_wav(str(tmp_path / "in.wav"), wave.astype(np.float32), 16000)
    tool = ["-in", "file", "-filename", str(tmp_path / "in.wav"), "-out",
            "file", "-filename-out", str(tmp_path / "seg")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["-h", str(tmp_path / "am.hmm"), "-v",
                    str(tmp_path / "words.dict"), "-d",
                    str(tmp_path / "lm.arpa")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adintool.main(tool)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert adintool.main(tool, device="cpu") == 0
    assert out.getvalue().startswith("wrote ")


def test_server_on_card_answers_an_adinnet_segment(engines):
    """serve() on the card engine: one noise segment over adinnet gives
    a <RECOGOUT> with the words of recognize_batch on the same samples,
    and the segment's pass 2 launches the scan kernel."""
    import importlib
    import socket
    import threading

    from julius_tpu_torch.server.adinnet import AdinnetClient
    from julius_tpu_torch.tools.serve import serve
    jlog = importlib.import_module("julius_tpu_torch.utils.jlog")
    eng = engines[0]
    wave = (np.random.default_rng(13).standard_normal(24000) * 2000) \
        .astype(np.float32)
    batch = eng.recognize_batch(wave[None], np.asarray([len(wave)]))[0]
    watch, box = _PortWatch(), {}
    jlog.set_log_output(watch)
    t = threading.Thread(target=lambda: box.update(mod=serve(
        [eng], module_port=0, adin_port=0)), daemon=True)
    try:
        t.start()
        mport, aport = watch.ports.get(timeout=60)
    finally:
        jlog.set_log_output(jlog.DEFAULT)
    ctl = socket.create_connection(("127.0.0.1", mport))
    f = ctl.makefile("rb")
    cli = AdinnetClient(port=aport)
    before = tsk.LAUNCHES
    cli.send_samples(wave)
    cli.send_segment_end()
    msg = _read_msg(f)
    cli.close()
    t.join(timeout=60)
    assert not t.is_alive()
    ctl.sendall(b"DIE\n")
    f.close()
    ctl.close()
    box["mod"]._srv.close()
    assert tsk.LAUNCHES > before
    first = msg.split("</SHYPO>")[0]
    import re
    assert re.findall(r'CLASSID="([^"]*)"', first) == batch.words


def test_changegram_rebuild_keeps_the_engine_device(engines):
    """CHANGEGRAM builds the new grammar engine from the command loop's
    thread on the old engine's card; it decodes there like the same
    engine built on the CPU."""
    import io
    import socket
    import threading

    from julius_tpu_torch import grammar
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.server.module import ModuleServer
    eng, cpu, _, _ = engines
    gtext, vtext = synth.make_grammar(eng.voca, n_cats=8)
    rev, fwd, voca, wc, _ = grammar.compile_grammar(gtext, vtext)
    wc = np.asarray(wc, np.int32)
    start = Engine(eng.hmm, voca, dfa=rev, word_cat=wc, frontend=eng.fe_cfg,
                   search=eng.search_cfg, device=eng.device)
    dfa_text, dict_text = io.StringIO(), io.StringIO()
    grammar.write_dfa(rev, dfa_text)
    grammar.write_dict(voca, dict_text)
    srv = ModuleServer([start], port=0)
    t = threading.Thread(target=lambda: (srv.accept(), srv.serve_forever()),
                         daemon=True)
    t.start()
    sock = socket.create_connection(("127.0.0.1", srv.port))
    f = sock.makefile("rb")
    sock.sendall(("CHANGEGRAM g\n" + dfa_text.getvalue()
                  + dict_text.getvalue() + "DICEND\n").encode())
    msg = _read_msg(f)
    new = srv.engines[0]
    sock.sendall(b"DIE\n")
    t.join(timeout=60)
    assert not t.is_alive()
    f.close()
    sock.close()
    srv._srv.close()
    assert msg == '<GRAMMAR STATUS="RECEIVED" ID="1"/>'
    assert new is not start and new.device == start.device
    assert new.dev_net.score_idx.is_cuda
    assert new.dev_net.score_idx.device == start.dev_net.score_idx.device
    # the rebuilt engine (GMM-scored: the rebuild passes no DNN) decodes
    # on the card like the same grammar engine on the CPU
    from fixtures import sample_states_and_frames
    seq = synth.grammar_sentences(fwd, wc, 1, seed=3)[0]
    pids = [eng.hmm.phone_index[p] for w in seq for p in voca.phones[w]]
    x, _ = sample_states_and_frames(eng.hmm, pids,
                                    np.random.default_rng(3))
    ref = Engine(cpu.hmm, new.voca, dfa=new.dfa, word_cat=new.word_cat,
                 frontend=cpu.fe_cfg, search=cpu.search_cfg, device="cpu")
    n = np.asarray([x.shape[0]])
    got = new.decode_features(x[None], n)[0]
    want = ref.decode_features(x[None], n)[0]
    assert got.word_ids == want.word_ids
    assert got.score == pytest.approx(want.score, abs=1e-2)


# ---- the backward N-gram, the full-utterance scan and parallel/


def pair_engines(cpu, lm, **kw):
    """The small flagship's model with `lm` on the card and on the CPU."""
    from julius_tpu_torch.engine import Engine
    args = dict(dnn=cpu.dnn_params, frontend=cpu.fe_cfg,
                search=cpu.search_cfg, **kw)
    return (Engine(cpu.hmm, cpu.voca, lm, device="cuda", **args),
            Engine(cpu.hmm, cpu.voca, lm, device="cpu", **args))


def test_backward_pair_on_card_matches_cpu(engines):
    """Pass 1 on the forward 2-gram launches the beam-update kernel a
    frame; the frozen backward search launches no scan."""
    _, cpu, feats, lens = engines
    card, host = pair_engines(cpu, synth.backward_ngram(cpu.lm),
                              lm_forward=cpu.lm)
    before = tpk.LAUNCHES, tsk.LAUNCHES
    got = card.decode_features(feats, lens)
    assert tpk.LAUNCHES - before[0] == feats.shape[1]
    assert tsk.LAUNCHES == before[1]
    want = host.decode_features(feats, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert all(r.from_pass == 2 for r in got)
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)


def test_user_lm_on_card_matches_cpu(engines):
    _, cpu, feats, lens = engines
    card, host = pair_engines(cpu, cpu.lm)
    for e in (card, host):
        e.register_user_lm(lambda ctx, w: cpu.lm.logprob(tuple(ctx[-1:]), w))
    before = tsk.LAUNCHES
    got = card.decode_features(feats, lens)
    assert tsk.LAUNCHES > before
    want = host.decode_features(feats, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]


def test_full_scan_on_card_matches_plain(engines):
    from julius_tpu_torch.search import scan as tscan
    eng, cpu, feats, lens = engines
    rng = np.random.default_rng(3)
    wids = rng.integers(-1, eng.voca.n_words, 40)
    rows = eng.chain_cache.rows(wids.tolist())
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats).cuda())
    B, T, _ = out.shape
    seed = rng.integers(-60, -20, (40, T)).astype(np.float32)
    seed[rng.random((40, T)) < 0.6] = -1e10
    bidx = rng.integers(0, B, 40).astype(np.int32)
    host = [torch.from_numpy(a) for a in (*rows, seed, bidx)]
    before = tsk.LAUNCHES
    g, beg = tscan.scan_words(*[a.cuda() for a in host], out)
    assert tsk.LAUNCHES == before + 1
    wg, wbeg = tscan.scan_words(*host, out.cpu())
    assert torch.equal(g.cpu(), wg) and torch.equal(beg.cpu(), wbeg)
    tabs, ctabs = eng.device_chains, cpu.device_chains
    cap = 48
    g0 = rng.integers(-90, -30, (cap, T)).astype(np.float32)
    b0 = rng.integers(0, T, (cap, T)).astype(np.int32)
    ints = [np.where(wids >= 0, wids, -1), rng.integers(-1, cap, 40),
            rng.integers(-20, 0, 40).astype(np.float32), bidx,
            rng.permutation(cap + 4)[:40], rng.integers(-2, T + 3, (40, 6))]
    got = tscan.scan_words_store(
        torch.tensor(g0, device="cuda"), torch.tensor(b0, device="cuda"),
        tabs.loc, tabs.ent, tabs.ext, tabs.sidx,
        *[torch.tensor(a, device="cuda") for a in ints], out)
    want = tscan.scan_words_store(
        torch.tensor(g0), torch.tensor(b0), ctabs.loc, ctabs.ent, ctabs.ext,
        ctabs.sidx, *[torch.tensor(a) for a in ints], out.cpu())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().nan_to_num(), b.nan_to_num())


def test_scan_kernel_limits_raise(cuda):
    """Chains the kernel cannot hold raise instead of being cut."""
    from julius_tpu_torch.search import scan as tscan
    f, i = torch.float32, torch.int32
    out = torch.zeros(1, 8, 4, device=cuda)
    for K1, N in ((tsk.MAX_K1 + 1, 4), (2, tsk.MAX_NODES + 1)):
        loc = torch.zeros(2, K1, N, device=cuda)
        node = torch.zeros(2, N, device=cuda)
        with pytest.raises(ValueError, match="shifts|nodes"):
            tscan.scan_words(loc, node, node, node.to(i),
                             torch.zeros(2, 8, dtype=f, device=cuda),
                             torch.zeros(2, dtype=i, device=cuda), out)


def test_parallel_on_card_matches_one_device(engines):
    from julius_tpu_torch.parallel import mesh as pm
    from julius_tpu_torch.parallel import sharded_pass1 as sp
    eng, cpu, feats, lens = engines
    n = int(lens[0])
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats[:1]).cuda())[0, :n]
    trs = {}
    for S, dev, e in ((1, "cuda", eng), (2, "cuda", eng), (2, "cpu", cpu)):
        trs[S, dev] = sp.sharded_pass1(
            pm.make_mesh(devices=[dev] * S, tp=S),
            sp.partition_network(e.net, e.dev_net, S), e.ngram_dev,
            e.p1_cfg, out.to(dev), n)
    for key in ((2, "cuda"), (2, "cpu")):
        for a, b in zip(trs[key], trs[1, "cuda"]):
            assert torch.equal(a.cpu(), b.cpu())
    rng = np.random.default_rng(4)
    wave = (rng.standard_normal((4, 16000)) * 1000).astype(np.float32)
    lengths = np.asarray([16000, 12000, 16000, 9000], np.int32)
    before = tpk.LAUNCHES
    tr, nfr = pm.parallel_decode_fn(
        eng, pm.make_mesh(devices=["cuda"] * 2))(wave, lengths)
    assert tpk.LAUNCHES == before
    with torch.no_grad():
        fw, mask = eng._features(torch.from_numpy(wave).cuda(),
                                 torch.from_numpy(lengths).cuda())
        own = tp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                              eng._outprob(fw), mask.sum(-1),
                              use_kernel=False)
    for a, b in zip(tr, own):
        assert torch.equal(a, b)
    pm.shard_engine(eng, pm.make_mesh(devices=["cuda"] * 2, tp=2))
    x = torch.from_numpy(feats[:2]).cuda()
    with torch.no_grad():
        err = (eng.mesh_replicas[0]._outprob(x) - eng._outprob(x)).abs()
    assert float(err.max()) <= 2e-2



def sharded_case(eng, S, devices=None):
    """(mesh, sharded network) for S shards of `eng` on one mesh row."""
    from julius_tpu_torch.parallel import mesh as pm
    from julius_tpu_torch.parallel import sharded_pass1 as sp
    return (pm.make_mesh(devices=devices or [eng.device] * S, tp=S),
            sp.partition_network(eng.net, eng.dev_net, S))


def sharded_run(eng, case, out, n, **kw):
    from julius_tpu_torch.parallel import sharded_pass1 as sp
    tr = sp.sharded_pass1(*case, eng.ngram_dev, eng.p1_cfg, out, n, **kw)
    return tp1.Trellis(*[a.cpu() for a in tr])


def same_trellis(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_graph_equals_eager_and_cpu(engines, count_replays, S):
    """sharded_pass1 on a mesh that repeats the card, with n_frames = T
    and n_frames < T (the rows past it real frames): all six trellis
    fields equal to the eager oracle's and the CPU's; one capture (one
    graph) for the key, none on later calls, one replay a frame; no
    pass1_step launch."""
    eng, cpu, feats, _ = engines
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats[:1]).cuda())[0]
    T = out.shape[0]
    case, cpu_case = sharded_case(eng, S), sharded_case(cpu, S)
    before = tpk.LAUNCHES
    for i, n in enumerate((T, 2 * T // 3)):
        del count_replays[:]
        got = [sharded_run(eng, case, out, n) for _ in range(2)]
        assert len(count_replays) == 2 * T - (i == 0)
        want = sharded_run(eng, case, out, n, eager=True)
        on_cpu = sharded_run(cpu, cpu_case, out.cpu(), n)
        for g in got:
            assert same_trellis(g, want) and same_trellis(g, on_cpu)
        assert (want.word[n:] == -1).all()
    cache, = case[1].caches.graphs.values()
    assert cache.captures == 1 and len(cache.entries) == 1
    entry, = cache.entries.values()
    assert len(entry.graphs) == 1
    assert tpk.LAUNCHES == before


def test_sharded_graph_on_two_cards(engines, count_replays):
    """Shards alternating between cuda:0 and cuda:1: phase A's and phase
    C's graph on each card with the gather copied between the replays
    (four replays a frame), equal to the one-card row's trellis at
    n_frames = T and < T; one capture for the key, none after."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    eng, _, feats, _ = engines
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats[:1]).cuda())[0]
    T = out.shape[0]
    for S in (2, 4):
        case = sharded_case(eng, S, ["cuda:0", "cuda:1"] * (S // 2))
        one = sharded_case(eng, S)
        for i, n in enumerate((T, 2 * T // 3)):
            del count_replays[:]
            got = [sharded_run(eng, case, out, n) for _ in range(2)]
            assert len(count_replays) == 4 * (2 * T - (i == 0))
            want = sharded_run(eng, one, out, n)
            assert all(same_trellis(g, want) for g in got)
        caches = case[1].caches.graphs
        assert caches[torch.device("cuda:0")].captures == 1
        entry, = caches[torch.device("cuda:1")].entries.values()
        assert len(entry.graphs) == 4 and entry.loop.copies


def test_sharded_capture_that_syncs_raises(engines, monkeypatch):
    """A sharded frame step that synchronises with the host cannot be
    captured: sharded_pass1 raises, never runs the eager loop, keeps no
    graph, and captures once its step is sound."""
    from julius_tpu_torch.parallel import sharded_pass1 as sp
    eng, _, feats, lens = engines
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats[:1]).cuda())[0]
    n = int(lens[0])
    case = sharded_case(eng, 2)
    real = sp._local_candidates

    def syncing(sh, cfg, score, *a):
        float(score.max())                  # a host synchronisation
        return real(sh, cfg, score, *a)

    monkeypatch.setattr(sp, "_local_candidates", syncing)
    monkeypatch.setattr(sp, "_eager", None)
    with pytest.raises(RuntimeError):
        sharded_run(eng, case, out, n)
    cache, = case[1].caches.graphs.values()
    assert not cache.entries and cache.captures == 0
    monkeypatch.undo()
    got = sharded_run(eng, case, out, n)
    assert same_trellis(got, sharded_run(eng, case, out, n, eager=True))
    assert cache.captures == 1


# ---- pass 1's frame step as a CUDA graph


@pytest.fixture(scope="module")
def graph_cases(engines):
    """branch -> (network, N-gram, Pass1Config, use_kernel, [B, T, R]
    outprob rows on the card, [B] frame counts): the small flagship's
    kernel path and unfused N-gram step, factoring 2, the envelope,
    isolated words, a grammar over its words, and a topology with
    backward arcs (random rows)."""
    from julius_tpu_torch import grammar
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    eng, _, feats, lens = engines
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats).cuda())
    # frames past every utterance's end
    lens = np.minimum(lens, out.shape[1] - 3).astype(np.int32)
    cfg = eng.p1_cfg
    cases = {"fused": (eng.dev_net, eng.ngram_dev, cfg, True, out, lens),
             "ngram_unfused": (eng.dev_net, eng.ngram_dev, cfg, False, out,
                               lens)}
    for name, kw in (("factoring2", dict(factoring=2, expand_k=16)),
                     ("envelope", dict(beam_width=150.0)),
                     ("isolated", dict(crossword=False))):
        cases[name] = (eng.dev_net, eng.ngram_dev,
                       dataclasses.replace(cfg, **kw), True, out, lens)
    gtext, vtext = synth.make_grammar(eng.voca, n_cats=8)
    rev, _, voca, wc, _ = grammar.compile_grammar(gtext, vtext)
    g = Engine(eng.hmm, voca, dnn=eng.dnn_params, frontend=eng.fe_cfg,
               search=eng.search_cfg, dfa=rev,
               word_cat=np.asarray(wc, np.int32), device="cuda")
    cases["dfa"] = (g.dev_net, g.ngram_dev, g.p1_cfg, True, out, lens)
    hmm = synth.make_hmmset(n_phones=24, dim=8, seed=4)
    hmm.phone_trans[:, 3, 2] = np.log(0.1)
    voca = synth.make_vocabulary(hmm, n_words=60, seed=5)
    b = Engine(hmm, voca, synth.make_ngram(voca, seed=6),
               search=SearchConfig(trellis_topm=16, lm_weight=4.0),
               device="cuda")
    assert b.dev_net.local_k < 0
    rows = np.random.default_rng(7).normal(
        -8.0, 3.0, (3, 70, hmm.n_states)).astype(np.float32)
    cases["gather"] = (b.dev_net, b.ngram_dev, b.p1_cfg, True,
                       torch.from_numpy(rows).cuda(),
                       np.asarray([70, 52, 31], np.int32))
    return cases


def graph_run(case, out, lens, eager=False, dev=None):
    """pass1_batch on one graph case -> (trellis, kernel launches)."""
    net, ng, cfg, use_kernel = case[:4]
    before = tpk.LAUNCHES
    tr = tp1.pass1_batch(dev or net, ng, cfg, out,
                         torch.as_tensor(lens, device="cuda"),
                         use_kernel=use_kernel, eager=eager)
    torch.cuda.synchronize()
    return tr, tpk.LAUNCHES - before


def assert_same_trellis(a, b):
    for name, x, y in zip(tp1.Trellis._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("branch", ["fused", "ngram_unfused", "factoring2",
                                    "envelope", "isolated", "dfa",
                                    "gather"])
def test_pass1_graph_equals_eager_oracle(graph_cases, branch):
    """The graphed trellis is bit-equal to the eager loop's; a second
    batch of other lengths and values replays the same graphs and equals
    its own eager loop; the beam-update kernel's launches, counted on
    replays, are one a frame on the kernel path and none elsewhere, the
    word-end kernel's one a frame on every branch."""
    case = graph_cases[branch]
    net, _, cfg, use_kernel, out, lens = case
    T = out.shape[1]
    fused = use_kernel and tp1.fused_ok(net, cfg)
    assert fused == (branch == "fused")
    w0 = twe.LAUNCHES
    got, n = graph_run(case, out, lens)
    w_graphed = twe.LAUNCHES - w0
    want, n_eager = graph_run(case, out, lens, eager=True)
    assert_same_trellis(got, want)
    assert n == n_eager == (T if fused else 0)
    assert w_graphed == twe.LAUNCHES - w0 - w_graphed == T
    assert (want.word >= 0).sum() > 20
    captures = net.graphs.captures
    g = torch.Generator(device="cuda").manual_seed(1)
    out2 = out.flip(0) + torch.rand(out.shape, generator=g, device="cuda")
    lens2 = np.maximum(lens[::-1] - np.asarray([4, 0, 11]), 2)
    got2, n2 = graph_run(case, out2, lens2)
    assert net.graphs.captures == captures          # the same graph
    want2, _ = graph_run(case, out2, lens2, eager=True)
    assert_same_trellis(got2, want2)
    assert n2 == n
    assert not torch.equal(got2.score, got.score)


def test_pass1_graph_longer_batch_takes_a_new_capacity(graph_cases):
    case = graph_cases["fused"]
    net, out, lens = case[0], case[4], case[5]
    dev = dataclasses.replace(net)                  # a cache of its own
    T = out.shape[1]
    cap = max(tp1.MIN_T_BUCKET, 1 << (T - 1).bit_length())
    reps = cap // T + 1                             # cap < reps T <= 2 cap
    long = out.repeat(1, reps, 1)
    long_lens = lens * reps
    for o, n in ((out, lens), (long, long_lens), (out, lens)):
        got, launches = graph_run(case, o, n, dev=dev)
        want, _ = graph_run(case, o, n, eager=True, dev=dev)
        assert_same_trellis(got, want)
        assert launches == o.shape[1]
    assert dev.graphs.captures == 2
    assert sorted(k[-1] for k in dev.graphs.entries) == [cap, 2 * cap]


@pytest.fixture(scope="module")
def envr20k_like():
    """A 20k-word tied-triphone network at envr20k's size (299,718
    nodes, 299,720 on the kernel's padded axis, M = 128), its DNN
    small: pass 1 reads only the network."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, _ = synth.lvcsr_engine(device="cuda", hidden=128, n_layers=1)
    return eng


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["fused", "unfused"])
def test_pass1_graph_equals_eager_at_envr20k_size(envr20k_like, use_kernel):
    """B = 16 at envr20k's node count: batches of odd, even and odd T
    through one cache entry, each graphed trellis bit-equal to the eager
    loop's and one beam-update launch a frame on the kernel path."""
    eng = envr20k_like
    net = dataclasses.replace(eng.dev_net)          # a cache of its own
    assert tp1.fused_ok(net, eng.p1_cfg)
    assert tp1.kernel_tables(net)[0].shape[1] > 1 << 18
    case = (net, eng.ngram_dev, eng.p1_cfg, use_kernel)
    R = eng.hmm.n_states + eng._pseudo[2]
    g = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    for T in (37, 48, 33):
        rows = torch.randn((16, T, R), generator=g, device="cuda") * 3 - 8
        lens = rng.integers(T // 2, T + 1, 16).astype(np.int32)
        lens[0] = T
        got, n = graph_run(case, rows, lens)
        want, n_eager = graph_run(case, rows, lens, eager=True)
        assert_same_trellis(got, want)
        assert n == n_eager == (T if use_kernel else 0)
        assert (want.word >= 0).sum() > 100
    assert net.graphs.captures == 1


def test_stable_sort_captures(cuda):
    """torch.sort(stable=True), pass 1's top-k, inside a CUDA graph: ties
    to the lowest index, at a row wider than the in-register sort."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-40, 0, (16, 6000), generator=g, device=cuda).float()
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tp1.topk_stable(static, 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        vals, idx = tp1.topk_stable(static, 64)
    y = torch.randint(-40, 0, (16, 6000), generator=g, device=cuda).float()
    static.copy_(y)
    graph.replay()
    want = tp1.topk_stable(y.cpu(), 64)
    assert torch.equal(vals.cpu(), want[0])
    assert torch.equal(idx.cpu(), want[1])


def test_pass1_capture_beside_an_allocating_thread(graph_cases):
    """Captures run from a second thread while this one allocates card
    memory of new sizes: the captures hold, the allocations do not fail,
    and each trellis equals the eager loop's."""
    import threading
    case = graph_cases["fused"]
    net, out, lens = case[0], case[4], case[5]
    devs = [dataclasses.replace(net) for _ in range(4)]
    got, errors = [], []
    done = threading.Event()

    def capture():
        try:
            for d in devs:
                got.append(graph_run(case, out, lens, dev=d)[0])
        except BaseException as e:          # reported by the main thread
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=capture)
    t.start()
    held, mb = [], 1
    while not done.is_set():
        held.append(torch.empty(mb << 20, dtype=torch.uint8, device="cuda"))
        mb = mb % 64 + 1
        if len(held) > 32:
            held.clear()
    t.join(timeout=300)
    assert not t.is_alive() and not errors
    want, _ = graph_run(case, out, lens, eager=True)
    for tr, d in zip(got, devs):
        assert_same_trellis(tr, want)
        assert d.graphs.captures == 1


def test_decode_on_second_card_from_a_thread_on_the_first(engines):
    """An engine on cuda:1 decoded from a thread whose current card is
    cuda:0: both kernels launch on the engine's card, and the results are
    the CPU's."""
    import threading
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _, cpu, feats, lens = engines
    eng, _ = synth.flagship_engine(trained=True, device="cuda:1", **SMALL)
    res, errors = [], []

    def decode():
        try:
            torch.cuda.set_device(0)
            before = (tpk.LAUNCHES, tsk.LAUNCHES)
            res.extend(eng.decode_features(feats, lens))
            res.append((tpk.LAUNCHES - before[0], tsk.LAUNCHES - before[1]))
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    t = threading.Thread(target=decode)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors
    launches = res.pop()
    assert launches[0] == feats.shape[1] and launches[1] > 0
    want = cpu.decode_features(feats, lens)
    assert [r.word_ids for r in res] == [r.word_ids for r in want]
    for g, w in zip(res, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)


# ---- the device A*'s round as a CUDA graph


def astar_case(eng, feats, lens):
    """run_batch's arguments for one engine's pass-1 lattices on the card,
    and its keywords."""
    with torch.no_grad():
        out = eng._outprob(torch.from_numpy(feats).cuda())
        tr = eng._pass1(out, lens)
    host = tp1.Trellis(*[a.cpu().numpy() for a in tr])
    lats = [tp2.TrellisLattice(tp1.Trellis(*[a[b] for a in host]), int(n))
            for b, n in enumerate(lens)]
    return ((lats, eng.device_chains, eng.ngram_dev, eng._wid2lm_p2,
             eng._cprob_arr(), out, eng._rescan_strategy(), eng.search_cfg),
            dict(iwcd2=eng.iwcd2_tables))


def astar_run(args, kw, eager=False):
    """run_batch -> (N-best lists as tuples, LAST_STATS, launches)."""
    before = tsk.LAUNCHES
    got = tp2d.run_batch(*args, **kw, eager=eager)
    torch.cuda.synchronize()
    return ([[dataclasses.astuple(r) for r in x] for x in got],
            dict(tp2d.LAST_STATS), tsk.LAUNCHES - before)


@pytest.mark.parametrize("which", ["flagship", "strict"])
def test_astar_graph_equals_eager_oracle(request, which):
    """The graphed A* is bit-equal to its eager loop (N-best ids, bounds,
    scores, rounds, pops), captured and then replayed from the cache;
    scan_win's launches, counted on replays, are one a round the card
    ran; the host waits at most ceil(rounds / G) + 1 times."""
    eng, _, feats, lens = request.getfixturevalue(
        "engines" if which == "flagship" else "lvcsr")
    args, kw = astar_case(eng, feats, lens)
    if which == "strict":
        assert eng.iwcd2_tables.n_resolved > 0
    cache = eng.device_chains.graphs
    cache.entries.clear()
    want, want_stats, n_eager = astar_run(args, kw, eager=True)
    rounds = want_stats["rounds"]
    assert n_eager == want_stats["replayed"] == rounds > 0
    assert not want_stats["graphed"]
    captures = cache.captures
    for first in (True, False):
        got, stats, n = astar_run(args, kw)
        assert got == want
        assert stats["graphed"] and stats["captured"] == int(first)
        assert stats["rounds"] == rounds
        assert stats["n_pops"] == want_stats["n_pops"]
        G = stats["stop_every"]
        assert stats["waits"] <= math.ceil(rounds / G) + 1
        assert 0 <= stats["replayed"] - rounds <= G - 1
        assert n == stats["replayed"]        # one scan_win launch a round
    assert cache.captures == captures + 1
    assert len(cache.entries) == 1
    assert all(r for r in got)


def test_stream_and_align_captures_that_sync_raise(engines, monkeypatch):
    """A stream chunk row or an alignment frame that synchronises with
    the host cannot be captured: each raises, never runs its eager loop,
    keeps no graph, and captures once its step is sound."""
    from julius_tpu_torch.search import align as talign
    eng, _, feats, lens = engines
    dev = dataclasses.replace(eng.dev_net)
    out = eng._outprob(torch.from_numpy(feats[:1]).cuda())[0]
    state = tp1.pass1_stream_start(dev, eng.p1_cfg, out[:1])
    chunk = (dev, eng.ngram_dev, eng.p1_cfg, state, out[1:17], 16)
    chain = talign.build_chain(eng.hmm, eng.voca, [eng.net.head_word,
                                                  eng.net.tail_word],
                               pseudo=eng.net.pseudo)
    cache = tp1.GraphCache()
    vit = (*talign.chain_tensors(chain, "cuda"), out, int(lens[0]))
    real_ends, real_step = twe.word_end, talign._Viterbi.step

    def syncing_ends(d, ng, cfg, score, *a):
        float(score.max())                  # a host synchronisation
        return real_ends(d, ng, cfg, score, *a)

    def syncing_step(self):
        float(self.score.max())
        return real_step(self)

    monkeypatch.setattr(twe, "word_end", syncing_ends)
    monkeypatch.setattr(talign._Viterbi, "step", syncing_step)
    monkeypatch.setattr(tp1, "_stream_eager", None)
    monkeypatch.setattr(talign, "_eager", None)
    with pytest.raises(RuntimeError):
        tp1.pass1_stream_chunk(*chunk)
    with pytest.raises(RuntimeError):
        talign.viterbi_chain(*vit, graphs=cache)
    assert not dev.graphs.entries and dev.graphs.captures == 0
    assert not cache.entries and cache.captures == 0
    monkeypatch.undo()
    got = tp1.pass1_stream_chunk(*chunk)
    want = tp1.pass1_stream_chunk(*chunk, eager=True)
    assert all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
    assert all(torch.equal(x, y) for x, y in zip(got[1], want[1]))
    got = talign.viterbi_chain(*vit, graphs=cache)
    want = talign.viterbi_chain(*vit, eager=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert dev.graphs.captures == cache.captures == 1


def test_astar_capture_that_syncs_raises(engines, monkeypatch):
    """A round that synchronises with the host cannot be captured: the A*
    raises, never runs the eager loop, keeps no graph and drops the
    cache's pool and stream, and captures again once the round is
    sound."""
    eng, _, feats, lens = engines
    args, kw = astar_case(eng, feats, lens)
    tabs = eng.device_chains
    tabs.graphs.entries.clear()
    captures = tabs.graphs.captures
    real = tp2d._env_key

    def syncing(seqh):
        float(seqh.max())                   # a host synchronisation
        return real(seqh)

    monkeypatch.setattr(tp2d, "_env_key", syncing)
    monkeypatch.setattr(tp2d, "_eager", None)
    with pytest.raises(RuntimeError):
        tp2d.run_batch(*args, **kw)
    assert not tabs.graphs.entries
    assert tabs.graphs.captures == captures
    assert tabs.graphs.pool is None and tabs.graphs.stream is None
    monkeypatch.undo()
    got, stats, _ = astar_run(args, kw)
    want, _, _ = astar_run(args, kw, eager=True)
    assert got == want and stats["captured"] == 1
    assert tabs.graphs.captures == captures + 1


def test_pass1_capture_that_syncs_raises(graph_cases, monkeypatch):
    """A step that synchronises with the host cannot be captured: pass 1
    raises, never runs the eager loop, keeps no graph, and captures
    again once the step is sound.  (Last in the file: a failed capture
    may leave the allocator's capture bookkeeping behind.)"""
    case = graph_cases["fused"]
    net, out, lens = case[0], case[4], case[5]
    dev = dataclasses.replace(net)
    real = twe.word_end

    def syncing(d, ng, cfg, score, *a):
        float(score.max())                  # a host synchronisation
        return real(d, ng, cfg, score, *a)

    monkeypatch.setattr(twe, "word_end", syncing)
    with pytest.raises(RuntimeError):
        graph_run(case, out, lens, dev=dev)
    assert not dev.graphs.entries and dev.graphs.captures == 0
    monkeypatch.undo()
    got, _ = graph_run(case, out, lens, dev=dev)
    want, _ = graph_run(case, out, lens, eager=True, dev=dev)
    assert_same_trellis(got, want)
    assert dev.graphs.captures == 1
