"""Port vs reference: the sharded pass 1 as a frame step over fixed
tensors (parallel/sharded_pass1.py `_Loop`), the body that CUDA cards
capture and replay once a frame.

On the CPU the same step runs from Python (`sharded_pass1`).  On the
small engines of tests/test_torch_parallel.py it is held against the
reference's `shard_map`'d scan on JAX's virtual CPU mesh at S = 1, 2, 4
and 8, with n_frames = T and with n_frames < T (the rows past n_frames
holding the utterance's real next frames, which the frozen state must
not read): all six trellis fields, integers equal, scores and LM
scores within atol 1e-5 (test_torch_parallel.py's rule).

Then `_graphed`'s bookkeeping, with the capture replaced by a stand-in
whose replay runs the captured step: a second call of a key captures
nothing, two utterances of different length in one frame bucket share
the entry, calls that interleave (in turns and from two threads) each
equal their run alone bit for bit, a row of two devices (the CPU named
twice, so the multi-card path runs: two graphs a device and the gather
copied between them) equals the one-device row; and the packed gather
gives the float bits back exactly, in shard-major order.
"""

import contextlib
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.parallel import sharded_pass1 as jsp
from julius_tpu_torch.parallel import mesh as tmesh
from julius_tpu_torch.parallel import sharded_pass1 as tsp

from test_torch_parallel import (assert_same_trellis, jax_mesh,  # noqa: F401
                                 setup)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


def sharded_args(teng, S, devices=None):
    """(a one-row mesh of `devices`, S shards of the port's network)."""
    snet = tsp.partition_network(teng.net, teng.dev_net, S)
    mesh = tmesh.make_mesh(devices=devices or ["cpu"] * S, tp=S)
    return mesh, snet


def port_run(teng, out, n, devices):
    """The port's sharded pass 1 on a one-row mesh of `devices`."""
    return tsp.sharded_pass1(*sharded_args(teng, len(devices), devices),
                             teng.ngram_dev, teng.p1_cfg,
                             torch.from_numpy(out), n)


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_step_matches_reference(setup, n_shards, short):  # noqa: F811
    jeng, teng, out_ext = setup
    T = out_ext.shape[0]
    n = 2 * T // 3 if short else T
    want = jsp.sharded_pass1(
        jax_mesh(n_shards), jsp.partition_network(jeng.net, jeng.dev_net,
                                                  n_shards),
        jeng.ngram_dev, jeng.p1_cfg, jnp.asarray(out_ext), n)
    got = port_run(teng, out_ext, n, ["cpu"] * n_shards)
    assert got.word.shape == (T, teng.p1_cfg.n_atoms)
    assert [a.dtype for a in got] == list(tsp.TRELLIS_DTYPES)
    assert_same_trellis(got, want)
    assert (got.word.numpy() >= 0).sum() > n
    if short:
        # no word past n_frames; the frozen state's atoms everywhere else
        assert (got.word.numpy()[n:] == -1).all()
        assert (got.score.numpy()[n:] == got.score.numpy()[n - 1]).all()


def test_pack_round_trips_float_bits_shard_major():
    """_pack / _unpack: the floats' bits exactly (negative zero, LOG_ZERO,
    a subnormal, infinities, a NaN with a payload), integers as they
    were, and the fields of S blocks in shard-major order, as the
    per-field concatenation gives them."""
    rng = np.random.default_rng(3)
    S, k = 3, 5
    bits = rng.integers(-2 ** 31, 2 ** 31 - 1, (S, k), dtype=np.int64)
    special = np.array([0x80000000, 0xD01502F9, 0x00000001, 0x7F800000,
                        0xFF800000, 0x7FC01234], np.uint32).view(np.int32)
    bits.flat[:special.size] = special
    score = torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    lm = torch.from_numpy(rng.standard_normal((S, k)).astype(np.float32))
    ints = [torch.from_numpy(rng.integers(-1, 9999, (S, k)).astype(np.int32))
            for _ in range(3)]
    parts = [(score[s], *[x[s] for x in ints], lm[s]) for s in range(S)]
    blocks = torch.stack([tsp._pack(p) for p in parts])
    assert blocks.shape == (S, 5, k) and blocks.dtype == torch.int32
    got = tsp._unpack(blocks)
    assert [a.dtype for a in got] == [torch.float32, torch.int32,
                                      torch.int32, torch.int32,
                                      torch.float32]
    for i, g in enumerate(got):
        want = torch.cat([p[i] for p in parts])
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


@contextlib.contextmanager
def stand_in_capture(monkeypatch):
    """Route the CPU's sharded_pass1 through `_graphed`, with a capture
    that runs the step once and returns a graph whose replay runs it
    again.  Yields the list of captured devices."""
    captured = []

    def capture(cache, device, step):
        captured.append(device)
        step()
        return [types.SimpleNamespace(replay=step)]

    monkeypatch.setattr(tsp, "_eager", tsp._graphed)
    monkeypatch.setattr(tsp, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    yield captured
    monkeypatch.undo()


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_graphed_cache_reuses_one_entry(setup, monkeypatch):  # noqa: F811
    """S = 4 on a one-device row: the first call captures the whole step
    once (one graph), a second call of the key captures nothing, and a
    shorter utterance (its frames reversed, a few cut, padded past its
    n_frames) in the same frame bucket replays the same entry; each
    equal bit for bit to the eager loop."""
    _, teng, out_ext = setup
    T = out_ext.shape[0]
    other = np.ascontiguousarray(out_ext[::-1][:T - 3])
    assert (T - 1).bit_length() == (T - 4).bit_length()
    mesh, snet = sharded_args(teng, 4)
    cfg, ng = teng.p1_cfg, teng.ngram_dev
    calls = [(out_ext, T), (out_ext, T), (other, T - 3), (other, T - 8)]
    alone = [tsp.sharded_pass1(mesh, snet, ng, cfg, torch.from_numpy(o), n)
             for o, n in calls]
    assert not snet.caches.graphs
    with stand_in_capture(monkeypatch) as captured:
        got = [tsp.sharded_pass1(mesh, snet, ng, cfg, torch.from_numpy(o), n)
               for o, n in calls]
    assert captured == [torch.device("cpu")]
    cache, = snet.caches.graphs.values()
    assert cache.captures == 1 and cache.capture_s > 0
    (key, entry), = cache.entries.items()
    assert key[1:5] == (4, snet.score_idx.shape[1], snet.exit_nodes.shape[1],
                        cfg.n_atoms)
    assert key[-1] == max(tsp.MIN_T_BUCKET, 1 << (T - 1).bit_length())
    assert len(entry.graphs) == 1 and not entry.loop.copies
    for g, a in zip(got, alone):
        assert g.word.shape == a.word.shape
        assert same(g, a)
    assert not same(got[2], got[3])


def test_interleaved_calls_equal_their_runs_alone(setup,  # noqa: F811
                                                  monkeypatch):
    """Two utterances (the frames and their reverse) through one entry at
    S = 2: in turns, then from two threads at once; each call equal bit
    for bit to its run alone."""
    _, teng, out_ext = setup
    mesh, snet = sharded_args(teng, 2)
    cfg, ng = teng.p1_cfg, teng.ngram_dev
    outs = [out_ext, np.ascontiguousarray(out_ext[::-1])]
    T = out_ext.shape[0]

    def run(u):
        return tsp.sharded_pass1(mesh, snet, ng, cfg,
                                 torch.from_numpy(outs[u]), T - u)

    alone = [run(0), run(1)]
    assert not same(*alone)
    errors, got = [], {0: [], 1: []}

    def worker(u):
        try:
            for _ in range(3):
                got[u].append(run(u))
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    with stand_in_capture(monkeypatch) as captured:
        turns = [run(u) for u in (0, 1, 0, 1)]
        threads = [threading.Thread(target=worker, args=(u,))
                   for u in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(captured) == 1
    for i, g in enumerate(turns):
        assert same(g, alone[i % 2])
    for u in (0, 1):
        assert len(got[u]) == 3 and all(same(g, alone[u]) for g in got[u])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_two_device_row_gathers_between_replays(setup, n_shards,  # noqa: F811
                                                monkeypatch):
    """A row of two devices (the CPU as "cpu" and as "cpu:0", shards
    alternating between them): each device has its own cache, phase A's
    and phase C's graph, and the gather copies each run of one device's
    blocks into the other's buffer; eager and graphed, the trellis
    equals the one-device row's bit for bit, and a second call captures
    nothing."""
    _, teng, out_ext = setup
    T = out_ext.shape[0]
    devices = ["cpu", "cpu:0"] * (n_shards // 2)
    mesh, snet = sharded_args(teng, n_shards, devices)
    one = port_run(teng, out_ext, T - 2, ["cpu"] * n_shards)
    args = (teng.ngram_dev, teng.p1_cfg, torch.from_numpy(out_ext), T - 2)
    assert same(tsp.sharded_pass1(mesh, snet, *args), one)
    with stand_in_capture(monkeypatch) as captured:
        got = [tsp.sharded_pass1(mesh, snet, *args) for _ in range(2)]
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu:0")
    assert captured == [cpu, cpu0, cpu, cpu0]       # A, A, C, C
    caches = snet.caches.graphs
    assert list(caches) == [cpu, cpu0]
    assert caches[cpu].captures == 1 and caches[cpu0].captures == 0
    entry, = caches[cpu].entries.values()
    assert list(caches[cpu0].entries.values()) == [entry]
    assert len(entry.graphs) == 4
    assert [(d.device, s.device, a, b) for d, s, a, b in entry.loop.copies] \
        == [(cpu, cpu0, s, s + 1) for s in range(1, n_shards, 2)] \
        + [(cpu0, cpu, s, s + 1) for s in range(0, n_shards, 2)]
    for g in got:
        assert same(g, one)
