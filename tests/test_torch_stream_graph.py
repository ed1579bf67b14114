"""Port vs reference: a stream's pass-1 chunk as a frame loop over fixed
tensors (search/pass1.py `_StreamLoop`), the body that a CUDA card
captures once per network and replays once a chunk row.

On the CPU the same body runs from Python (`pass1_stream_chunk`).  On
the small flagship of tests/test_torch_streaming.py (the port's engine
on the reference's tables, the reference scorer's outprob rows), it is
held against the reference's jitted `pass1_stream_chunk`:

* fed in blocks of 1, 8 and 16 frames as StreamSession feeds it, the
  first chunk a row short: each chunk's atoms and the state after it;
* a final chunk at every n_valid from 1 to C (C = 8 and 16), the rows
  past n_valid holding the next frames' values, which the frozen state
  must not read;

atoms and state with integers equal, scores within atol 1e-5 (the
unfused step's tolerance, tests/test_torch_pass1_unfused.py) and
`int(state.t)` equal to the reference's t.  Then, through
`_stream_graphed`'s bookkeeping with the capture replaced by a stand-in
whose replay runs the step, two sessions whose chunks interleave
through one `_StreamLoop` (one capture) each equal their run alone bit
for bit.
"""

import contextlib
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.search import pass1 as jp1
from julius_tpu_torch.search import pass1 as tp1

from test_torch_streaming import assert_same_atoms, flagship  # noqa: F401
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


@pytest.fixture(scope="module")
def ref_chunk(flagship):  # noqa: F811
    """The reference's jitted pass1_stream_chunk on the small flagship."""
    _, jeng, _ = flagship
    return jax.jit(partial(jp1.pass1_stream_chunk, jeng.dev_net,
                           jeng.ngram_dev, jeng.p1_cfg))


def assert_same_state(got, want):
    """A port Pass1State ([1, N]) against a reference one ([N])."""
    np.testing.assert_allclose(got.score[0].numpy(), np.asarray(want.score),
                               rtol=0, atol=1e-5)
    assert np.array_equal(got.ctx[0].numpy(), np.asarray(want.ctx))
    assert np.array_equal(got.prev[0].numpy(), np.asarray(want.prev))
    assert got.t.dtype == torch.int32 and got.t.shape == (1,)
    assert int(got.t) == int(want.t)


def blocks_of(out_ext, block):
    """StreamSession's blocks: (rows, count) with the rows zero-padded
    to the block."""
    T = out_ext.shape[0]
    for start in range(0, T, block):
        count = min(block, T - start)
        rows = np.zeros((block, out_ext.shape[1]), np.float32)
        rows[:count] = out_ext[start:start + count]
        yield rows, count


def port_start(teng, rows):
    return tp1.pass1_stream_start(teng.dev_net, teng.p1_cfg,
                                  torch.tensor(rows[:1]))


def port_chunk(teng, state, rows, n, eager=False):
    return tp1.pass1_stream_chunk(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                                  state, torch.tensor(rows), n,
                                  eager=eager)


def stream_states(teng, jeng, ref_chunk, out_ext, block):
    """Both packages' streams, chunk by chunk: [(port state, port atoms,
    reference state, reference atoms, rows, n_valid)]."""
    out = []
    gs = ws = None
    for rows, count in blocks_of(out_ext, block):
        if gs is None:
            gs = port_start(teng, rows)
            ws = jp1.pass1_init(jeng.dev_net, jeng.p1_cfg,
                                jnp.asarray(rows[0]))
            rows, n = rows[1:], count - 1
        else:
            n = count
        if n == 0:
            continue
        gs, ga = port_chunk(teng, gs, rows, n)
        ws, wa = ref_chunk(ws, jnp.asarray(rows), jnp.asarray(n))
        out.append((gs, ga, ws, wa, rows, n))
    return out


@pytest.mark.parametrize("block", [1, 8, 16])
def test_chunk_body_matches_reference(flagship, ref_chunk, block,  # noqa: F811
                                      monkeypatch):
    teng, jeng, out_ext = flagship
    monkeypatch.setattr(tp1, "_capture", None)     # the CPU never captures
    chunks = stream_states(teng, jeng, ref_chunk, out_ext, block)
    assert [c[5] for c in chunks[:2]] == ([1, 1] if block == 1
                                          else [block - 1, block])
    assert len(chunks[0][4]) == max(block - 1, 1)
    for gs, ga, ws, wa, rows, n in chunks:
        assert ga.word.shape == (len(rows), teng.p1_cfg.n_atoms)
        assert_same_atoms([a.numpy() for a in ga],
                          [np.asarray(a) for a in wa])
        assert_same_state(gs, ws)
    assert int(chunks[-1][0].t) == out_ext.shape[0] - 1


@pytest.mark.parametrize("C", [8, 16])
def test_final_chunk_at_every_n_valid(flagship, ref_chunk, C):  # noqa: F811
    """From the state after 2C frames, a chunk of C rows with n_valid 1
    .. C; its rows are the next C frames whatever n_valid says."""
    teng, jeng, out_ext = flagship
    chunks = stream_states(teng, jeng, ref_chunk, out_ext[:2 * C + 1], C)
    gs0, _, ws0, _, _, _ = chunks[-1]
    assert int(gs0.t) == 2 * C
    rows = np.ascontiguousarray(out_ext[2 * C + 1:3 * C + 1])
    assert rows.shape[0] == C
    for n in range(1, C + 1):
        gs, ga = port_chunk(teng, gs0, rows, n)
        ws, wa = ref_chunk(ws0, jnp.asarray(rows), jnp.asarray(n))
        assert_same_atoms([a.numpy() for a in ga],
                          [np.asarray(a) for a in wa])
        assert_same_state(gs, ws)
        assert int(gs.t) == 2 * C + n
        # rows from n on repeat the frozen state's word ends
        for a in ga:
            assert (a[n:] == a[min(n, C - 1)]).all()
    # the session's state itself is untouched by a chunk
    assert int(gs0.t) == 2 * C


def test_interleaved_sessions_share_one_loop(flagship,  # noqa: F811
                                             monkeypatch):
    """Two sessions (the utterance and its frames reversed) fed in
    8-frame blocks, their chunks interleaved through `_stream_graphed`
    with a stand-in capture: one capture for both (a first chunk of 7
    rows and the others of 8 share the 8-row entry), each session equal
    bit for bit to its own run alone through the eager loop."""
    teng, _, out_ext = flagship
    streams = [out_ext, np.ascontiguousarray(out_ext[::-1])]

    def run(out):
        state, res = None, []
        for rows, count in blocks_of(out, 8):
            if state is None:
                state = port_start(teng, rows)
                rows, count = rows[1:], count - 1
            state, atoms = port_chunk(teng, state, rows, count)
            res.append((state, atoms))
        return res

    alone = [run(s) for s in streams]
    captures = []

    def capture(cache, device, step):
        captures.append(device)
        step()
        return [types.SimpleNamespace(replay=step)]

    monkeypatch.setattr(tp1, "_stream_eager", tp1._stream_graphed)
    monkeypatch.setattr(tp1, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    cache = teng.dev_net.graphs
    monkeypatch.setattr(cache, "entries", {})
    monkeypatch.setattr(cache, "captures", 0)
    gens = [blocks_of(s, 8) for s in streams]
    states = [None, None]
    got = [[], []]
    for blocks in zip(*gens):
        for u, (rows, count) in enumerate(blocks):
            if states[u] is None:
                states[u] = port_start(teng, rows)
                rows, count = rows[1:], count - 1
            states[u], atoms = port_chunk(teng, states[u], rows, count)
            got[u].append((states[u], atoms))
    assert len(captures) == cache.captures == 1
    (key, entry), = cache.entries.items()
    assert key[0] == "stream" and key[-1] == 8
    assert isinstance(entry.loop, tp1._StreamLoop)
    for g, a in zip(got, alone):
        assert len(g) == len(a) > 2
        for (gs, ga), (ws, wa) in zip(g, a):
            assert all(torch.equal(x, y) for x, y in zip(gs, ws))
            assert all(torch.equal(x, y) for x, y in zip(ga, wa))
