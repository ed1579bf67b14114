"""Port vs reference: one frame of the fused pass-1 beam update.

The port's plain PyTorch version (`fused_step_plain`, the CUDA kernel's
oracle and CPU path) against the reference Pallas kernel run through
the Pallas interpreter, on inputs built to hit every rule: a node axis
of several reference tiles (the inter-tile halo), exact ties between
shifted candidates (smallest k wins) and with the entry candidate
(strictly greater only), LOG_ZERO runs, missing arcs and entries, and
frozen rows.  Integer outputs must be equal; scores within atol 1e-5
(the same f32 adds in the same order, so in practice bit-equal).

Then the CUDA kernel's launch plan and a numpy mirror of its lanes
(csrc/pass1_step.cu has no CPU build), and pass 1 over the node axis
padded for the kernel against the unpadded run and the reference."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.ops import pass1_kernel as jpk
from julius_tpu.search import pass1 as jp1
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch import convert
from julius_tpu_torch.ops import pass1_kernel as tpk
from julius_tpu_torch.search import pass1 as tp1

from torch_fixtures import assert_same_step, make_step_inputs, run_step


def run_reference(d):
    out = d["row"][:, d["sidx"]]
    res = jpk.fused_step(
        jnp.asarray(d["score"]), jnp.asarray(d["ctx"]), jnp.asarray(d["prev"]),
        jnp.asarray(d["loc"]), jnp.asarray(d["et"]), jnp.asarray(out),
        jnp.asarray(d["ent"]), jnp.asarray(d["ectx"]), jnp.asarray(d["eprev"]),
        jnp.asarray(d["fv"]), interpret=True)
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("B,K", [(1, 1), (3, 1), (2, 3)])
def test_plain_matches_reference_kernel(B, K):
    N = 3 * jpk.tile_n(B)                            # several tiles
    d = make_step_inputs(B * 10 + K, B, N, K)
    ref = run_reference(d)
    got = run_step(d)
    assert_same_step(got, ref)
    # a frozen row keeps its state; ties really occurred
    if B > 1:
        assert np.array_equal(got[0][1], d["score"][1])
    assert (d["loc"][0] + d["score"] == d["loc"][1] + np.roll(
        d["score"], 1, axis=1)).sum() > 10


def test_several_frames_match_reference():
    """A run of frames, each fed the previous frame's output."""
    B, K = 2, 2
    N = 2 * jpk.tile_n(B)
    d = make_step_inputs(7, B, N, K)
    for f in range(4):
        ref = run_reference(d)
        got = run_step(d)
        assert_same_step(got, ref)
        d = dict(d, score=ref[0], ctx=ref[1], prev=ref[2],
                 row=np.roll(d["row"], f + 1, axis=1),
                 fv=np.asarray([True, f < 2]))


def test_cpu_tensors_take_the_plain_version():
    d = make_step_inputs(3, 2, 700, 1)
    before = tpk.LAUNCHES
    assert_same_step(run_step(d, fn=tpk.fused_step), run_step(d))
    assert tpk.LAUNCHES == before


def scores_off(**kw):
    s, c, p = tpk.fused_step_plain(**kw)
    return s.add_(1.0), c, p


def nodes_unwritten(**kw):
    out = kw.pop("out")
    new = tpk.fused_step_plain(**kw)
    out[0][:, :350].copy_(new[0][:, :350])
    for o, n in zip(out[1:], new[1:]):
        o.copy_(n)
    return out


def ctx_off(**kw):
    s, c, p = tpk.fused_step_plain(**kw)
    return s, c.add_(1), p


@pytest.mark.parametrize("kernel", [tpk.fused_step_plain, scores_off,
                                    nodes_unwritten, ctx_off],
                         ids=["right", "scores_off", "nodes_unwritten",
                              "ctx_off"])
def test_smoke_holds_a_kept_step_call_to_the_plain_version(monkeypatch,
                                                           kernel):
    """chip_smoke.py's `keep_calls` and `compare_step` on a step call
    that writes the state set it is given, as pass 1's frame makes it:
    the kept copy is not the set the loop goes on to overwrite, and each
    side of the comparison writes a set of its own, so a kernel that
    computes wrong values or leaves nodes unwritten is caught."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    d = make_step_inputs(5, 2, 700, 1)
    t = {k: torch.tensor(v) for k, v in d.items()}
    args = [t[k] for k in ("score", "ctx", "prev", "loc", "et", "row",
                           "sidx", "ent", "ectx", "eprev", "fv")]
    live = tuple(torch.empty_like(x) for x in args[:3])
    store = {"pass1_step": {}}
    step = chip_smoke.keep_calls(store, "pass1_step", tpk.fused_step_plain,
                                 tpk.fused_step_plain,
                                 lambda a: tuple(a["score"].shape))
    want = [x.clone() for x in step(*args, live)]
    (kept,) = store["pass1_step"][(2, 700)][1]
    assert not {k.data_ptr() for k in kept["out"]} & {
        x.data_ptr() for x in live}
    pk = types.SimpleNamespace(fused_step=kernel,
                               fused_step_plain=tpk.fused_step_plain)
    if kernel is tpk.fused_step_plain:
        err, got = chip_smoke.compare_step(pk, kept)
        assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        with pytest.raises(RuntimeError, match="kernel"):
            chip_smoke.compare_step(pk, kept)


# ---- the kernel's launch plan and a numpy mirror of its schedule

GARBAGE_F, GARBAGE_I = np.float32(1.0e9), np.int32(123456789)
LOG_ZERO_F = np.float32(-1e10)


def halo_lanes(K1):
    """Lanes holding the chunks in front of a tile: ceil(K / 4)."""
    return (K1 + 2) // 4


def lane_chunks(plan, B, N, K1, tile, b):
    """Row b of tile `tile`: (t0, t1, the chunk of lane 0), as
    csrc/pass1_step.cu `lane_chunk` computes them; lane L holds chunk
    q0 + L."""
    t0 = tile * plan.tile
    t1 = min(t0 + plan.tile, N)
    return t0, t1, (b * N + t0) // 4 - halo_lanes(K1)


def tab_pos(x):
    return x + (x >> 5)


def mirror_kernel(d, plan):
    """csrc/pass1_step.cu in numpy, block by block (one a tile) and lane
    by lane: each of a warp's 32 lanes holds one 16-byte chunk of the
    flat state (the first ceil(K / 4) the chunks in front of the tile;
    elements outside the array are garbage here), the shifted reads
    n - k come from the chunk of lane - 1 or lane - 2 (the kernel's
    shuffles), the tables and score_idx from the tile's shared-memory
    rows, and the lanes past the halo store their nodes inside the
    tile.  Returns the outputs
    (garbage where nothing was stored) and each element's store count."""
    flat = [d[k].ravel() for k in ("score", "ctx", "prev")]
    loc, et, sidx, row = d["loc"], d["et"], d["sidx"], d["row"]
    B, N = d["score"].shape
    K1 = loc.shape[0]
    K = K1 - 1
    total = B * N
    outs = [np.full(total, GARBAGE_F), np.full(total, GARBAGE_I),
            np.full(total, GARBAGE_I)]
    writes = np.zeros(total, int)

    def chunk(q):
        out = []
        for a in flat:
            v = np.full(4, GARBAGE_I if a.dtype == np.int32 else GARBAGE_F,
                        a.dtype)
            for i in range(4):
                if 0 <= 4 * q + i < total:
                    v[i] = a[4 * q + i]
            out.append(v)
        return out

    for tile in range(plan.n_tiles):
        t0 = tile * plan.tile
        t1 = min(t0 + plan.tile, N)
        tab = np.full((K1 + 2, plan.tab_stride), GARBAGE_F)
        for x in range(t1 - t0):
            assert tab_pos(x) < plan.tab_stride
            tab[:K1, tab_pos(x)] = loc[:, t0 + x]
            tab[K1, tab_pos(x)] = et[t0 + x]
            tab[K1 + 1, tab_pos(x)] = sidx[t0 + x]
        for b in range(B):
            t0, t1, q0 = lane_chunks(plan, B, N, K1, tile, b)
            row0 = b * N
            lanes = [chunk(q0 + lane) for lane in range(32)]
            halo = halo_lanes(K1)
            # the lanes past the halo cover the tile
            assert 4 * (q0 + halo) <= row0 + t0 and 4 * (q0 + 32) >= row0 + t1
            fv = d["fv"][b]
            for lane in range(halo, 32):
                q = q0 + lane
                n0 = 4 * q - row0
                for i in range(4):
                    n, f = n0 + i, 4 * q + i
                    if n < t0 or n >= t1:
                        continue
                    s0, c0, p0 = (a[i] for a in lanes[lane])
                    if fv:
                        x = tab_pos(n - t0)
                        inw = np.float32(s0 + tab[0, x])
                        cw, pw = c0, p0
                        for k in range(1, K + 1):
                            j = i - k
                            dd, pos = j // 4, j % 4
                            assert lane + dd >= 0
                            hs, hc, hp = (a[pos] for a in lanes[lane + dd])
                            if n < k:
                                hs, hc, hp = LOG_ZERO_F, -1, -1
                            cand = np.float32(hs + tab[k, x])
                            if cand > inw:
                                inw, cw, pw = cand, hc, hp
                        e_t = tab[K1, x]
                        cand_e = (np.float32(d["ent"][b] + e_t)
                                  if e_t > LOG_ZERO_F / 2 else LOG_ZERO_F)
                        if cand_e > inw:
                            inw, cw, pw = cand_e, d["ectx"][b], d["eprev"][b]
                        g = row[b, int(tab[K1 + 1, x])]
                        s0 = (np.float32(inw + g)
                              if inw > LOG_ZERO_F / 2 else LOG_ZERO_F)
                        c0, p0 = cw, pw
                    outs[0][f], outs[1][f], outs[2][f] = s0, c0, p0
                    writes[f] += 1
    return [o.reshape(B, N) for o in outs], writes


@pytest.mark.parametrize("N", [1, 300, 4099, 74_967, 299_718])
def test_launch_plan_fits_the_card(N):
    """At K1 = 1, 2 and 9 and every B up to 64: a block's tables fit the
    48 KB of shared memory a block has without opting in, the warps of a
    tile are a power of two within B, every block is resident at once
    when a tile has more than one warp, and the outputs stream out
    exactly when they outgrow L2."""
    for B in range(1, 65):
        for K1 in (1, 2, 9):
            p = tpk.launch_plan(B, N, K1)
            assert p.smem_bytes <= 48 * 1024
            assert p.warps & (p.warps - 1) == 0
            assert 1 <= p.warps <= min(B, tpk.MAX_WARPS)
            if p.warps > 1:
                assert p.n_tiles <= tpk.N_SM * tpk.modelled_blocks_per_sm(
                    p.warps)
            assert p.stream_out == (B * N * 12 > tpk.L2_BYTES)
            halo = halo_lanes(K1)
            assert 4 * halo >= K1 - 1                # the halo holds K
            assert p.tile + 4 <= 4 * (32 - halo)     # any alignment
            assert p.tab_stride >= tab_pos(p.tile - 1) + 1


@pytest.mark.parametrize("B,N,K1", [(1, 74_967, 2), (4, 74_967, 2),
                                    (64, 74_967, 2), (32, 299_718, 2),
                                    (3, 4099, 9), (2, 300, 9), (5, 1, 4),
                                    (2, 700, 1), (3, 500, 6)])
def test_launch_plan_tiles_cover_nodes(B, N, K1):
    """The tiles cover [0, N) exactly; in every row the lanes past the
    halo cover the tile and the halo lanes hold at least K nodes in
    front of it."""
    p = tpk.launch_plan(B, N, K1)
    tiles = [(t * p.tile, min((t + 1) * p.tile, N))
             for t in range(p.n_tiles)]
    assert tiles[0][0] == 0 and tiles[-1][1] == N
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(tiles, tiles[1:]))
    halo = halo_lanes(K1)
    for tile in list(range(min(p.n_tiles, 50))) + [p.n_tiles - 1]:
        for b in range(B):
            t0, t1, q0 = lane_chunks(p, B, N, K1, tile, b)
            assert (t0, t1) == tiles[tile]
            assert 4 * q0 <= b * N + t0 - (K1 - 1)            # the halo
            assert 4 * (q0 + halo) <= b * N + t0
            assert 4 * (q0 + 32) >= b * N + t1


@pytest.mark.parametrize("B,N,K", [
    (1, 5, 1), (2, 300, 8), (3, 4099, 3), (5, 601, 1), (4, 1001, 0),
    (7, 253, 4), (2, 1000, 8), (9, 250, 5), (16, 130, 7), (3, 370, 0)])
def test_kernel_mirror_matches_plain(B, N, K):
    """The kernel's lanes, mirrored in numpy with garbage wherever it
    must not read, equal the plain version on the tie-heavy inputs:
    ragged tiles, rows starting mid-chunk, halos of one and two chunks
    across tile edges, the first row's halo before the array, a frozen
    row; every node is stored exactly once."""
    d = make_step_inputs(B * 100 + N + K, B, N, K)
    got, writes = mirror_kernel(d, tpk.launch_plan(B, N, K + 1))
    assert (writes == 1).all()
    want = run_step(d)
    assert_same_step(got, want)
    np.testing.assert_array_equal(got[0], want[0])    # bit-equal


def test_padded_pass1_batch_matches_unpadded_and_reference(monkeypatch):
    """pass1_batch pads the kernel's node axis to a multiple of 4; on the
    reference's small fixtures (a node count that is not one) its trellis
    equals the same loop over the unpadded tables and the reference's
    pass1_batch: word ids equal, other fields equal and scores within
    atol 1e-5 where a word survived (the reference's own rule)."""
    eng = flagship_engine(n_words=120, n_phones=48, hidden=32, n_layers=1)
    rng = np.random.default_rng(11)
    B, T = 3, 70
    out = np.array(jax.jit(eng._outprob)(jnp.asarray(
        rng.standard_normal((B, T, 1320)).astype(np.float32))))
    out[1] = out[1][rng.permutation(T)]
    nfr = np.asarray([T, T - 9, T - 30], np.int32)
    old = jp1.FUSE_PASS1
    jp1.FUSE_PASS1 = False
    try:
        ref = jax.tree_util.tree_map(np.asarray, jp1.pass1_batch(
            eng.dev_net, eng.ngram_dev, eng.p1_cfg, jnp.asarray(out),
            jnp.asarray(nfr)))
    finally:
        jp1.FUSE_PASS1 = old
    dev = convert.device_network(convert.numpy_fields(eng.dev_net), "cpu")
    ng = convert.device_ngram(convert.numpy_fields(eng.ngram_dev), "cpu")
    cfg = tp1.Pass1Config(**{f.name: getattr(eng.p1_cfg, f.name)
                             for f in dataclasses.fields(tp1.Pass1Config)})
    N = dev.loc_lp.shape[1]
    assert N % 4 and tp1.fused_ok(dev, cfg)
    loc, etot, sidx = tp1.kernel_tables(dev)
    assert loc.shape[1] == etot.shape[0] == sidx.shape[0] == N + (-N % 4)
    assert (loc[:, N:] == LOG_ZERO_F).all() and (etot[N:] == LOG_ZERO_F).all()
    shapes = []
    real = tpk.fused_step

    def recording(score, *a):
        shapes.append(score.shape[1])
        return real(score, *a)
    monkeypatch.setattr(tpk, "fused_step", recording)
    padded = tp1.pass1_batch(dev, ng, cfg, torch.from_numpy(out),
                             torch.from_numpy(nfr))
    assert set(shapes) == {loc.shape[1]}
    monkeypatch.setattr(tp1, "kernel_tables", lambda d: (
        d.loc_lp.contiguous(), tp1.entry_total(d), d.score_idx))
    shapes.clear()
    unpadded = tp1.pass1_batch(dev, ng, cfg, torch.from_numpy(out),
                               torch.from_numpy(nfr))
    assert set(shapes) == {N}
    padded = tp1.Trellis(*[a.numpy() for a in padded])
    unpadded = tp1.Trellis(*[a.numpy() for a in unpadded])
    for a, b in zip(padded, unpadded):
        np.testing.assert_array_equal(a, b)
    valid = ref.word >= 0
    assert np.array_equal(padded.word, ref.word) and valid.sum() > 500
    for name in padded._fields:
        x, y = getattr(padded, name), getattr(ref, name)
        if x.dtype.kind == "f":
            assert np.allclose(np.where(valid, x, 0), np.where(valid, y, 0),
                               atol=1e-5), name
        else:
            assert np.array_equal(np.where(valid, x, 0),
                                  np.where(valid, y, 0)), name
