"""Port vs reference: the pass-2 word scan (search/scan.py).

The windowed seeded word Viterbi (`_scan_core_win` in the reference, the
scan kernel's plain version in the port), the device-resident round
around it (`scan_words_store_win`) and the numpy oracle `scan_words_ref`
run on the same chain tables (the reference engine's, carried across by
convert.py) and the same random outprobs.  The inputs are integer-valued
so that shifted arcs, entries and word ends tie exactly, and they hold
dead chains (word id V), LOG_ZERO seed runs, windows that end at the
last frame, and pad chains whose output row lies past the store.
Integers must be equal and scores within atol 1e-5 (the scan only adds
and compares floats, so both sides compute the same sums)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search.scan import (_scan_core_win,
                                    scan_words_store_win as jax_store_win)
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch import convert
from julius_tpu_torch.ops import scan_kernel as tsk
from julius_tpu_torch.search import scan as tscan
from julius_tpu_torch.search.network import build_network

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
LOG_ZERO = -1e10
B, T, R = 3, 90, 150


@pytest.fixture(scope="module")
def tables():
    eng, _ = flagship_engine(trained=True, **SIZE)
    jtabs = eng.device_chains
    ttabs = convert.device_chains(convert.chain_fields(jtabs), "cpu")
    return eng, jtabs, ttabs


def test_chain_tables_match_reference(tables):
    eng, jtabs, ttabs = tables
    own = tscan.DeviceChainTables(
        build_network(eng.hmm, eng.voca, use_triphone=False), "cpu")
    assert (own.kl, own.nmax, own.n_words) == \
        (jtabs.kl, jtabs.nmax, jtabs.n_words) == (1, 21, 120)
    for name in tscan.CHAIN_FIELDS:
        assert np.array_equal(getattr(own, name).numpy(),
                              np.asarray(getattr(jtabs, name))), name
        assert torch.equal(getattr(own, name), getattr(ttabs, name)), name


def scan_inputs(seed, K, W, V, synthetic_tables, nmax=21, K1=2):
    """Chains, seeds, windows and outprobs for one windowed scan."""
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, V + 1, K)
    wids[::5] = V                                    # dead chains
    seed_w = rng.integers(-60, -20, (K, W)).astype(np.float32)
    seed_w[rng.random((K, W)) < 0.6] = LOG_ZERO
    seed_w[:, 5:20] = LOG_ZERO                       # a LOG_ZERO run
    t0 = rng.integers(0, T - W + 1, K).astype(np.int32)
    t0[1::4] = T - W                                 # windows at the end
    bidx = rng.integers(0, B, K).astype(np.int32)
    out = rng.integers(-4, 3, (B, T, R)).astype(np.float32)
    tabs = None
    if synthetic_tables:
        # integer arc/entry/exit tables: shifts and end nodes tie
        loc = rng.integers(-2, 1, (K, K1, nmax)).astype(np.float32)
        loc[rng.random(loc.shape) < 0.2] = LOG_ZERO
        ent = rng.integers(-3, 0, (K, nmax)).astype(np.float32)
        ent[rng.random(ent.shape) < 0.7] = LOG_ZERO
        ext = rng.integers(-1, 1, (K, nmax)).astype(np.float32)
        ext[rng.random(ext.shape) < 0.3] = LOG_ZERO
        sidx = rng.integers(0, R, (K, nmax)).astype(np.int32)
        tabs = (loc, ent, ext, sidx)
    return wids, seed_w, t0, bidx, out, tabs


@pytest.mark.parametrize("synthetic", [False, True])
@pytest.mark.parametrize("K,W", [(16, 64), (40, 30)])
def test_scan_core_win_matches_reference(tables, synthetic, K, W):
    _, jtabs, _ = tables
    wids, seed_w, t0, bidx, out, tabs = scan_inputs(
        K + W + synthetic, K, W, jtabs.n_words, synthetic)
    if tabs is None:
        tabs = tuple(np.asarray(getattr(jtabs, n))[wids]
                     for n in ("loc", "ent", "ext", "sidx"))
    loc, ent, ext, sidx = tabs
    idx_t = t0[:, None] + np.arange(W)
    outw = out[bidx[:, None, None], idx_t[:, :, None], sidx[:, None, :]]
    want = [np.asarray(a) for a in _scan_core_win(
        jnp.asarray(loc), jnp.asarray(ent), jnp.asarray(ext),
        jnp.asarray(seed_w), jnp.asarray(outw), jnp.asarray(t0))]
    before = tsk.LAUNCHES
    got = [a.numpy() for a in tsk.scan_core_win(
        *(torch.from_numpy(a) for a in (loc, ent, ext, sidx, seed_w, out,
                                        bidx, t0)))]
    assert tsk.LAUNCHES == before          # CPU tensors: the plain version
    assert got[1].dtype == np.int32
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    # the reference's dead chains (all LOG_ZERO tables) come out LOG_ZERO
    if not synthetic:
        assert (got[0][wids == jtabs.n_words] == LOG_ZERO).all()


def test_scan_matches_numpy_oracle(tables):
    """scan_words_ref on one chain at a time: a third witness, over the
    whole utterance (t0 = 0, W = T)."""
    _, jtabs, ttabs = tables
    wids, seed_w, _, bidx, out, _ = scan_inputs(5, 6, T, jtabs.n_words,
                                                False)
    wids[0] = 7
    t0 = np.zeros(6, np.int32)
    g, beg, _ = tsk.scan_core_win_plain(
        ttabs.loc[wids], ttabs.ent[wids], ttabs.ext[wids], ttabs.sidx[wids],
        torch.from_numpy(seed_w), torch.from_numpy(out),
        torch.from_numpy(bidx), torch.from_numpy(t0))
    n_live = 0
    for k in range(6):
        gr, br = tscan.scan_words_ref(
            ttabs.loc[wids[k]].numpy(), ttabs.ent[wids[k]].numpy(),
            ttabs.ext[wids[k]].numpy(), ttabs.sidx[wids[k]].numpy(),
            seed_w[k], out[bidx[k]])
        fin = gr > LOG_ZERO / 2
        n_live += fin.sum()
        np.testing.assert_allclose(g[k].numpy()[fin], gr[fin], atol=1e-5,
                                   rtol=0)
        assert (g[k].numpy()[~fin] <= LOG_ZERO / 2).all()
        np.testing.assert_array_equal(beg[k].numpy()[fin], br[fin])
    assert n_live > 0


@pytest.mark.parametrize("scan_beam", [0.0, 6.0])
def test_scan_words_store_win_matches_reference(tables, scan_beam):
    """One device-resident round: stores, anchor values, and pad chains
    whose out_row is the store's capacity (JAX drops their writes; the
    port sends them to the sink row past the store)."""
    _, jtabs, ttabs = tables
    CAP, K, W, A = 24, 16, 64, 6
    rng = np.random.default_rng(11)
    g0 = rng.integers(-80, -10, (CAP, T)).astype(np.float32)
    g0[rng.random((CAP, T)) < 0.5] = LOG_ZERO
    b0 = rng.integers(0, T, (CAP, T)).astype(np.int32)
    wids, _, t0, bidx, out, _ = scan_inputs(12, K, W, jtabs.n_words, False)
    ints = np.zeros((K, 6 + A), np.int32)
    ints[:, 0] = wids
    ints[:, 1] = rng.integers(-1, CAP, K)
    ints[:3, 1] = -1                                  # sentence starts
    ints[:3, 4] = 0
    ints[3:, 4] = t0[3:]
    ints[:, 2] = bidx
    ints[:, 3] = rng.permutation(CAP)[:K]
    ints[-4:, 3] = CAP                                # pad chains
    ints[-4:, 0] = jtabs.n_words
    ints[:, 5] = 0
    anchors = ints[:, 4:5] + rng.integers(-10, W + 10, (K, A))
    ints[:, 6:] = np.clip(anchors, 0, T - 1)
    lm = rng.integers(-20, 0, K).astype(np.float32)
    out_flat = jnp.asarray(out.reshape(-1))
    jg, jb, ga, ba, sa = jax_store_win(
        jnp.asarray(g0), jnp.asarray(b0), jtabs.loc, jtabs.ent, jtabs.ext,
        jtabs.sidx, jnp.asarray(ints), jnp.asarray(lm), out_flat, W=W, T=T,
        R=R, scan_beam=scan_beam)
    tg = torch.from_numpy(np.concatenate([g0, np.zeros((1, T), np.float32)]))
    tb = torch.from_numpy(np.concatenate([b0, np.zeros((1, T), np.int32)]))
    got = tscan.scan_words_store_win(
        tg, tb, ttabs, torch.from_numpy(ints), torch.from_numpy(lm),
        torch.from_numpy(out), W, scan_beam)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ga), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ba))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(sa), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tg[:CAP].numpy(), np.asarray(jg), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tb[:CAP].numpy(), np.asarray(jb))
    assert (np.asarray(ga) > LOG_ZERO / 2).any()


def test_buckets_match_reference():
    from julius_tpu.search import scan as jscan
    assert tscan.K_BUCKETS == jscan.K_BUCKETS
    assert tscan.W_BUCKETS == jscan.W_BUCKETS
    for k in (1, 16, 17, 1024, 1025, 5000):
        assert tscan.bucket_k(k) == jscan.bucket_k(k)
    for span, t in ((10, 509), (64, 509), (65, 509), (300, 509), (70, 40)):
        assert tscan.bucket_w(span, t) == jscan.bucket_w(span, t)


def test_kernel_wrapper_rejects_what_it_cannot_run():
    """A tensor on neither the CPU nor CUDA, and CUDA-only shapes, are
    refused before anything launches (the shape checks run on the
    card; here the device check)."""
    x = torch.zeros(1, 1, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.scan_core_win(x, x[0], x[0], x[0].int(), x[0], x, x[0, 0].int(),
                          x[0, 0].int())

