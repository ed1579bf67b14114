"""Port vs reference: the full-utterance word scan (search/scan.py
`ChainCache`, `scan_words`, `scan_words_store`, the engine's
`chain_cache`).

The reference runs these only from its tests; the port runs them as one
launch of the windowed scan with every window at frame 0 and W = T.
Both packages scan the same host chain rows (`ChainCache`, bit-equal to
the whole-vocabulary `DeviceChainTables` rows) over the same random
outprobs, with pad chains (word id -1, or the dead row V), seeds at
frame 0 only (parents < 0), the scan beam, and out-of-range anchors and
output rows, which JAX reads as NaN / drops and the port must too.
Integer outputs are equal and scores within atol 1e-5 (the scan only
adds and compares floats)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search import scan as jscan
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch.ops import scan_kernel as tsk
from julius_tpu_torch.search import scan as tscan
from julius_tpu_torch.search.network import build_network
from julius_tpu_torch.tools.synth import flagship_engine as tflagship

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
LOG_ZERO = -1e10
B, T = 3, 70


@pytest.fixture(scope="module")
def setup():
    eng, _ = flagship_engine(trained=True, **SIZE)
    net = build_network(eng.hmm, eng.voca, use_triphone=False)
    return eng, net


def outprobs(seed, R):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 3, (B, T, R)).astype(np.float32)


def test_chain_cache_rows_match_reference_and_device_tables(setup):
    eng, net = setup
    wids = [5, -1, 0, 119, 5, 40, -1]
    want = jscan.ChainCache(eng.net).rows(wids)
    cache = tscan.ChainCache(net)
    got = cache.rows(wids)
    dev = tscan.DeviceChainTables(net, "cpu")
    assert (cache.kl, cache.nmax) == (dev.kl, dev.nmax) == (1, 21)
    rows = torch.as_tensor([w if w >= 0 else dev.n_words for w in wids])
    for g, w, name in zip(got, want, ("loc", "ent", "ext", "sidx")):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
        assert np.array_equal(g, getattr(dev, name)[rows].numpy()), name
    # lazy: a word's rows are built once and kept
    assert sorted(cache._rows) == [0, 5, 40, 119]


def test_engine_chain_cache_is_lazy_and_kept():
    eng, _ = tflagship(trained=True, device="cpu", **SIZE)
    assert eng._chain_cache is None
    cache = eng.chain_cache
    assert isinstance(cache, tscan.ChainCache) and eng.chain_cache is cache
    assert cache.nmax == eng.device_chains.nmax


def test_scan_words_matches_reference_and_oracle(setup):
    eng, net = setup
    R = eng.net.n_score_rows
    out = outprobs(3, R)
    rng = np.random.default_rng(4)
    wids = [2, 3, -1, 40, 7, 2, 100, -1, 55]
    K = len(wids)
    bidx = rng.integers(0, B, K).astype(np.int32)
    seed = rng.integers(-60, -20, (K, T)).astype(np.float32)
    seed[rng.random((K, T)) < 0.7] = LOG_ZERO
    seed[:, 10:25] = LOG_ZERO
    loc, ent, ext, sidx = tscan.ChainCache(net).rows(wids)
    jg, jb = jscan.scan_words(*(jnp.asarray(a) for a in (
        loc, ent, ext, sidx, seed, bidx, out)))
    before = tsk.LAUNCHES
    g, beg = tscan.scan_words(*(torch.from_numpy(a) for a in (
        loc, ent, ext, sidx, seed, bidx, out)))
    assert tsk.LAUNCHES == before          # CPU tensors: the plain version
    assert g.shape == (K, T) and beg.dtype == torch.int32
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(beg.numpy(), np.asarray(jb))
    # dead pad chains score LOG_ZERO at every frame
    assert (g.numpy()[np.asarray(wids) < 0] == LOG_ZERO).all()
    live = 0
    for k in range(K):
        gr, br = tscan.scan_words_ref(loc[k], ent[k], ext[k], sidx[k],
                                      seed[k], out[bidx[k]])
        fin = gr > LOG_ZERO / 2
        live += fin.sum()
        np.testing.assert_allclose(g[k].numpy()[fin], gr[fin], atol=1e-5,
                                   rtol=0)
        assert (g[k].numpy()[~fin] <= LOG_ZERO / 2).all()
        np.testing.assert_array_equal(beg[k].numpy()[fin], br[fin])
    assert live > 0


@pytest.mark.parametrize("scan_beam", [0.0, 6.0])
def test_scan_words_store_matches_reference(setup, scan_beam):
    """One round: parents < 0 seed frame 0 only, pad chains (the dead
    row V and an id -1, which JAX wraps to V), output rows past the store
    and below it (dropped, or wrapped once as JAX does) and anchors out
    of range (NaN / the int32 minimum as JAX reads them)."""
    eng, net = setup
    jtabs = eng.device_chains
    ttabs = tscan.DeviceChainTables(net, "cpu")
    V = ttabs.n_words
    R = eng.net.n_score_rows
    out = outprobs(5, R)
    CAP, K, A = 20, 12, 5
    rng = np.random.default_rng(6 + int(scan_beam))
    g0 = rng.integers(-80, -10, (CAP, T)).astype(np.float32)
    g0[rng.random((CAP, T)) < 0.5] = LOG_ZERO
    b0 = rng.integers(0, T, (CAP, T)).astype(np.int32)
    wids = rng.integers(0, V, K).astype(np.int32)
    wids[-2] = V
    wids[-1] = -1
    parents = rng.integers(0, CAP, K).astype(np.int32)
    parents[:3] = -1                                  # sentence starts
    lm = rng.integers(-20, 0, K).astype(np.float32)
    bidx = rng.integers(0, B, K).astype(np.int32)
    out_rows = rng.permutation(CAP - 2)[:K].astype(np.int32)
    out_rows[-2] = CAP                                # past the store
    out_rows[-1] = -CAP - 1                           # below it
    out_rows[4] = -1                                  # wraps to CAP - 1
    anchors = rng.integers(0, T, (K, A)).astype(np.int32)
    anchors[0, 0] = T + 3
    anchors[1, 1] = -1                                # wraps to T - 1
    anchors[2, 2] = -T - 2
    args = (wids, parents, lm, bidx, out_rows, anchors, out)
    want = jscan.scan_words_store(
        jnp.asarray(g0), jnp.asarray(b0), jtabs.loc, jtabs.ent, jtabs.ext,
        jtabs.sidx, *(jnp.asarray(a) for a in args), scan_beam=scan_beam)
    tg, tb = torch.from_numpy(g0.copy()), torch.from_numpy(b0.copy())
    got = tscan.scan_words_store(
        tg, tb, ttabs.loc, ttabs.ent, ttabs.ext, ttabs.sidx,
        *(torch.from_numpy(a) for a in args), scan_beam=scan_beam)
    assert got[0] is tg and got[1] is tb        # written in place
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    for i in (2, 4):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, rtol=0,
                                   equal_nan=True)
    np.testing.assert_array_equal(got[3], want[3])
    assert np.isnan(got[2][0, 0]) and np.isnan(got[2][2, 2])
    assert got[3][0, 0] == np.iinfo(np.int32).min
    assert not np.isnan(got[2][1, 1])
    # no chain writes row CAP - 2 (the dropped writes went nowhere);
    # the wrapped -1 wrote row CAP - 1
    assert np.array_equal(got[0][CAP - 2], g0[CAP - 2])
    assert not np.array_equal(got[0][CAP - 1], g0[CAP - 1])
    assert (want[2][np.isfinite(want[2])] > LOG_ZERO / 2).any()
