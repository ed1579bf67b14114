"""Port vs reference: the host-driven re-scan (search/pass2_rescan.py)
and the engine's retry net around the device A*.

* `rescan_nbest_batch` through each package's `ScanDispatcher`, on the
  same lattices and outprob cache (the reference engine's, as in
  test_torch_pass2_device.py): N-best word ids, bounds and scan counts
  equal, scores within atol 1e-4.
* The retry net: `run_batch` is patched in BOTH packages to return
  nothing for one utterance, and both engines must re-run that one on
  the host path and agree.
* The configurations the engine sends to the host re-scan
  (`pass2_device=False`, `nbest > NB_SLOTS`, transparent words) decode
  features to the reference's word ids and `from_pass`; scores within
  atol 1e-2, since here each package runs its own DNN (the scores agree
  to a few 1e-6 a frame and a decode sums a few hundred of them).
* One dispatch: `_pass2_result` on one utterance gives what a decode of
  that utterance alone gives, through the device A*, the host re-scan
  and the frozen search; an utterance without a finite pass-1 word end
  at its last frame gets no device N-best, so the one retry net treats
  it as empty, as the reference's per-utterance net does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.engine import Engine as JaxEngine
from julius_tpu.search import pass2 as jp2
from julius_tpu.search import pass2_device as jp2d
from julius_tpu.search import pass2_rescan as jp2r
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.search import pass2_rescan as tp2r

from julius_tpu.tools.synth import flagship_engine

from test_torch_pass2_device import (assert_same_nbest, converted_engine,
                                     reference_batch)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


@pytest.fixture(scope="module")
def reference():
    eng, protos = flagship_engine(trained=True, **SIZE)
    return eng, reference_batch(eng, protos, 3, 2, 5, seed=1)


@pytest.mark.parametrize("nbest", [1, 3])
def test_rescan_nbest_batch_matches_reference(reference, nbest):
    eng, (_, _, lens, out_ext, trs) = reference
    cfg = dataclasses.replace(eng.search_cfg, nbest=nbest)
    jdisp = jp2r.ScanDispatcher(eng.device_chains, jnp.asarray(out_ext))
    want = jp2r.rescan_nbest_batch(
        [jp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        jdisp, eng._rescan_strategy(), cfg)
    teng = converted_engine(eng, nbest=nbest)
    tdisp = tp2r.ScanDispatcher(teng.device_chains, torch.from_numpy(out_ext))
    chunks = tp2r.CHUNKS
    got = tp2r.rescan_nbest_batch(
        [tp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        tdisp, teng._rescan_strategy(), teng.search_cfg)
    assert_same_nbest(got, want)
    assert all(got)
    assert tdisp.n_scans == jdisp.n_scans > 0
    assert tp2r.CHUNKS > chunks
    np.testing.assert_array_equal(tdisp.fmax, jdisp.fmax)


def test_dispatcher_store_grows_past_its_capacity(reference):
    """A dispatcher made too small grows its row store (keeping the sink
    row last) and still returns the reference's results."""
    eng, (_, _, lens, out_ext, trs) = reference
    teng = converted_engine(eng)
    lats = [tp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)]
    big = tp2r.rescan_nbest_batch(
        lats, tp2r.ScanDispatcher(teng.device_chains,
                                  torch.from_numpy(out_ext)),
        teng._rescan_strategy(), teng.search_cfg)
    small = tp2r.ScanDispatcher(teng.device_chains, torch.from_numpy(out_ext),
                                cap=64)
    got = tp2r.rescan_nbest_batch(lats, small, teng._rescan_strategy(),
                                  teng.search_cfg)
    assert small.pool.cap > 64
    assert small.g_store.shape[0] == small.pool.cap + 1
    assert_same_nbest(got, big)


def test_retry_net_reruns_an_empty_utterance_on_the_host(reference,
                                                         monkeypatch):
    eng, (_, feats, lens, _, _) = reference
    teng = converted_engine(eng)

    def drop_one(real):
        def run(lattices, *args, **kw):
            out = real(lattices, *args, **kw)
            out[1] = []
            return out
        return run

    monkeypatch.setattr(jp2d, "run_batch", drop_one(jp2d.run_batch))
    monkeypatch.setattr(tp2d, "run_batch", drop_one(tp2d.run_batch))
    want = eng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    chunks = tp2r.CHUNKS
    got = teng.decode_features(feats, lens)
    assert teng.last_pass2["retried"] == 1
    assert tp2r.CHUNKS > chunks
    assert [r.from_pass for r in want] == [r.from_pass for r in got] \
        == [2, 2, 2]
    for g, w in zip(got, want):
        assert g.word_ids == w.word_ids
        assert g.score == pytest.approx(w.score, abs=1e-2)


def transparent_engines(eng, word):
    voca = dataclasses.replace(eng.voca, transparent=[
        i == word for i in range(eng.voca.n_words)])
    jeng = JaxEngine(eng.hmm, voca, eng.lm, dnn=eng.dnn_params,
                     frontend=eng.fe_cfg, search=eng.search_cfg)
    teng = converted_engine(jeng)
    return jeng, teng


@pytest.mark.parametrize("case", ["host_rescan", "nbest_past_slots",
                                  "transparent"])
def test_host_rescan_decodes_like_reference(reference, case):
    eng, (truths, feats, lens, _, _) = reference
    if case == "transparent":
        jeng, teng = transparent_engines(eng, 96)
    else:
        search = (dict(pass2_device=False) if case == "host_rescan"
                  else dict(nbest=tp2d.NB_SLOTS + 1))
        jeng = eng
        saved = eng.search_cfg
        eng.search_cfg = dataclasses.replace(saved, **search)
        teng = converted_engine(eng)
    try:
        assert not teng._device_astar_ok()
        want = jeng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    finally:
        if case != "transparent":
            eng.search_cfg = saved
    before = dict(tp2d.LAST_STATS)
    got = teng.decode_features(feats, lens)
    assert tp2d.LAST_STATS == before                  # no device A* ran
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    assert 2 in [r.from_pass for r in got]
    for g, w in zip(got, want):
        assert g.word_ids == w.word_ids
        assert g.score == pytest.approx(w.score, abs=1e-2)
        assert [n.word_ids for n in g.nbest] == \
            [n.word_ids for n in w.nbest]


@pytest.mark.parametrize("device_astar", [True, False])
def test_single_utterance_pass2_matches_reference(reference, device_astar):
    """`_pass2_result` with a one-utterance outprob cache (the per-
    utterance entry to the device A* and its net, or the host re-scan)
    on the reference's own outprobs and trellis."""
    eng, (_, _, lens, out_ext, trs) = reference
    saved = eng.search_cfg
    eng.search_cfg = dataclasses.replace(saved, pass2_device=device_astar)
    teng = converted_engine(eng)
    n = int(lens[0])
    one = out_ext[:1, :n]
    try:
        want = eng._pass2_result(trs[0], n, out_ext=jnp.asarray(one))
        got = teng._pass2_result(trs[0], n, out_ext=torch.from_numpy(one))
    finally:
        eng.search_cfg = saved
    assert got.from_pass == want.from_pass == 2
    assert got.word_ids == want.word_ids
    assert got.score == pytest.approx(want.score, abs=1e-4)
    assert got.segments == want.segments


@pytest.mark.parametrize("search", [dict(), dict(pass2_device=False),
                                    dict(pass2_rescan=False)],
                         ids=["device_astar", "host_rescan", "frozen"])
def test_single_utterance_pass2_equals_a_decode_of_one(reference, search):
    """`_pass2_result` on an utterance's own outprob cache and trellis
    gives the pass-2 result that `decode_features` gives for a batch of
    that one utterance: both go through `Engine._pass2`."""
    eng, (_, feats, lens, _, _) = reference
    teng = converted_engine(eng, **search)
    n = int(lens[1])
    one = feats[1:2, :n]
    want = teng.decode_features(one, [n])[0]
    net = teng.last_pass2
    with torch.no_grad():
        out_ext = teng._outprob(torch.from_numpy(one))
        tr = teng._pass1(out_ext, [n])
    tb = tp1.Trellis(*[a[0].numpy() for a in tr])
    teng.last_pass2 = None
    got = teng._pass2_result(tb, n, out_ext=out_ext)
    if search:
        assert teng.last_pass2 is None
    else:                        # the device A*'s net ran and says so
        assert teng.last_pass2["retried"] == net["retried"]
    assert got.from_pass == want.from_pass == 2
    for g, w in zip([got] + got.nbest, [want] + want.nbest):
        assert (g.word_ids, g.score, g.am_score, g.lm_score, g.segments) \
            == (w.word_ids, w.score, w.am_score, w.lm_score, w.segments)
    assert len(got.nbest) == len(want.nbest)


@pytest.mark.parametrize("final_frame", ["no_score", "no_word_end"])
def test_no_final_word_end_gives_no_device_nbest(reference, final_frame):
    """Where the pass-1 margin is not sound (here the passes weigh the
    LM differently), an utterance without a finite pass-1 word end at its
    last frame gets no device N-best: every suffix estimate, every seed
    and every candidate needs a finite chain to that frame.  So the one
    retry net re-runs it on the host as an empty utterance, never as a
    spot check, and `_pass2_result` agrees with the reference's."""
    eng, (_, _, lens, out_ext, trs) = reference
    saved = eng.search_cfg
    eng.search_cfg = dataclasses.replace(saved, lm_weight2=saved.lm_weight
                                         + 1.0)
    teng = converted_engine(eng)
    n = int(lens[0])
    one = out_ext[:1, :n]
    tr = tp1.Trellis(*[np.array(a) for a in trs[0]])
    if final_frame == "no_score":
        tr.score[n - 1] = -np.inf
    else:
        tr.word[n - 1] = -1
    try:
        want = eng._pass2_result(tr, n, out_ext=jnp.asarray(one))
    finally:
        eng.search_cfg = saved
    lat = tp2.TrellisLattice(tr, n)
    assert tp2d.run_batch(
        [lat], teng.device_chains, teng.ngram_dev, teng._wid2lm_p2,
        teng._cprob_arr(), torch.from_numpy(one), teng._rescan_strategy(),
        teng.search_cfg) == [[]]
    got = teng._pass2_result(tr, n, out_ext=torch.from_numpy(one))
    assert teng.last_pass2["retried"] == 1 and teng._p2d_spot_ok == 0
    assert (got is None) == (want is None)
    if got is not None:
        assert got.word_ids == want.word_ids
        assert got.score == pytest.approx(want.score, abs=1e-4)
