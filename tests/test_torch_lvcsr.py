"""Port vs reference: the tied-triphone configuration (`lvcsr_engine`,
the reference's 20k-word dictation shape cut to 400 words and a 2 x 256
matched-filter DNN for the CPU).

Its network has cross-word pseudo phone sets, whose scores are extra
columns of the outprob cache (ops/gmm.py `aggregate_pseudo`), and its
pass 2 resolves word-head triphones against the previous word
(search/iwcd2.py, `strict_iwcd2`) in both the device A* and the host
re-scan.  Each piece runs on the same inputs in both packages:

* `aggregate_pseudo` on the network's own member lists, with integer
  rows full of exact ties and LOG_ZERO members, whole and in small
  chunks: `max` and `best` bit-equal, `avg` (a sum, in another order)
  within atol 1e-5;
* the strict head tables: equal, built by either package;
* the windowed scan with head substitution, `run_batch` and the host
  re-scan with strict heads, on the reference's outprobs and lattices:
  integers equal, scores within atol 1e-4 (atol 1e-5 for one scan);
* whole decodes from features: word ids and `from_pass` equal, scores
  within atol 1e-2 (each package runs its own bf16 DNN).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.ops.gmm import aggregate_pseudo as jax_aggregate
from julius_tpu.search import pass2 as jp2
from julius_tpu.search import pass2_device as jp2d
from julius_tpu.search import pass2_rescan as jp2r
from julius_tpu.search.iwcd2 import build_rc_tables as jax_rc_tables
from julius_tpu.search.scan import scan_words_store_win as jax_store_win
from julius_tpu.tools.synth import lvcsr_engine, make_lvcsr_utts
from julius_tpu_torch.ops import gmm as tgmm
from julius_tpu_torch.search import iwcd2 as tiwcd2
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.search import pass2_rescan as tp2r
from julius_tpu_torch.search import scan as tscan
from julius_tpu_torch.tools import synth as tsynth

from test_torch_engine import assert_same_tables
from test_torch_pass2_device import (assert_same_nbest, converted_engine,
                                     reference_outputs)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=400, hidden=256, n_layers=2)
LOG_ZERO = -1e10


@pytest.fixture(scope="module")
def reference():
    """The reference engine, four generative utterances through its DNN
    and pass 1, and its first decode of them (on a fresh engine, as the
    port's engines below are)."""
    eng, protos = lvcsr_engine(**SIZE)
    truths, wins, lens = make_lvcsr_utts(eng, protos, 4, 120, 11,
                                         min_words=3, max_words=6, seed=11)
    feats, lens, out_ext, trs = reference_outputs(eng, wins, lens)
    res = eng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    return eng, protos, truths, feats, lens, out_ext, trs, res


def lattices(pkg, trs, lens):
    return [pkg.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)]


@pytest.mark.parametrize("chunk", ["whole", "chunked"])
@pytest.mark.parametrize("scheme,nbest", [("max", 1), ("avg", 3),
                                          ("best", 1), ("best", 3)])
def test_aggregate_pseudo_matches_reference(reference, monkeypatch, chunk,
                                            scheme, nbest):
    eng = reference[0]
    mem, seg, nq = (np.asarray(eng._pseudo[0]), np.asarray(eng._pseudo[1]),
                    eng._pseudo[2])
    S = eng.hmm.n_states
    rng = np.random.default_rng(len(scheme) + nbest)
    # integer scores: members of a set-state tie exactly, often
    rows = rng.integers(-6, 0, (2, 7, S)).astype(np.float32)
    rows[rng.random(rows.shape) < 0.3] = LOG_ZERO
    rows[0, 0] = LOG_ZERO                            # a dead frame
    want = np.asarray(jax_aggregate(jnp.asarray(mem), jnp.asarray(seg), nq,
                                    jnp.asarray(rows), scheme, nbest))
    if chunk == "chunked":                           # 3 rows a chunk
        monkeypatch.setattr(tgmm, "CHUNK_BYTES", 3 * 4 * len(mem))
    got = tgmm.aggregate_pseudo(torch.from_numpy(mem), torch.from_numpy(seg),
                                nq, torch.from_numpy(rows), scheme,
                                nbest).numpy()
    assert got.shape == want.shape == (2, 7, nq)
    if scheme == "avg":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == LOG_ZERO).all()
    assert (got > LOG_ZERO / 2).mean() > 0.5


def test_tables_match_reference(reference):
    """The port's own builders give the reference's network, DNN,
    N-gram, chain and pseudo tables, and the same strict head tables,
    which convert.py also carries."""
    eng, protos = reference[:2]
    teng, tprotos = tsynth.lvcsr_engine(device="cpu", **SIZE)
    assert np.array_equal(tprotos, protos)
    assert_same_tables(teng, converted_engine(eng))
    for a, b in zip(teng._pseudo[:2], eng._pseudo[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert teng._pseudo[2] == eng._pseudo[2] > 0
    jt = eng.iwcd2_tables
    for tt in (teng.iwcd2_tables, converted_engine(eng).iwcd2_tables):
        np.testing.assert_array_equal(tt.head_sidx.numpy(),
                                      np.asarray(jt.head_sidx))
        np.testing.assert_array_equal(tt.head_ns.numpy(),
                                      np.asarray(jt.head_ns))
        np.testing.assert_array_equal(tt.lc_of_word, jt.lc_of_word)
        assert tt.n_resolved == jt.n_resolved > 0
        assert tt.H == jt.H
    assert teng.iwcd2_tables.class_of_phone == jt.class_of_phone
    for a, b in zip(tiwcd2.build_rc_tables(teng.net, teng.hmm, teng.voca),
                    jax_rc_tables(eng.net, eng.hmm, eng.voca)):
        np.testing.assert_array_equal(a, b)


def test_strict_scan_matches_reference(reference):
    """One windowed round with head substitution by left-context class
    (classes 0 .. C-1), pad chains included."""
    eng, *_, out_ext, _, _ = reference
    jtabs, jt = eng.device_chains, eng.iwcd2_tables
    teng = converted_engine(eng)
    ttabs, tt = teng.device_chains, teng.iwcd2_tables
    B, T, R = out_ext.shape
    CAP, K, W, A = 24, 16, 64, min(6, T)
    V, C = jtabs.n_words, jt.head_sidx.shape[1]
    rng = np.random.default_rng(5)
    g0 = rng.integers(-300, -100, (CAP, T)).astype(np.float32)
    g0[rng.random((CAP, T)) < 0.3] = LOG_ZERO
    b0 = rng.integers(0, T, (CAP, T)).astype(np.int32)
    ints = np.zeros((K, 6 + A), np.int32)
    ints[:, 0] = rng.integers(0, V, K)
    ints[:, 1] = rng.integers(-1, CAP, K)
    ints[:3, 1] = -1                                  # sentence starts
    ints[:, 2] = rng.integers(0, B, K)
    ints[:, 3] = rng.permutation(CAP)[:K]
    ints[-3:, 3] = CAP                                # pad chains
    ints[-3:, 0] = V
    ints[3:, 4] = rng.integers(0, T - W + 1, K - 3)
    ints[:, 5] = rng.integers(0, C, K)
    ints[:4, 5] = 0
    anchors = ints[:, 4:5] + rng.integers(0, W, (K, A))
    ints[:, 6:] = np.clip(anchors, 0, T - 1)
    lm = rng.integers(-20, 0, K).astype(np.float32)
    out = {}
    for strict in (False, True):
        kw = dict(head_sidx=jt.head_sidx, head_ns=jt.head_ns) if strict \
            else {}
        jg, jb, ga, ba, sa = jax_store_win(
            jnp.asarray(g0), jnp.asarray(b0), jtabs.loc, jtabs.ent,
            jtabs.ext, jtabs.sidx, jnp.asarray(ints), jnp.asarray(lm),
            jnp.asarray(out_ext.reshape(-1)), W=W, T=T, R=R, **kw)
        kw = dict(head_sidx=tt.head_sidx, head_ns=tt.head_ns) if strict \
            else {}
        tg = torch.from_numpy(np.concatenate([g0, np.zeros((1, T),
                                                           np.float32)]))
        tb = torch.from_numpy(np.concatenate([b0, np.zeros((1, T),
                                                           np.int32)]))
        got = tscan.scan_words_store_win(
            tg, tb, ttabs, torch.from_numpy(ints), torch.from_numpy(lm),
            torch.from_numpy(out_ext), W, **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ga),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ba))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(sa),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tg[:CAP].numpy(), np.asarray(jg),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tb[:CAP].numpy(), np.asarray(jb))
        assert (np.asarray(ga) > LOG_ZERO / 2).any()
        out[strict] = got[0].numpy()
    # the head columns changed what the scan read
    assert not np.array_equal(out[False], out[True])


@pytest.mark.parametrize("nbest", [1, 3])
def test_run_batch_strict_matches_reference(reference, monkeypatch, nbest):
    eng, *_, lens, out_ext, trs, _ = reference
    rounds = []

    def counted(*a):
        rounds.append(1)
        return tscan.head_substituted_sidx(*a)

    monkeypatch.setattr(tp2d, "head_substituted_sidx", counted)
    cfg = dataclasses.replace(eng.search_cfg, nbest=nbest)
    want = jp2d.run_batch(
        lattices(jp2, trs, lens), eng.device_chains, eng.ngram_dev,
        eng._wid2lm_p2, eng._cprob_arr(), jnp.asarray(out_ext),
        eng._rescan_strategy(), cfg, iwcd2=eng.iwcd2_tables)
    want_stats = dict(jp2d.LAST_STATS)
    teng = converted_engine(eng, nbest=nbest)
    got = tp2d.run_batch(
        lattices(tp2, trs, lens), teng.device_chains, teng.ngram_dev,
        teng._wid2lm, teng._cprob_arr(), torch.from_numpy(out_ext),
        teng._rescan_strategy(), teng.search_cfg, iwcd2=teng.iwcd2_tables)
    got_stats = dict(tp2d.LAST_STATS)
    assert_same_nbest(got, want)
    assert all(got)
    for key in ("rounds", "n_pops", "max_rounds", "CAPP", "S", "CA", "CK",
                "NA"):
        assert got_stats[key] == want_stats[key], key
    assert len(rounds) == got_stats["rounds"] > 0   # every round strict


def test_rescan_strict_matches_reference(reference):
    eng, *_, lens, out_ext, trs, _ = reference
    jdisp = jp2r.ScanDispatcher(eng.device_chains, jnp.asarray(out_ext),
                                iwcd2=eng.iwcd2_tables)
    want = jp2r.rescan_nbest_batch(lattices(jp2, trs, lens), jdisp,
                                   eng._rescan_strategy(), eng.search_cfg)
    teng = converted_engine(eng)
    tdisp = tp2r.ScanDispatcher(teng.device_chains, torch.from_numpy(out_ext),
                                iwcd2=teng.iwcd2_tables)
    got = tp2r.rescan_nbest_batch(lattices(tp2, trs, lens), tdisp,
                                  teng._rescan_strategy(), teng.search_cfg)
    assert_same_nbest(got, want)
    assert all(got)
    assert tdisp.n_scans == jdisp.n_scans > 0


@pytest.mark.parametrize("build", ["converted", "own_synth"])
def test_decode_matches_reference(reference, build):
    """Whole decodes (pseudo columns, pass 1, device A* with strict
    heads, the spot-check through the host re-scan, N-best)."""
    eng, protos, truths, feats, lens, _, _, ref = reference
    if build == "converted":
        teng = converted_engine(eng)
    else:
        teng, _ = tsynth.lvcsr_engine(device="cpu", **SIZE)
    got = teng.decode_features(feats, lens)
    assert teng.last_pass2["retried"] == 1           # the spot-check
    assert [g.from_pass for g in got] == [r.from_pass for r in ref] \
        == [2, 2, 2, 2]
    for g, r in zip(got, ref):
        assert g.word_ids == r.word_ids
        assert g.score == pytest.approx(r.score, abs=1e-2)
        assert g.am_score == pytest.approx(r.am_score, abs=1e-2)
        assert [s["begin"] for s in g.segments] == \
            [s["begin"] for s in r.segments]
    exact = sum([t for t in g.texts if t]
                == [w for w in truth if w not in ("<s>", "</s>")]
                for g, truth in zip(got, truths))
    assert exact >= 3


def test_decode_outprob_appends_pseudo_columns(reference):
    eng, _, _, feats, lens, _, _, ref = reference
    teng = converted_engine(eng)
    with torch.no_grad():
        out_ext = teng._outprob(torch.from_numpy(feats))
    S = eng.hmm.n_states
    assert out_ext.shape[-1] == S + eng._pseudo[2]
    got = teng.decode_outprob(out_ext[..., :S], lens)
    assert [g.word_ids for g in got] == [r.word_ids for r in ref]
