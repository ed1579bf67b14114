"""Port vs reference: the whole slice, features in, N-best out.

The flagship DNN-HMM engine at a small size (120 words, 48 phones, a
2 x 128 matched-filter DNN, which trained utterances need), pass 2 the
frozen-score stack search (`pass2_rescan=False`) in both packages.  The
port's engine is built two ways: from the reference engine's own arrays
carried across by convert.py, and from the port's copy of the synth
builders, whose tables must then equal the reference's.  Word ids and
`from_pass` must be equal (two of these three utterances fall back to
the pass-1 result in the reference, the third comes from pass 2).
Scores are held to atol 1e-2: the DNN scores agree to a few 1e-6 here
and the trellis sums a few hundred of them."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.tools.synth import flagship_engine, make_flagship_utts
from julius_tpu_torch import convert
from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.tools import synth as tsynth

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


@pytest.fixture(scope="module")
def reference():
    eng, protos = flagship_engine(trained=True, **SIZE)
    eng.search_cfg = dataclasses.replace(eng.search_cfg, pass2_rescan=False)
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11,
        min_words=2, max_words=5, seed=1)
    feats = np.zeros((3, max(lens), 120 * 11), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    lens = np.asarray(lens, np.int32)
    res = eng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    assert sorted(r.from_pass for r in res) == [1, 1, 2]
    return eng, protos, truths, feats, lens, res


def converted_engine(eng):
    teng = Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                  search=SearchConfig(**dataclasses.asdict(eng.search_cfg)),
                  device="cpu")
    convert.load_tables(teng, convert.numpy_fields(eng.dnn_scorer),
                        convert.numpy_fields(eng.dev_net),
                        convert.numpy_fields(eng.ngram_dev))
    return teng


def assert_same_tables(a, b):
    for name in tp1.NETWORK_FIELDS:
        assert torch.equal(getattr(a.dev_net, name),
                           getattr(b.dev_net, name)), name
    assert a.dev_net.local_k == b.dev_net.local_k
    for name in ("uni", "bo_uni", "bi_rows"):
        assert torch.equal(getattr(a.ngram_dev, name),
                           getattr(b.ngram_dev, name)), name
    for x, y in zip(a.dnn_scorer.parameters(), b.dnn_scorer.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("build", ["converted", "own_synth"])
def test_decode_matches_reference(reference, build):
    eng, protos, truths, feats, lens, ref = reference
    if build == "converted":
        teng = converted_engine(eng)
    else:
        teng, tprotos = tsynth.flagship_engine(trained=True, device="cpu",
                                               **SIZE)
        assert np.array_equal(tprotos, protos)
        assert_same_tables(teng, converted_engine(eng))
    got = teng.decode_features(feats, lens)
    assert len(got) == len(ref)
    for g, r, truth in zip(got, ref, truths):
        assert g.valid and r.valid
        assert g.word_ids == r.word_ids
        assert g.from_pass == r.from_pass
        assert g.score == pytest.approx(r.score, abs=1e-2)
        assert g.am_score == pytest.approx(r.am_score, abs=1e-2)
        assert g.lm_score == pytest.approx(r.lm_score, abs=1e-2)
        assert [s["begin"] for s in g.segments] == \
            [s["begin"] for s in r.segments]
        assert [t for t in g.texts if t] == \
            [w for w in truth if w not in ("<s>", "</s>")]


def test_decode_outprob_matches_decode_features(reference):
    eng, _, _, feats, lens, ref = reference
    teng = converted_engine(eng)
    rows = teng._outprob(torch.from_numpy(feats))
    got = teng.decode_outprob(rows, lens)
    assert [g.word_ids for g in got] == [r.word_ids for r in ref]


def test_engine_needs_cuda_unless_cpu_is_asked(reference, monkeypatch):
    eng = reference[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params)


def test_configurations_outside_the_slice_raise(reference):
    eng = reference[0]
    teng = converted_engine(eng)
    teng.search_cfg = dataclasses.replace(teng.search_cfg, pass2_rescan=True)
    with pytest.raises(NotImplementedError, match="device A"):
        teng.decode_features(reference[3], reference[4])
    with pytest.raises(NotImplementedError, match="front end"):
        teng.recognize_batch(np.zeros((1, 1600), np.float32), [1600])
    with pytest.raises(NotImplementedError, match="GMM"):
        Engine(eng.hmm, eng.voca, eng.lm, device="cpu")
    with pytest.raises(NotImplementedError, match="factoring"):
        Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
               search=SearchConfig(factoring=2), device="cpu")
