"""Port vs reference: the whole slice, features in, N-best out.

The flagship DNN-HMM engine at a small size (120 words, 48 phones, a
2 x 128 matched-filter DNN, which trained utterances need), with pass 2
in two configurations, each the same in both packages: the reference's
default (the device A* re-scan with its retry net; all three utterances
come from pass 2), and the frozen-score stack search
(`pass2_rescan=False`; two of the three utterances fall back to the
pass-1 result, the third comes from pass 2).  The port's engine is
built two ways: from the reference engine's own arrays carried across
by convert.py, and from the port's copy of the synth builders, whose
tables must then equal the reference's.  Factoring 2 and the score
envelope, which take pass 1's unfused step, decode like the reference
too.  Word ids and `from_pass` must be equal.  Scores are held to atol
1e-2: the DNN scores agree to a few 1e-6 here and a decode sums a few
hundred of them."""

import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.engine import Engine as JaxEngine
from julius_tpu.tools.synth import flagship_engine, make_flagship_utts
from julius_tpu_torch import convert
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.search import scan as tscan
from julius_tpu_torch.tools import synth as tsynth

from test_torch_pass2_device import converted_engine
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
FROZEN = dict(pass2_rescan=False)


@pytest.fixture(scope="module")
def reference():
    """The reference engine in its frozen-score configuration, its
    frozen decode of three utterances, and (last) its decode of the
    same features with the default configuration."""
    eng, protos = flagship_engine(trained=True, **SIZE)
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11,
        min_words=2, max_words=5, seed=1)
    feats = np.zeros((3, max(lens), 120 * 11), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    lens = np.asarray(lens, np.int32)
    default = eng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    assert [r.from_pass for r in default] == [2, 2, 2]
    eng.search_cfg = dataclasses.replace(eng.search_cfg, **FROZEN)
    res = eng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    assert sorted(r.from_pass for r in res) == [1, 1, 2]
    return eng, protos, truths, feats, lens, res, default


def assert_same_tables(a, b):
    for name in tp1.NETWORK_FIELDS:
        x, y = getattr(a.dev_net, name), getattr(b.dev_net, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    assert a.dev_net.local_k == b.dev_net.local_k
    for name in ("uni", "bo_uni", "bi_rows"):
        assert torch.equal(getattr(a.ngram_dev, name),
                           getattr(b.ngram_dev, name)), name
    for x, y in zip(a.dnn_scorer.parameters(), b.dnn_scorer.parameters()):
        assert torch.equal(x, y)
    for name in tscan.CHAIN_FIELDS:
        assert torch.equal(getattr(a.device_chains, name),
                           getattr(b.device_chains, name)), name


def port_engine(reference, build, **search):
    eng, protos = reference[:2]
    if build == "converted":
        return converted_engine(eng, **search)
    teng, tprotos = tsynth.flagship_engine(trained=True, device="cpu",
                                           **SIZE)
    assert np.array_equal(tprotos, protos)
    assert_same_tables(teng, converted_engine(eng))
    teng.search_cfg = dataclasses.replace(teng.search_cfg, **search)
    return teng


@pytest.mark.parametrize("build", ["converted", "own_synth"])
def test_decode_matches_reference(reference, build):
    eng, protos, truths, feats, lens, ref, _ = reference
    teng = port_engine(reference, build, **FROZEN)
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


@pytest.mark.parametrize("build", ["converted", "own_synth"])
def test_default_decode_matches_reference(reference, build):
    """The reference's default pass 2: device A* and retry net."""
    _, _, truths, feats, lens, _, ref = reference
    teng = port_engine(reference, build, pass2_rescan=True)
    assert teng._device_astar_ok()
    got = teng.decode_features(feats, lens)
    assert [g.from_pass for g in got] == [r.from_pass for r in ref] \
        == [2, 2, 2]
    assert teng.last_pass2["retried"] == 0
    for g, r, truth in zip(got, ref, truths):
        assert g.word_ids == r.word_ids
        assert g.score == pytest.approx(r.score, abs=1e-2)
        assert g.am_score == pytest.approx(r.am_score, abs=1e-2)
        assert g.lm_score == pytest.approx(r.lm_score, abs=1e-2)
        assert [s["begin"] for s in g.segments] == \
            [s["begin"] for s in r.segments]
        assert [t for t in g.texts if t] == \
            [w for w in truth if w not in ("<s>", "</s>")]


def test_decode_outprob_matches_decode_features(reference):
    eng, _, _, feats, lens, ref, _ = reference
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
    """The port has every configuration of the reference now: the one
    left that raises, a backward (RL) N-gram with no forward 2-gram for
    pass 1, raises the reference's ValueError; a forward LM with an
    lm_forward beside it builds, and pass 1 runs the LM itself."""
    eng = reference[0]
    rl = tsynth.backward_ngram(eng.lm)
    for E in (JaxEngine, lambda *a, **k: Engine(*a, **k, device="cpu")):
        with pytest.raises(ValueError, match="needs a forward 2-gram"):
            E(eng.hmm, eng.voca, rl, dnn=eng.dnn_params)
    teng = Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                  lm_forward=rl, device="cpu")
    assert teng.lm is teng.lm_p1 is eng.lm
    assert teng._wid2lm_p2 is teng._wid2lm


def test_engine_takes_the_reference_arguments_in_order():
    """The reference's arguments in the reference's order, `device` a
    keyword after them."""
    want = list(inspect.signature(JaxEngine).parameters)
    got = inspect.signature(Engine).parameters
    assert list(got)[:-1] == want
    assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("search", [dict(factoring=2),
                                    dict(beam_width=400)],
                         ids=["factoring2", "envelope"])
def test_unfused_configurations_decode_like_reference(reference, search):
    """Factoring 2 and the score envelope take pass 1's unfused step in
    both packages; the default pass 2 after it."""
    eng, _, truths, feats, lens, _, _ = reference
    jeng = JaxEngine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                     frontend=eng.fe_cfg, search=dataclasses.replace(
                         eng.search_cfg, pass2_rescan=True, **search))
    teng = converted_engine(jeng)
    assert not tp1.fused_ok(teng.dev_net, teng.p1_cfg)
    want = jeng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    got = teng.decode_features(feats, lens)
    assert [g.from_pass for g in got] == [w.from_pass for w in want]
    for g, w in zip(got, want):
        assert g.word_ids == w.word_ids
        assert g.score == pytest.approx(w.score, abs=1e-2)
        assert [s["begin"] for s in g.segments] == \
            [s["begin"] for s in w.segments]


def test_graph_outputs_take_the_host_rescan(reference):
    """-lattice / -confnet / search-time CM collect the pass-2 word graph
    in the host re-scan, never the device A*; MBR re-orders the N-best."""
    _, _, truths, feats, lens, _, ref = reference
    eng = reference[0]
    teng = converted_engine(eng, pass2_rescan=True, graph_out=True,
                            confnet_out=True, cm_search=True, mbr=True,
                            nbest=2)
    assert not teng._device_astar_ok() and teng._rescan_ok()
    got = teng.decode_features(feats, lens)
    for g, r in zip(got, ref):
        assert g.word_ids == r.word_ids and g.from_pass == 2
        assert g.graph is not None and len(g.graph) > 0
        assert g.confnet and g.cm is not None
        assert len(g.cm) == len(g.word_ids)
        assert all(0.0 <= c <= 1.0 + 1e-6 for c in g.cm)
