"""Port vs reference: forced alignment (search/align.py, the engine's
-walign / -palign / -salign and their lines in the command line's
result block).

The same models and frames (numpy, from seeds) go through both
packages, on three engines: GMM monophones built from the same model
texts, the flagship DNN-HMM at a small size, and the tied-triphone
configuration at a small size (pseudo set-states in the chain), the
last two computing from the reference engine's own tables carried
across by convert.py:

* `build_chain`: every table equal;
* `viterbi_chain` on the same [T, R] outprob rows: backpointers and the
  best final node equal, the score within atol 1e-4 (sums of the same
  float32 terms);
* `forced_align` and the engine's alignment of each decoded result:
  word, phone and state segments equal, the score within atol 1e-2
  (the GMM and DNN scores of the two packages agree to 1e-4 a frame),
  or rtol 1e-6 where it is larger (noise waveforms score near -5e4,
  where a float32 step is 0.004);
* `result_block`'s alignment lines equal.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.config import FrontendConfig as JFrontendConfig
from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.search import align as jalign
from julius_tpu.tools import recognize as jrec
from julius_tpu.tools.synth import (flagship_engine, lvcsr_engine,
                                    make_flagship_utts, make_lvcsr_utts)
from julius_tpu_torch.config import FrontendConfig, SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.io.arpa import parse_arpa
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.search import align as talign
from julius_tpu_torch.tools import recognize as trec

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
from test_torch_pass2_device import converted_engine
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

ALIGN = dict(align_word=True, align_phoneme=True, align_state=True)
SCORE_ATOL = 1e-2


def mono_engines(dim, **search):
    """GMM monophone engines of both packages from the same texts."""
    texts = (make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=dim,
                               n_states=3, n_mix=2),
             make_dict_text(), make_arpa_text())
    out = []
    for parse_hmm, Voca, parse_dict, parse_lm, Eng, Fe, Search, kw in (
            (parse_hmmdefs_text, Vocabulary, parse_dict_line, parse_arpa,
             Engine, FrontendConfig, SearchConfig, dict(device="cpu")),
            (jparse_hmm, JVocabulary, jparse_dict, jparse_arpa, JEngine,
             JFrontendConfig, JSearchConfig, {})):
        voca = Voca()
        for line in texts[1].splitlines():
            parse_dict(line, voca)
        out.append(Eng(parse_hmm(texts[0]), voca,
                       parse_lm(io.StringIO(texts[2])),
                       frontend=Fe(cmn=False),
                       search=Search(lm_weight=2.0, **search), **kw))
    return out


@pytest.fixture(scope="module")
def mono():
    """(port engine, reference engine, word ids, frames) of a GMM
    monophone utterance made from the model itself."""
    teng, jeng = mono_engines(4)
    ids = [jeng.voca.names.index(w) for w in ("<s>", "AB", "BA", "</s>")]
    pids = [jeng.hmm.phone_index[p] for w in ids
            for p in jeng.voca.phones[w]]
    frames, _ = sample_states_and_frames(jeng.hmm, pids,
                                         np.random.default_rng(0))
    return teng, jeng, ids, frames.astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    """The small flagship engines (the port's from the reference's
    tables) and three generative utterances: (port, reference, truths as
    word ids, padded windows, lengths)."""
    eng, protos = flagship_engine(trained=True, n_words=120, n_phones=48,
                                  hidden=128, n_layers=2)
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11, min_words=2,
        max_words=5, seed=1)
    return converted_engine(eng), eng, truths, wins, lens


@pytest.fixture(scope="module")
def lvcsr():
    eng, protos = lvcsr_engine(n_words=400, hidden=256, n_layers=2)
    truths, wins, lens = make_lvcsr_utts(eng, protos, 2, 120, 11,
                                         min_words=3, max_words=5, seed=11)
    return converted_engine(eng), eng, truths, wins, lens


def word_ids(voca, names):
    index = {n: i for i, n in enumerate(voca.names)}
    return [index[n] for n in names]


def cases(request):
    """(port engine, reference engine, [(word ids, frames)]) of one
    parametrised configuration."""
    if request.param == "mono":
        teng, jeng, ids, frames = request.getfixturevalue("mono")
        return teng, jeng, [(ids, frames)]
    teng, jeng, truths, wins, _ = request.getfixturevalue(request.param)
    return teng, jeng, [(word_ids(jeng.voca, t), w)
                        for t, w in zip(truths, wins)]


@pytest.fixture(params=["mono", "flagship", "lvcsr"])
def engines(request):
    return cases(request)


def assert_same_chain(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f.name
        else:
            assert a == b, f.name


def assert_same_alignment(got, want):
    assert got.words == want.words
    assert got.phones == want.phones
    assert got.states == want.states
    assert got.score == pytest.approx(want.score, abs=SCORE_ATOL, rel=1e-6)


def test_build_chain_matches_reference(engines):
    teng, jeng, utts = engines
    for ids, _ in utts:
        for tri in (None, False):
            got = talign.build_chain(jeng.hmm, jeng.voca, ids,
                                     use_triphone=tri,
                                     pseudo=jeng.net.pseudo)
            want = jalign.build_chain(jeng.hmm, jeng.voca, ids,
                                      use_triphone=tri,
                                      pseudo=jeng.net.pseudo)
            assert_same_chain(got, want)
    assert np.array_equal(
        talign.build_chain(teng.hmm, teng.voca, utts[0][0],
                           pseudo=teng.net.pseudo).score_idx,
        jalign.build_chain(jeng.hmm, jeng.voca, utts[0][0],
                           pseudo=jeng.net.pseudo).score_idx)


@pytest.mark.parametrize("cut", [0, 7])
def test_viterbi_chain_matches_reference(engines, cut):
    """The same outprob rows (the reference scorer's) through both
    Viterbis; `cut` frames at the end lie past n_frames, where the scores
    freeze and every node points at itself."""
    _, jeng, utts = engines
    for ids, frames in utts:
        chain = jalign.build_chain(jeng.hmm, jeng.voca, ids,
                                   pseudo=jeng.net.pseudo)
        out_ext = np.asarray(jeng._outprob_jit(jnp.asarray(frames)[None])[0])
        n = out_ext.shape[0] - cut
        args = [chain.score_idx, chain.in_src, chain.in_lp, chain.entry_lp,
                chain.exit_lp]
        ws, wbp, wbest = jalign.viterbi_chain(
            *[jnp.asarray(a) for a in args], jnp.asarray(out_ext),
            jnp.asarray(n))
        gs, gbp, gbest = talign.viterbi_chain(
            *[torch.as_tensor(a) for a in args], torch.as_tensor(out_ext), n)
        assert np.array_equal(gbp.numpy(), np.asarray(wbp))
        assert int(gbest) == int(wbest)
        assert float(gs) == pytest.approx(float(ws), abs=1e-4)
        assert np.isfinite(float(gs))


def test_forced_align_matches_reference(engines):
    teng, jeng, utts = engines
    for ids, frames in utts:
        T = frames.shape[0]
        got = teng.align(frames, T, ids)
        want = jeng.align(jnp.asarray(frames), T, ids)
        assert_same_alignment(got, want)
        assert [w["word"] for w in got.words] == \
            [jeng.voca.names[w] for w in ids]
        assert got.words[0]["begin"] == 0 and got.words[-1]["end"] == T - 1
        for a, b in zip(got.words, got.words[1:]):
            assert b["begin"] == a["end"] + 1


def test_alignment_recovers_true_boundaries(mono):
    """Viterbi alignment on model-generated frames lands phone
    boundaries within 3 frames of the generating ones (the reference's
    own test of the same)."""
    teng = mono[0]
    ids = word_ids(teng.voca, ["<s>", "ABC", "</s>"])
    rng = np.random.default_rng(1)
    pids = [teng.hmm.phone_index[p] for w in ids for p in teng.voca.phones[w]]
    parts = [sample_states_and_frames(teng.hmm, [p], rng)[0] for p in pids]
    frames = np.concatenate(parts).astype(np.float32)
    al = teng.align(frames, frames.shape[0], ids)
    want_ends = np.cumsum([len(p) for p in parts]) - 1
    got_ends = [p["end"] for p in al.phones]
    assert len(got_ends) == len(want_ends)
    for g, w in zip(got_ends[:-1], want_ends[:-1]):
        assert abs(g - w) <= 3, (g, w)
    assert all(2 <= s["state"] <= 4 for s in al.states)


@pytest.fixture(params=["mono", "flagship"])
def aligned_decodes(request):
    """Both packages' decodes with -walign -palign -salign of one
    configuration: (port engine, reference engine, port results,
    reference results)."""
    teng, jeng, utts = cases(request)
    teng.search_cfg = dataclasses.replace(teng.search_cfg, **ALIGN)
    jeng.search_cfg = dataclasses.replace(jeng.search_cfg, **ALIGN)
    lens = np.asarray([f.shape[0] for _, f in utts], np.int32)
    feats = np.zeros((len(utts), lens.max(), utts[0][1].shape[1]),
                     np.float32)
    for b, (_, f) in enumerate(utts):
        feats[b, :f.shape[0]] = f
    try:
        got = teng.decode_features(feats, lens)
        want = jeng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    finally:
        teng.search_cfg = dataclasses.replace(
            teng.search_cfg, **{k: False for k in ALIGN})
        jeng.search_cfg = dataclasses.replace(
            jeng.search_cfg, **{k: False for k in ALIGN})
    return teng, jeng, got, want


def test_engine_alignment_matches_reference(aligned_decodes):
    _, _, got, want = aligned_decodes
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    for g, w in zip(got, want):
        assert g.alignment is not None and w.alignment is not None
        assert_same_alignment(g.alignment, w.alignment)
        assert [x["word"] for x in g.alignment.words] == g.words


def test_result_block_alignment_lines_match_reference(aligned_decodes):
    teng, jeng, got, want = aligned_decodes
    teng.search_cfg = dataclasses.replace(teng.search_cfg, **ALIGN)
    jeng.search_cfg = dataclasses.replace(jeng.search_cfg, **ALIGN)
    try:
        for g, w in zip(got, want):
            tb = trec.result_block(teng, g).splitlines()
            jb = jrec.result_block(jeng, w).splitlines()
            cut = tb.index("=== word alignment ===")
            assert tb[cut:] == jb[cut:]
            assert "=== phoneme alignment ===" in tb
            assert "=== state alignment ===" in tb
    finally:
        teng.search_cfg = dataclasses.replace(
            teng.search_cfg, **{k: False for k in ALIGN})
        jeng.search_cfg = dataclasses.replace(
            jeng.search_cfg, **{k: False for k in ALIGN})


def test_recognize_batch_aligns_like_reference():
    """Waveform input: the alignment runs on the front end's features,
    as the reference's does."""
    teng, jeng = mono_engines(26, **ALIGN)
    rng = np.random.default_rng(3)
    wave = (rng.standard_normal((2, 9000)) * 3000).astype(np.float32)
    lens = np.asarray([9000, 6400], np.int32)
    got = teng.recognize_batch(wave, lens)
    want = jeng.recognize_batch(wave, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    for g, w in zip(got, want):
        assert_same_alignment(g.alignment, w.alignment)
    assert "walign/palign/salign" in teng.describe()


def test_failed_alignment_is_logged_and_the_result_kept(mono, monkeypatch):
    teng, _, ids, frames = mono

    def fail(*a, **kw):
        raise ValueError("no path")

    monkeypatch.setattr(teng, "align", fail)
    teng.search_cfg = dataclasses.replace(teng.search_cfg, align_word=True)
    try:
        res = teng.decode_features(frames[None], [frames.shape[0]])
    finally:
        teng.search_cfg = dataclasses.replace(teng.search_cfg,
                                              align_word=False)
    assert res[0].valid and res[0].word_ids and res[0].alignment is None
