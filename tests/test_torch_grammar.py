"""Port vs reference: DFA grammars and isolated words.

* `io/dfa.py` and `grammar.py` (the mkdfa compiler and the grammar QA
  tools) against the reference on tests/test_grammar.py's automaton and
  tests/test_grammar_compile.py's grammars: the same .dfa, .dfa.forward,
  .dict and .term bytes, the same category-pair, begin and end matrices,
  accept checks, sampled sentences and next categories, and the same
  automata after determinisation and minimisation;
* `fusion.merge_grammars` merges the same grammars into the same
  automaton and dictionary;
* engines decode in grammar mode (test_grammar.py's and the compiled
  grammar's models) with each pass 2, the host re-scan (whose word scans
  run the scan kernel's wrapper) and the frozen DFA search, and in
  isolated-word mode (pass 1 only): word ids, `from_pass` and word
  begins equal to the reference's, scores within atol 1e-3 (sums of a
  few hundred float32 GMM scores, each package scoring its own), every
  grammar result accepted by the automaton.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from julius_tpu import fusion as jfusion
from julius_tpu import grammar as JG
from julius_tpu.config import SearchConfig as JSC
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io import dfa as jdfa
from julius_tpu.io.htk_dict import (Vocabulary as JVocabulary,
                                    parse_dict_line as jdict_line)
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu_torch import fusion as tfusion
from julius_tpu_torch import grammar as TG
from julius_tpu_torch.config import SearchConfig as TSC
from julius_tpu_torch.engine import Engine as TEngine
from julius_tpu_torch.io import dfa as tdfa
from julius_tpu_torch.io.htk_dict import (Vocabulary as TVocabulary,
                                          parse_dict_line as tdict_line)
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text as tparse_hmm
from julius_tpu_torch.search import pass2_rescan as tp2r

from fixtures import make_hmmdefs_text, sample_states_and_frames
from test_grammar import DFA_TEXT, DICT_TEXT
from test_grammar_compile import GRAMMAR, VOCA
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

TAIL = ("S : NS_B LIST NS_E\nLIST : WORD\nLIST : WORD LIST\n",
        "% NS_B\nsilb sil\n% NS_E\nsile sil\n% WORD\nw a\nv b\n")
GRAMMARS = {"command": (GRAMMAR, VOCA), "tail_recursion": TAIL}
HMM_TEXT = make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=4,
                             n_states=3, n_mix=2)


def dfa_fields(d):
    return (d.n_states, d.n_terms, d.arcs, d.accept, d.initial,
            d.term_words)


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_mkdfa_writes_the_reference_files(name, tmp_path):
    gtext, vtext = GRAMMARS[name]
    for pkg in ("torch", "jax"):
        (tmp_path / f"{pkg}.grammar").write_text(gtext)
        (tmp_path / f"{pkg}.voca").write_text(vtext)
    TG.mkdfa(str(tmp_path / "torch"))
    JG.mkdfa(str(tmp_path / "jax"))
    for ext in (".dfa", ".dfa.forward", ".dict", ".term"):
        assert (tmp_path / f"torch{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes(), ext
    tg = tdfa.load_grammar(str(tmp_path / "torch"))
    jg = jdfa.load_grammar(str(tmp_path / "jax"))
    assert dfa_fields(tg[0]) == dfa_fields(jg[0])
    assert dataclasses.asdict(tg[1]) == dataclasses.asdict(jg[1])
    assert np.array_equal(tg[2], jg[2])


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_compiled_grammar_matches_reference(name):
    gtext, vtext = GRAMMARS[name]
    got = TG.compile_grammar(gtext, vtext)
    want = JG.compile_grammar(gtext, vtext)
    for g, w in zip(got[:2], want[:2]):
        assert dfa_fields(g) == dfa_fields(w)
        for a, b in zip(g.category_pair_matrix(), w.category_pair_matrix()):
            assert np.array_equal(a, b)
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert got[3] == want[3] and got[4] == want[4]
    rev, fwd, ncat = got[0], got[1], len(got[4])
    jrev, jfwd = want[0], want[1]
    rng = np.random.default_rng(0)
    seqs = [list(rng.integers(0, ncat, k)) for k in (1, 2, 3, 4, 5)
            for _ in range(20)]
    seqs += TG.generate_sentences(fwd, n=10, seed=1)
    for s in seqs:
        assert TG.accept_check(fwd, s) == JG.accept_check(jfwd, s)
        assert rev.accepts_forward(s) == jrev.accepts_forward(s)
        assert TG.next_categories(fwd, s[:2]) == \
            JG.next_categories(jfwd, s[:2])
    assert TG.generate_sentences(fwd, n=10, seed=1) == \
        JG.generate_sentences(jfwd, n=10, seed=1)
    for fn in ("determinize_dfa", "minimize_dfa"):
        assert dfa_fields(getattr(TG, fn)(fwd)) == \
            dfa_fields(getattr(JG, fn)(jfwd))
    with pytest.raises(TG.GrammarError):
        TG.compile_grammar("S : A\nA : WORD A WORD\nA : WORD\n",
                           "% WORD\nw a\n")


def test_parsed_dfa_and_category_pairs_match_reference():
    td = tdfa.parse_dfa(io.StringIO(DFA_TEXT))
    jd = jdfa.parse_dfa(io.StringIO(DFA_TEXT))
    assert dfa_fields(td) == dfa_fields(jd)
    for a, b in zip(td.category_pair_matrix(), jd.category_pair_matrix()):
        assert np.array_equal(a, b)
    assert td.accept_start_set() == jd.accept_start_set()
    for cats in ([0, 1, 2, 0], [0, 2, 1, 0], [0, 1, 2], [1, 2, 0]):
        assert td.accepts_forward(cats) == jd.accepts_forward(cats)
    tdfa.attach_terminfo(td, [0, 1, 1, 2, 2])
    jdfa.attach_terminfo(jd, [0, 1, 1, 2, 2])
    assert td.term_words == jd.term_words


def test_merge_grammars_matches_reference(tmp_path):
    prefixes = []
    for k, (gtext, vtext) in enumerate(GRAMMARS.values()):
        (tmp_path / f"g{k}.grammar").write_text(gtext)
        (tmp_path / f"g{k}.voca").write_text(vtext)
        JG.mkdfa(str(tmp_path / f"g{k}"))
        prefixes.append(str(tmp_path / f"g{k}"))
    got = tfusion.load_multiple_grammars(prefixes)
    want = jfusion.load_multiple_grammars(prefixes)
    assert dfa_fields(got[0]) == dfa_fields(want[0])
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert np.array_equal(got[2], want[2])
    n0 = tdfa.load_grammar(prefixes[0])[0].n_terms
    assert got[2].max() >= n0 and got[0].n_states > n0


def grammar_models(case, pkg):
    """(hmm, voca, dfa, word_cat) of a grammar case in one package."""
    parse_hmm, Voc, dict_line, dmod, gmod = (
        (tparse_hmm, TVocabulary, tdict_line, tdfa, TG) if pkg == "torch"
        else (jparse_hmm, JVocabulary, jdict_line, jdfa, JG))
    hmm = parse_hmm(HMM_TEXT)
    if case == "compiled":
        dfa, _, voca, word_cat, _ = gmod.compile_grammar(GRAMMAR, VOCA)
        return hmm, voca, dfa, np.asarray(word_cat, np.int32)
    voca = Voc()
    for line in DICT_TEXT.splitlines():
        dict_line(line, voca)
    return (hmm, voca, dmod.parse_dfa(io.StringIO(DFA_TEXT)),
            np.asarray([int(n) for n in voca.names], np.int32))


#: utterances as output strings (the second of the dictionary case is in
#: an order the grammar forbids)
UTTS = {"dict": [["sil", "AB", "ABC", "sil"], ["sil", "ABC", "AB", "sil"],
                 ["sil", "BA", "CA", "sil"]],
        "compiled": [["silb", "go", "left", "sile"],
                     ["silb", "stop", "right", "left", "sile"],
                     ["silb", "go", "sile"]]}


def features(hmm, voca, sents, seed):
    out2id = {o: i for i, o in enumerate(voca.outputs)}
    rng = np.random.default_rng(seed)
    frames = [sample_states_and_frames(hmm, [
        hmm.phone_index[p] for t in sent for p in voca.phones[out2id[t]]],
        rng)[0] for sent in sents]
    lens = np.asarray([f.shape[0] for f in frames], np.int32)
    feats = np.zeros((len(frames), lens.max(), 4), np.float32)
    for b, f in enumerate(frames):
        feats[b, :f.shape[0]] = f
    return feats, lens


def assert_same_results(got, want, atol=1e-3):
    assert [g.from_pass for g in got] == [w.from_pass for w in want]
    for g, w in zip(got, want):
        assert g.valid and w.valid
        assert g.word_ids == w.word_ids
        assert g.texts == w.texts
        assert g.score == pytest.approx(w.score, abs=atol)
        assert [s["begin"] for s in g.segments] == \
            [s["begin"] for s in w.segments]


@pytest.mark.parametrize("case", ["dict", "compiled"])
@pytest.mark.parametrize("pass2", ["rescan", "frozen"])
def test_grammar_decode_matches_reference(case, pass2):
    search = dict(trellis_topm=8, pass2_rescan=pass2 == "rescan")
    jhmm, jvoca, jd, jwc = grammar_models(case, "jax")
    thmm, tvoca, td, twc = grammar_models(case, "torch")
    jeng = JEngine(jhmm, jvoca, dfa=jd, word_cat=jwc, search=JSC(**search))
    teng = TEngine(thmm, tvoca, dfa=td, word_cat=twc, search=TSC(**search),
                   device="cpu")
    assert teng.lmtype == "grammar" and not teng._device_astar_ok()
    assert teng._rescan_ok() == (pass2 == "rescan")
    assert np.array_equal(teng.final_mask, jeng.final_mask)
    feats, lens = features(jhmm, jvoca, UTTS[case], seed=3)
    want = jeng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    chunks = tp2r.CHUNKS
    got = teng.decode_features(feats, lens)
    assert (tp2r.CHUNKS > chunks) == (pass2 == "rescan")
    assert_same_results(got, want)
    assert 2 in [g.from_pass for g in got]
    for g in got:
        if g.from_pass == 2:
            assert td.accepts_forward([int(twc[w]) for w in g.word_ids])
    if case == "dict":
        assert got[0].texts == UTTS["dict"][0]


def test_isolated_word_decode_matches_reference():
    words = [("APPLE", "a b c"), ("BANANA", "b a"), ("CHERRY", "c a b")]
    engines = []
    for parse_hmm, Voc, Eng, SC, kw in (
            (jparse_hmm, JVocabulary, JEngine, JSC, {}),
            (tparse_hmm, TVocabulary, TEngine, TSC, dict(device="cpu"))):
        voca = Voc()
        for name, phones in words:
            voca.add(name, phones.split())
        engines.append(Eng(parse_hmm(HMM_TEXT), voca, lmtype="word",
                           search=SC(trellis_topm=4), **kw))
    jeng, teng = engines
    assert not teng.p1_cfg.crossword and teng.final_mask.all()
    feats, lens = features(jeng.hmm, jeng.voca, [[w] for w, _ in words],
                           seed=4)
    want = jeng.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    got = teng.decode_features(feats, lens)
    assert_same_results(got, want)
    assert [g.words for g in got] == [[w] for w, _ in words]
    assert all(g.from_pass == 1 for g in got)
