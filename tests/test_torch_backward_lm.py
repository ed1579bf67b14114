"""Port vs reference: a backward (RL) N-gram for pass 2 (-nlr / -nrl).

* `forward_view` in its three cases: an explicit forward model, the
  forward 2-gram inside an RL bingram pair, and neither (ValueError);
  an RL model swaps BOS and EOS;
* `pass2_search_backward` on the same lattice: N-best word ids and
  bounds equal, scores within 1e-5, with and without transparent words;
* the backward pair and the bingram pair decode through both engines to
  the same word ids (pass 1 on the forward 2-gram, pass 2 the frozen
  backward search), and so does `register_user_lm` (the host re-scan
  with an application LM);
* `-nlr` + `-nrl` through both command lines print the same lines.

The models are the reference tests' tiny GMM fixture, parsed by each
package from the same text; the backward model is the forward one with
its bigrams flipped (`tests/test_backward_lm.py` `make_backward_arpa`,
and the port's `tools.synth.backward_ngram`)."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io import arpa as jarpa
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict_line
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmmdefs
from julius_tpu.search import pass1 as jp1
from julius_tpu.search import pass2 as jp2
from julius_tpu.tools import recognize as jrec
from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.io import arpa as tarpa
from julius_tpu_torch.io.bingram import read_bingram
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.tools import recognize as trec
from julius_tpu_torch.tools.synth import backward_ngram, write_gmm_task

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
from test_backward_lm import make_backward_arpa
from test_torch_cli import assert_same_lines, run_main
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

UTTS = [(0, ["<s>", "AB", "BA", "</s>"]), (1, ["<s>", "ABC", "</s>"]),
        (2, ["<s>", "CA", "</s>"])]


def both(parse_hmm, Voca, parse_line, parse_arpa):
    """(hmm, voca, forward LM, backward LM) parsed by one package."""
    hmm = parse_hmm(make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=4,
                                      n_states=3, n_mix=2))
    voca = Voca()
    for line in make_dict_text().splitlines():
        parse_line(line, voca)
    fwd_text = make_arpa_text()
    return (hmm, voca, parse_arpa(io.StringIO(fwd_text)),
            parse_arpa(io.StringIO(make_backward_arpa(fwd_text)),
                       direction="RL"))


@pytest.fixture(scope="module")
def models():
    ref = both(jparse_hmmdefs, JVocabulary, jparse_dict_line,
               jarpa.parse_arpa)
    port = both(parse_hmmdefs_text, Vocabulary, parse_dict_line,
                tarpa.parse_arpa)
    hmm = ref[0]
    name2id = {n: i for i, n in enumerate(ref[1].names)}
    frames = []
    for seed, seq in UTTS:
        pids = [hmm.phone_index[p] for w in seq
                for p in ref[1].phones[name2id[w]]]
        frames.append(sample_states_and_frames(
            hmm, pids, np.random.default_rng(seed))[0])
    return ref, port, frames


def test_rl_model_swaps_bos_eos_and_flips_bigrams(models):
    (_, _, jfwd, jbwd), (_, _, fwd, bwd), _ = models
    assert bwd.direction == jbwd.direction == "RL"
    assert (bwd.bos_id, bwd.eos_id) == (fwd.eos_id, fwd.bos_id) == \
        (jbwd.bos_id, jbwd.eos_id)
    assert bwd.ngrams == jbwd.ngrams
    flipped = backward_ngram(fwd)
    assert flipped.ngrams[1] == {k: (p, 0.0) for k, (p, _) in
                                 bwd.ngrams[1].items()}
    assert flipped.ngrams[0] == bwd.ngrams[0]
    assert (flipped.direction, flipped.bos_id, flipped.eos_id) == \
        ("RL", bwd.bos_id, bwd.eos_id)


def attach_pair(bwd, fwd):
    """The forward 2-gram and its unigram back-offs an RL bingram pair
    carries (io/bingram.py attaches them when it reads one)."""
    bwd = dataclasses.replace(bwd)
    bwd.forward_bigram = {k: p for k, (p, _) in fwd.ngrams[1].items()}
    bwd.forward_bo_uni = np.asarray(
        [fwd.ngrams[0][(w,)][1] - 0.25 for w in range(fwd.n_words)])
    return bwd


def test_forward_view_in_its_three_cases(models):
    (_, _, jfwd, jbwd), (_, _, fwd, bwd), _ = models
    assert tarpa.forward_view(fwd) is fwd
    assert tarpa.forward_view(bwd, fwd) is fwd
    for mod, b in ((tarpa, bwd), (jarpa, jbwd)):
        with pytest.raises(ValueError, match="needs a forward 2-gram"):
            mod.forward_view(b)
    got = tarpa.forward_view(attach_pair(bwd, fwd))
    want = jarpa.forward_view(attach_pair(jbwd, jfwd))
    assert got.direction == want.direction == "LR"
    assert got.order == want.order == 2
    assert got.ngrams == want.ngrams
    assert (got.bos_id, got.eos_id, got.unk_id) == \
        (want.bos_id, want.eos_id, want.unk_id)
    # the unigram back-offs come from the pair, not the RL model
    assert got.ngrams[0][(2,)][1] == pytest.approx(
        fwd.ngrams[0][(2,)][1] - 0.25)


def reference_engine(models, **kw):
    (hmm, voca, fwd, bwd), _, _ = models
    return JEngine(hmm, voca, lm=bwd, lm_forward=fwd, search=JSearchConfig(
        lm_weight=2.0, lm_weight2=2.0, nbest=3), **kw)


def port_engine(models, lm, lm_forward):
    _, (hmm, voca, _, _), _ = models
    return Engine(hmm, voca, lm=lm, lm_forward=lm_forward,
                  search=SearchConfig(lm_weight=2.0, lm_weight2=2.0,
                                      nbest=3), device="cpu")


@pytest.mark.parametrize("transparent", [False, True])
def test_pass2_search_backward_matches_reference(models, transparent):
    (_, _, _, jbwd), (_, _, _, bwd), frames = models
    jeng = reference_engine(models)
    tw = np.zeros(jeng.voca.n_words, bool)
    tw[jeng.voca.names.index("BA")] = transparent
    n = 0
    for f in frames:
        out = jeng._outprob(jnp.asarray(f[None]))
        trellis = jp1.pass1_batch(jeng.dev_net, jeng.ngram_dev,
                                  jeng.p1_cfg, out,
                                  jnp.asarray([f.shape[0]]))
        tb = jp1.Trellis(*[np.asarray(a)[0] for a in trellis])
        args = (jeng._wid2lm_p2, jeng.search_cfg, jeng.net.tail_word,
                jeng.net.head_word, tw if transparent else None)
        want = jp2.pass2_search_backward(
            jp2.TrellisLattice(tb, f.shape[0]), jbwd, *args)
        got = tp2.pass2_search_backward(
            tp2.TrellisLattice(tb, f.shape[0]), bwd, *args)
        assert [g.word_ids for g in got] == [w.word_ids for w in want]
        assert [g.bounds for g in got] == [w.bounds for w in want]
        for g, w in zip(got, want):
            assert g.score == pytest.approx(w.score, abs=1e-5)
            assert g.lm_score == pytest.approx(w.lm_score, abs=1e-5)
            assert g.am_score == pytest.approx(w.am_score, abs=1e-5)
        n += len(got)
    assert n > len(frames)


def decode_both(jeng, teng, frames):
    got, want = [], []
    for f in frames:
        want += jeng.decode_features(jnp.asarray(f[None]),
                                     jnp.asarray([f.shape[0]]))
        got += teng.decode_features(f[None], np.asarray([f.shape[0]]))
    for g, w in zip(got, want):
        assert g.valid == w.valid
        assert g.word_ids == w.word_ids
        assert g.from_pass == w.from_pass
        assert g.score == pytest.approx(w.score, abs=1e-3)
        assert [h.word_ids for h in g.nbest] == [h.word_ids for h in w.nbest]
    return got


def test_backward_pair_decodes_like_reference(models):
    _, (_, _, fwd, bwd), frames = models
    teng = port_engine(models, bwd, fwd)
    assert teng.lm is bwd and teng.lm_p1 is fwd
    assert not teng._rescan_ok() and not teng._device_astar_ok()
    got = decode_both(reference_engine(models), teng, frames)
    for r, (_, seq) in zip(got, UTTS):
        assert r.from_pass == 2 and r.words == seq
        assert all(h.words[0] == "<s>" and h.words[-1] == "</s>"
                   for h in r.nbest)


def test_bingram_pair_decodes_like_reference(models):
    """An RL model carrying its forward 2-gram (a bingram pair) needs no
    lm_forward: pass 1 runs the synthesized forward view."""
    (hmm, voca, jfwd, jbwd), (_, _, fwd, bwd), frames = models
    jeng = JEngine(hmm, voca, lm=attach_pair(jbwd, jfwd),
                   search=JSearchConfig(lm_weight=2.0, lm_weight2=2.0,
                                        nbest=3))
    teng = port_engine(models, attach_pair(bwd, fwd), None)
    assert teng.lm_p1.direction == "LR" and teng.lm_p1 is not fwd
    got = decode_both(jeng, teng, frames)
    assert [r.words for r in got] == [seq for _, seq in UTTS]


def user_lm(ctx, w):
    """A deterministic application 2-gram over dictionary ids."""
    c = ctx[-1] if ctx else -1
    return -0.5 - 0.25 * ((3 * w + 5 * c) % 4)


def test_user_lm_rescores_like_reference(models):
    (hmm, voca, jfwd, _), (thmm, tvoca, fwd, _), frames = models
    cfg = dict(lm_weight=2.0, lm_weight2=2.0, nbest=3)
    jeng = JEngine(hmm, voca, lm=jfwd, search=JSearchConfig(**cfg))
    teng = Engine(thmm, tvoca, lm=fwd, search=SearchConfig(**cfg),
                  device="cpu")
    for e in (jeng, teng):
        e.register_user_lm(user_lm)
    assert teng.lm is not teng.lm_p1 and teng.lm.order == 2
    assert teng._rescan_ok() and not teng._device_astar_ok()
    np.testing.assert_array_equal(teng._wid2lm_p2, np.arange(voca.n_words))
    got = decode_both(jeng, teng, frames)
    assert all(r.from_pass == 2 for r in got)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("nrl_task")
    truths, files = write_gmm_task(str(d), n_utts=3, n_words=60,
                                   n_phones=24, dim=39, n_mix=4,
                                   min_words=2, max_words=4)
    fwd = read_bingram(files["lm"])
    tarpa.write_arpa(fwd, str(d / "fwd.arpa"))
    tarpa.write_arpa(backward_ngram(fwd), str(d / "back.arpa"))
    return d, truths, files


@pytest.mark.parametrize("forward", ["-nlr", "-d"])
def test_nlr_nrl_command_lines_print_like_reference(task, forward):
    """-nrl beside the forward 2-gram, as an ARPA (-nlr) or the task's
    bingram (-d): both packages print the same lines, every sentence
    from the backward search."""
    d, truths, files = task
    fwd = str(d / "fwd.arpa") if forward == "-nlr" else files["lm"]
    argv = ["-h", files["am"], "-v", files["dict"], forward, fwd,
            "-nrl", str(d / "back.arpa"), "-input", "mfcfile",
            "-filelist", files["list"], "-batchsize", "3"]
    got = run_main(trec.main, argv, device="cpu")
    assert_same_lines(got, run_main(jrec.main, argv))
    sentences = [ln for ln in got if ln.startswith("sentence1: ")]
    assert len(sentences) == len(truths)
