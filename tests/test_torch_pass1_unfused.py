"""Port vs reference: pass 1's unfused step (search/pass1.py
`pass1_step`), the path of every configuration the beam-update kernel
does not serve.

Each case builds the reference engine on a small model of the
reference's own test fixtures (tests/fixtures.py hmmdefs, dictionary and
2-gram; test_grammar.py's DFA; test_iwcd2.py's triphones), takes its
outprob rows of three generated utterances of ragged lengths, and runs
both packages' `pass1_batch` on them: the reference's vmap of its XLA
step, the port's batched step on the port engine's own network tables,
which must equal the reference's carried across by convert.py.  The
cases: a DFA grammar, isolated words, factoring 2, the score envelope,
per-context head emission rows (`head_rc_dynamic`) and a topology with
backward arcs (the incoming-arc gather).  The trellis is held to
test_pass1_fused.py's rule: word ids equal everywhere, the other integer
fields equal and scores within atol 1e-5 where a word survived; the
backtraces are equal.  The default configuration still launches the
beam-update kernel's wrapper once a frame and never the unfused step.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.config import AMConfig as JAM, SearchConfig as JSC
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.dfa import parse_dfa as jparse_dfa
from julius_tpu.io.htk_dict import (Vocabulary as JVocabulary,
                                    parse_dict_line as jdict_line)
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.search import pass1 as jp1
from julius_tpu_torch import convert
from julius_tpu_torch.config import AMConfig as TAM, SearchConfig as TSC
from julius_tpu_torch.engine import Engine as TEngine
from julius_tpu_torch.io.arpa import parse_arpa as tparse_arpa
from julius_tpu_torch.io.dfa import parse_dfa as tparse_dfa
from julius_tpu_torch.io.htk_dict import (Vocabulary as TVocabulary,
                                          parse_dict_line as tdict_line)
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text as tparse_hmm
from julius_tpu_torch.ops import pass1_kernel as tpk
from julius_tpu_torch.search import pass1 as tp1

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
from test_grammar import DFA_TEXT, DICT_TEXT
from test_iwcd2 import PHONES as TRI_PHONES
from test_torch_pass1 import trellis_equal
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

MONO = ("a", "b", "c", "sil")
TRI_DICT = ["<s>\t[]\tsil", "</s>\t[]\tsil", "XA\t[xa]\ta", "XB\t[xb]\tb",
            "YY\t[yy]\tc a"]
TRI_ARPA = """
\\data\\
ngram 1=5
ngram 2=6

\\1-grams:
-0.5\t<s>\t-0.3
-0.5\t</s>\t-0.3
-0.6\tXA\t-0.3
-0.6\tXB\t-0.3
-0.6\tYY\t-0.3

\\2-grams:
-0.2\t<s> XA
-0.2\t<s> XB
-0.2\tXA YY
-0.2\tXB YY
-0.2\tYY </s>
-4.0\tXA </s>

\\end\\
"""
NGRAM_SENTS = [["<s>", "AB", "BA", "</s>"], ["<s>", "ABC", "CA", "</s>"],
               ["<s>", "CA", "AB", "ABC", "</s>"]]

#: case -> (phones, dictionary lines, 2-gram text or None, DFA text or
#: None, engine keyword arguments, search fields, utterances as word
#: names, add a backward arc)
CASES = {
    "dfa": (MONO, DICT_TEXT.splitlines(), None, DFA_TEXT, {},
            dict(trellis_topm=8),
            [["0", "1", "2", "0"], ["0", "1", "2", "0"],
             ["0", "2", "1", "0"]], False),
    "isolated": (MONO, ["APPLE\t[apple]\ta b c", "BANANA\t[banana]\tb a",
                        "CHERRY\t[cherry]\tc a b"], None, None,
                 dict(lmtype="word"), dict(trellis_topm=4),
                 [["APPLE"], ["BANANA"], ["CHERRY"]], False),
    "factoring2": (MONO, make_dict_text().splitlines(), make_arpa_text(),
                   None, {}, dict(trellis_topm=8, factoring=2,
                                  crossword_topk=4, lm_weight=4.0,
                                  lm_penalty=-1.0), NGRAM_SENTS, False),
    "envelope": (MONO, make_dict_text().splitlines(), make_arpa_text(),
                 None, {}, dict(trellis_topm=8, beam_width=40,
                                lm_weight=4.0), NGRAM_SENTS, False),
    "rc_head": (TRI_PHONES, TRI_DICT, TRI_ARPA, None,
                dict(am=dict(head_rc_dynamic=True)),
                dict(trellis_topm=8, lm_weight=2.0),
                [["<s>", "XA", "YY", "</s>"], ["<s>", "XB", "YY", "</s>"],
                 ["<s>", "XA", "YY", "XB", "YY", "</s>"]], False),
    "gather": (MONO, make_dict_text().splitlines(), make_arpa_text(), None,
               {}, dict(trellis_topm=8, lm_weight=4.0), NGRAM_SENTS, True),
}


def build_engines(case, search_extra=None):
    """(reference engine, port engine on the CPU), each built from its
    own package's parse of the same texts."""
    phones, dict_lines, arpa, dfa_text, kw, search, _, backward = \
        CASES[case]
    search = dict(search, **(search_extra or {}))
    text = make_hmmdefs_text(phones=phones, dim=4, n_states=3,
                             n_mix=1 if phones is TRI_PHONES else 2)
    engines = []
    for parse_hmm, Voc, dict_line, parse_arpa, parse_dfa, Eng, AM, SC, dev \
            in ((jparse_hmm, JVocabulary, jdict_line, jparse_arpa,
                 jparse_dfa, JEngine, JAM, JSC, {}),
                (tparse_hmm, TVocabulary, tdict_line, tparse_arpa,
                 tparse_dfa, TEngine, TAM, TSC, dict(device="cpu"))):
        hmm = parse_hmm(text)
        if backward:
            # a backward transition (state 3 -> state 2) in every phone
            for pid in range(len(hmm.phone_names)):
                tr = np.array(hmm.phone_trans[pid])
                tr[3, 2] = np.log(0.1)
                hmm.phone_trans[pid] = tr
        voca = Voc()
        for line in dict_lines:
            dict_line(line, voca)
        args = dict(search=SC(**search), **dev)
        if arpa is not None:
            args["lm"] = parse_arpa(io.StringIO(arpa))
        if dfa_text is not None:
            args["dfa"] = parse_dfa(io.StringIO(dfa_text))
            args["word_cat"] = np.asarray([int(n) for n in voca.names],
                                          np.int32)
        if "lmtype" in kw:
            args["lmtype"] = kw["lmtype"]
        if "am" in kw:
            args["am_cfg"] = AM(**kw["am"])
        engines.append(Eng(hmm, voca, **args))
    return engines


def reference_rows(jeng, sents, seed=0):
    """Frames of `sents` (word names) sampled from the reference's model
    -> the reference's [B, T, R] outprob rows and [B] frame counts."""
    rng = np.random.default_rng(seed)
    hmm, voca = jeng.hmm, jeng.voca
    frames = []
    for sent in sents:
        # a grammar dictionary names words by category: take each
        # category's first word
        ids = [voca.names.index(w) for w in sent]
        pids = [hmm.phone_index[p] for w in ids for p in voca.phones[w]]
        frames.append(sample_states_and_frames(hmm, pids, rng)[0])
    lens = np.asarray([f.shape[0] for f in frames], np.int32)
    feats = np.zeros((len(frames), lens.max(), frames[0].shape[1]),
                     np.float32)
    for b, f in enumerate(frames):
        feats[b, :f.shape[0]] = f
    return np.array(jeng._outprob_jit(jnp.asarray(feats))), lens


def reference_trellis(jeng, out, lens):
    old = jp1.FUSE_PASS1
    jp1.FUSE_PASS1 = False
    try:
        ref = jp1.pass1_batch(jeng.dev_net, jeng.ngram_dev, jeng.p1_cfg,
                              jnp.asarray(out), jnp.asarray(lens))
    finally:
        jp1.FUSE_PASS1 = old
    return jax.tree_util.tree_map(np.asarray, ref)


def port_trellis(teng, out, lens):
    got = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                          torch.from_numpy(out), torch.from_numpy(lens))
    return tp1.Trellis(*[a.numpy() for a in got])


def assert_same_networks(a, b):
    for name in tp1.NETWORK_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    for name in ("head_word", "tail_word", "local_k", "rc_C"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_unfused_trellis_matches_reference(case):
    jeng, teng = build_engines(case)
    conv = convert.device_network(convert.numpy_fields(jeng.dev_net), "cpu")
    assert_same_networks(teng.dev_net, conv)
    cfg = dataclasses.asdict(teng.p1_cfg)
    assert cfg == {k: v for k, v in dataclasses.asdict(jeng.p1_cfg).items()
                   if k in cfg}
    assert not tp1.fused_ok(teng.dev_net, teng.p1_cfg)
    assert (teng.dev_net.local_k < 0) == (case == "gather")
    assert (teng.dev_net.rc_head is not None) == (case == "rc_head")
    out, lens = reference_rows(jeng, CASES[case][6])
    ref = reference_trellis(jeng, out, lens)
    got = port_trellis(teng, out, lens)
    trellis_equal(ref, got)
    assert (got.word >= 0).sum() > 20
    for b in range(len(lens)):
        rb = jp1.backtrace(jax.tree_util.tree_map(lambda a: a[b], ref),
                           int(lens[b]), jeng.net.tail_word,
                           final_mask=jeng.final_mask)
        gb = tp1.backtrace(tp1.Trellis(*[a[b] for a in got]), int(lens[b]),
                           teng.net.tail_word, final_mask=teng.final_mask)
        assert rb is not None and gb is not None
        assert gb["words"] == rb["words"]
        assert [s["begin"] for s in gb["segments"]] == \
            [s["begin"] for s in rb["segments"]]
    if case == "envelope":
        # the envelope pruned: the same rows without it give another
        # trellis
        _, plain = build_engines(case, dict(beam_width=0))
        assert not np.array_equal(port_trellis(plain, out, lens).score,
                                  got.score)


def test_default_configuration_takes_the_kernel(monkeypatch):
    """The configuration `fused_ok` admits launches the beam-update
    kernel's wrapper once a frame and never the unfused step; an
    unfused configuration never calls the wrapper."""
    calls = {"kernel": 0, "step": 0}
    real_kernel, real_step = tpk.fused_step, tp1.pass1_step

    def kernel(*a, **kw):
        calls["kernel"] += 1
        return real_kernel(*a, **kw)

    def step(*a, **kw):
        calls["step"] += 1
        return real_step(*a, **kw)

    monkeypatch.setattr(tpk, "fused_step", kernel)
    monkeypatch.setattr(tp1, "pass1_step", step)
    for backward in (False, True):
        jeng, teng = (build_engines("gather") if backward
                      else build_engines("envelope", dict(beam_width=0)))
        out, lens = reference_rows(jeng, NGRAM_SENTS)
        calls.update(kernel=0, step=0)
        got = port_trellis(teng, out, lens)
        T = out.shape[1]
        assert tp1.fused_ok(teng.dev_net, teng.p1_cfg) == (not backward)
        assert calls == ({"kernel": 0, "step": T} if backward
                         else {"kernel": T, "step": 0})
        trellis_equal(reference_trellis(jeng, out, lens), got)
