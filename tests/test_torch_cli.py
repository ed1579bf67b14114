"""Port vs reference: the `julius` command line (jconf.py, fusion.py,
tools/recognize.py) and the lattice/confnet/MBR outputs
(search/graphout.py).

* `parse_jconf` gives the same EngineConfig, every field, on the
  reference's own jconf test inputs and on the GMM, lattice and input
  options;
* `create_engines` loads the same models from the same files;
* both packages' `recognize.main` decode the same GMM-HMM task files
  (`tools.synth.write_gmm_task` at a small size: binhmm, dictionary,
  bingram, HTK parameter files) and print the same lines: sentences,
  word sequences, confidence lines, word-graph and confusion-network
  lines equal, each number in them within atol 1e-2 (CLI scores are
  sums of a few hundred float32 GMM scores; word-graph posteriors agree
  to 1e-6), with plain output, with -lattice -confnet -mbr -n 3, with
  -gshmm -separatescore and an -outprobout dump (the dumped scores
  within atol 1e-4), and -version's engine dump;
* the same for a grammar task and an isolated-word list written beside
  it (`tools.synth.write_grammar_task`): -gram, -dfa with -v, and -w;
* graphout's functions give the same graph, text dump, confusion
  network, MBR order and edit distances on the same lattice;
* live input through -input fake: (capture, VAD, the streaming
  decode), -48, -gmm verification, -powerthres and the -walign /
  -palign / -salign alignment lines print the same lines in both
  packages;
* an option set that cannot decode (-nrl with no forward 2-gram)
  raises as the reference's does, and the CLI needs CUDA unless the CPU
  is asked for.
"""

import contextlib
import dataclasses
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu import fusion as jfusion
from julius_tpu.io.htk_param import read_htk_param
from julius_tpu.jconf import parse_jconf as jparse
from julius_tpu.search import graphout as jgo
from julius_tpu.search import pass2 as jp2
from julius_tpu.tools import recognize as jrec
from julius_tpu_torch import fusion as tfusion
from julius_tpu_torch.io import arpa as tarpa
from julius_tpu_torch.io.bingram import read_bingram
from julius_tpu_torch.jconf import parse_jconf as tparse
from julius_tpu_torch.search import graphout as tgo
from julius_tpu_torch.tools import recognize as trec
from julius_tpu_torch.tools.synth import (backward_ngram, write_gmm_task,
                                          write_grammar_task)

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

TASK = dict(n_utts=3, n_words=60, n_phones=24, dim=39, n_mix=4,
            min_words=2, max_words=4)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmm_task")
    truths, files = write_gmm_task(str(d), **TASK)
    gram_truths, word_truths, gfiles = write_grammar_task(
        str(d), n_utts=TASK["n_utts"], n_words=TASK["n_words"],
        n_phones=TASK["n_phones"], dim=TASK["dim"], n_mix=TASK["n_mix"],
        n_cats=8)
    files.update(gfiles, gram_truths=gram_truths, word_truths=word_truths)
    (d / "sub.jconf").write_text("-b 400\n-lmp 9.0 -1.0\n")
    (d / "main.jconf").write_text(
        "# comment\n-C sub.jconf\n-smpFreq 8000\n-n 3 -m 1000\n")
    (d / "config").write_text(
        "SOURCERATE = 625\nTARGETKIND = MFCC_E_D_Z\n"
        "WINDOWSIZE = 250000.0\nTARGETRATE = 100000.0\n"
        "NUMCHANS = 24\nNUMCEPS = 12\n")
    (d / "run.jconf").write_text(
        f"-h {files['am']}\n-v {files['dict']}\n-d {files['lm']}\n"
        "-input mfcfile\n-batchsize 3\n")
    return d, truths, files


JCONF_CASES = {
    "sections": ["-C", "{d}/main.jconf"],
    "multi_instance": ["-AM", "am1", "-h", "x.hmm", "-AM", "am2", "-h",
                       "y.hmm", "-LM", "lm1", "-v", "d.dict", "-d", "l.arpa",
                       "-SR", "s1", "am1", "lm1", "-SR", "s2", "am2", "lm1"],
    "unknown_option": ["-notarealoption", "xyz", "-n", "2"],
    "htkconf": ["-htkconf", "{d}/config"],
    "output_options": ["-separatescore", "-progout", "-proginterval", "500",
                       "-record", "/tmp/recdir", "-charconv", "utf-8",
                       "sjis", "-quiet", "-plugindir", "a:b"],
    "option_surface": [
        "-b2", "40", "-bs", "150.0", "-spmodel", "isp", "-multipath",
        "-sscalc", "-sscalclen", "250", "-cmnupdate",
        "-nousepower", "-novtln", "-nocvn", "-cvnstatic",
        "-iwsppenalty", "-2.5", "-iwspword", "-iwspentry",
        "<UNK> [sp] sp", "-forcedict", "-wsil", "silB", "silE", "NULL",
        "-zmean", "-lvscale", "0.5", "-48", "-nostrip", "-notypecheck",
        "-chunksize", "2000", "-realtime", "-spsegment", "-spdur", "12",
        "-pausemodels", "sp,silB", "-graphrange", "3", "-graphcut",
        "60", "-cmthres", "0.7", "-mbr_wwer", "-mbr_weight", "0.2",
        "-fallback1pass", "-looktrellis", "-inactive",
        "-fvad", "2", "-fvad_param", "7", "0.5"],
    "gmm_and_outputs": [
        "-C", "{d}/run.jconf", "-gprune", "beam", "-tmix", "2",
        "-gshmm", "gs.binhmm", "-gsnum", "8", "-iwcd1", "best", "2",
        "-lattice", "-confnet", "-mbr", "-cmalpha", "0.1", "-n", "3",
        "-output", "2", "-outprobout", "out", "-filelist", "list.txt",
        "-rejectshort", "200", "-1pass", "-nolattice", "-lattice"],
}


@pytest.mark.parametrize("case", sorted(JCONF_CASES))
def test_parse_jconf(task, case):
    argv = [a.format(d=task[0]) for a in JCONF_CASES[case]]
    got, want = tparse(argv), jparse(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.unknown == want.unknown


def test_create_engines_loads_the_same_models(task):
    d, _, files = task
    argv = ["-C", str(d / "run.jconf"), "-gshmm", files["gs"]]
    teng = tfusion.create_engines(tparse(argv), device="cpu")[0]
    jeng = jfusion.create_engines(jparse(argv))[0]
    for name in ("means", "ivars", "gconst", "state_mix", "state_lw",
                 "phone_states", "phone_trans"):
        assert np.array_equal(getattr(teng.hmm, name),
                              getattr(jeng.hmm, name)), name
    assert teng.voca.names == jeng.voca.names
    assert teng.voca.phones == jeng.voca.phones
    assert teng.lm.ngrams == jeng.lm.ngrams
    assert dataclasses.asdict(teng.fe_cfg) == dataclasses.asdict(jeng.fe_cfg)
    assert teng.net.n_nodes == jeng.net.n_nodes
    assert teng.gms is not None and jeng.gms is not None
    assert np.array_equal(teng.gms.state2gs.numpy(),
                          np.asarray(jeng.gms.state2gs))


def run_main(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue().splitlines()


NUMBER = re.compile(r"-?\d+\.\d+")


def assert_same_lines(got, want, atol=1e-2):
    """Lines equal once their decimal numbers are masked, and each
    number within atol."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        np.testing.assert_allclose(
            [float(x) for x in NUMBER.findall(g)],
            [float(x) for x in NUMBER.findall(w)], rtol=0, atol=atol)


CLI_CASES = {
    "plain": [],
    "lattice_confnet_mbr": ["-lattice", "-confnet", "-mbr", "-n", "3"],
    "gshmm_outprob": ["-gshmm", "{gs}", "-gsnum", "8", "-separatescore",
                      "-outprobout", "{d}/{pkg}"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_recognize_main(task, case):
    d, truths, files = task
    out = {}
    for pkg, main, kw in (("torch", trec.main, dict(device="cpu")),
                          ("jax", jrec.main, {})):
        argv = ["-C", str(d / "run.jconf"), "-filelist", files["list"]] + [
            a.format(gs=files["gs"], d=d, pkg=pkg) for a in CLI_CASES[case]]
        out[pkg] = [ln.replace(f"{d}/{pkg}.", "PREFIX.")
                    for ln in run_main(main, argv, **kw)]
    got, want = out["torch"], out["jax"]
    assert_same_lines(got, want)
    sentences = [ln.split(": ", 1)[1] for ln in got
                 if ln.startswith("sentence1: ")]
    assert sentences == [" ".join(w for w in t if w not in ("<s>", "</s>"))
                         for t in truths]
    if case == "lattice_confnet_mbr":
        assert "--- begin wordgraph data ---" in got
        assert "--- begin confusion network ---" in got
        assert any(ln.startswith("sentence3: ") for ln in got)
    if case == "gshmm_outprob":
        assert any("(AM:" in ln for ln in got)
        for u in range(len(truths)):
            t = read_htk_param(str(d / f"torch.{u:04d}.prob"))
            j = read_htk_param(str(d / f"jax.{u:04d}.prob"))
            assert t.kind == j.kind == "USER"
            np.testing.assert_allclose(t.data, j.data, rtol=0, atol=1e-4)


MODE_CASES = {"gram": (["-gram", "{gram}"], "gram_utts", "gram_truths"),
              "dfa": (["-v", "{gram_dict}", "-dfa", "{dfa}"], "gram_utts",
                      "gram_truths"),
              "w": (["-w", "{wordlist}"], "word_utts", "word_truths")}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_grammar_and_word_modes_print_like_reference(task, case):
    """The command line in grammar mode (-gram, -dfa + -v) and
    isolated-word mode (-w): both packages print the same lines, and
    each input's first sentence is its generating words."""
    files = task[2]
    extra, utts, truths = MODE_CASES[case]
    argv = ["-h", files["am"], "-input", "mfcfile", "-batchsize", "3"] + [
        a.format(**files) for a in extra] + files[utts]
    got = run_main(trec.main, argv, device="cpu")
    assert_same_lines(got, run_main(jrec.main, argv))
    sentences = [ln.split(": ", 1)[1] for ln in got
                 if ln.startswith("sentence1: ")]
    assert sentences == [" ".join(t) for t in files[truths]]


def test_version_prints_the_engine(task):
    files = task[2]
    lines = run_main(trec.main, ["-h", files["am"], "-v", files["dict"],
                                 "-d", files["lm"], "-version"],
                     device="cpu")
    text = "\n".join(lines)
    assert "scorer: GMM (gprune=none num=10)" in text
    assert "device=cpu" in text and "vocabulary=60 words" in text


@pytest.fixture(scope="module")
def lattice(task):
    """The pass-1 lattice of the task's first utterance, decoded by the
    reference's GMM engine, and its 3-best list."""
    d, _, files = task
    eng = jfusion.create_engines(jparse(["-C", str(d / "run.jconf"),
                                         "-n", "3"]))[0]
    x = read_htk_param(files["utts"][0]).data[None]
    n = np.asarray([x.shape[1]], np.int32)
    res = eng.decode_features(jnp.asarray(x), jnp.asarray(n))[0]
    trellis = eng._pass1_jit(eng._outprob_jit(jnp.asarray(x)), n)
    tb = [np.asarray(a)[0] for a in trellis]
    return (jp2.TrellisLattice(type(trellis)(*tb), int(n[0])),
            eng.voca.names, [jp2.NBestResult(
                word_ids=r.word_ids, score=r.score, am_score=r.am_score,
                lm_score=r.lm_score, bounds=[]) for r in res.nbest])


def graph_fields(g):
    return [dataclasses.asdict(w) for w in g.words], g.n_frames


def test_graphout_functions(lattice):
    lat, names, nbest = lattice
    for scale in (0.05, 0.2):
        tg, jg = tgo.build_word_graph(lat, scale), jgo.build_word_graph(
            lat, scale)
        assert graph_fields(tg) == graph_fields(jg)
    tp, jp = tgo.prune_graph(tg, 1e-3), jgo.prune_graph(jg, 1e-3)
    assert graph_fields(tp) == graph_fields(jp) and len(tp) < len(tg)
    assert tgo.graph_to_text(tp, names) == jgo.graph_to_text(jp, names)
    assert [dataclasses.asdict(c) for c in tgo.confusion_network(tp)] == \
        [dataclasses.asdict(c) for c in jgo.confusion_network(jp)]
    gwords = {(w.word, w.begin, w.end): (w.score, w.am, w.lm)
              for w in jp.words}
    assert graph_fields(tgo.build_word_graph_pass2(gwords, lat.T)) == \
        graph_fields(jgo.build_word_graph_pass2(gwords, lat.T))
    assert len(nbest) == 3
    weights = np.linspace(0.5, 2.0, len(names)).astype(np.float32)
    for scale, w in ((0.1, None), (1.0, weights)):
        assert [r.word_ids for r in tgo.mbr_rerank(nbest, scale, w)] == \
            [r.word_ids for r in jgo.mbr_rerank(nbest, scale, w)]
    for a in nbest:
        for b in nbest:
            assert tgo.edit_distance(a.word_ids, b.word_ids, weights) == \
                jgo.edit_distance(a.word_ids, b.word_ids, weights)


@pytest.fixture(scope="module")
def live_task(task):
    """Inputs beside the GMM task for the live and rejection options: a
    16 kHz WAV of two loud bursts between near-silence (-input fake:),
    the same at 48 kHz listed in list48.txt (-48), a -gmm model set of
    two classes (voice: the task's feature statistics; noise: far from
    them) and an HTK parameter file of noise frames."""
    from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param
    from julius_tpu_torch.io.wav import write_wav
    from julius_tpu_torch.tools.synth import write_class_gmm

    d, _, files = task
    rng = np.random.default_rng(8)
    quiet = [rng.standard_normal(n) * 30 for n in (8000, 12000, 9000)]
    loud = [np.sin(2 * np.pi * f * np.arange(9000) / 16000) * 9000
            + rng.standard_normal(9000) * 800 for f in (310.0, 520.0)]
    wave = np.concatenate([quiet[0], loud[0], quiet[1], loud[1], quiet[2]])
    write_wav(str(d / "live.wav"), wave.astype(np.float32), 16000)
    t48 = np.arange(3 * 16000) / 48000
    wave48 = 6000 * np.sin(2 * np.pi * 440 * t48) \
        + rng.standard_normal(t48.size) * 500
    write_wav(str(d / "in48.wav"), wave48.astype(np.float32), 48000)
    (d / "list48.txt").write_text(f"{d}/in48.wav\n")
    x = np.concatenate([read_htk_param(u).data for u in files["utts"]])
    write_class_gmm(str(d / "gmmdefs"),
                    {"voice": (x.mean(0), x.var(0) + 0.5),
                     "noise": (x.mean(0) + 30.0, np.ones(x.shape[1]))})
    noise = (x.mean(0) + 30.0 + rng.standard_normal((80, x.shape[1]))) \
        .astype(np.float32)
    write_htk_param(str(d / "noise.mfc"), HTKParam(
        data=noise, samp_period=100000, kind="MFCC_E_D_A"))
    return d, files


LIVE_CASES = {
    "fake_input": ["-input", "fake:{d}/live.wav", "-lv", "1500", "-zc",
                   "20", "-headmargin", "100", "-tailmargin", "200"],
    "ds48": ["-input", "rawfile", "-filelist", "{d}/list48.txt", "-48"],
    "gmm": ["-gmm", "{d}/gmmdefs", "-gmmreject", "noise", "{u0}",
            "{d}/noise.mfc", "{u1}"],
    "powerthres_low": ["-powerthres", "-1000.0", "{u0}", "{u1}"],
    "powerthres_high": ["-powerthres", "1000.0", "{u0}", "{u1}"],
    "align": ["-walign", "-palign", "-salign", "{u0}", "{u1}"],
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_live_input_and_rejection_print_like_reference(live_task, case):
    """-input fake: (capture, VAD segmentation, the streaming decode),
    -48 (the native decimator), -gmm verification, -powerthres and
    -walign -palign -salign: both packages print the same lines."""
    d, files = live_task
    argv = ["-C", str(d / "run.jconf")] + [
        a.format(d=d, u0=files["utts"][0], u1=files["utts"][1])
        for a in LIVE_CASES[case]]
    got = run_main(trec.main, argv, device="cpu")
    assert_same_lines(got, run_main(jrec.main, argv))
    heads = [ln for ln in got if ln.startswith("input: ")]
    sentences = [ln for ln in got if ln.startswith("sentence1: ")]
    rejected = got.count("<input rejected by decoder>")
    if case == "fake_input":
        assert heads == ["input: live segment 0", "input: live segment 1"]
        assert len(sentences) == 2
    elif case == "ds48":
        assert heads == [f"input: {d}/in48.wav"] and len(sentences) == 1
    elif case == "gmm":
        assert rejected == 1 and len(sentences) == 2
        assert got[got.index(f"input: {d}/noise.mfc") + 1] == \
            "<input rejected by decoder>"
    elif case == "powerthres_high":
        assert rejected == 2
    elif case == "powerthres_low":
        assert rejected == 0 and len(sentences) == 2
    else:
        for head in ("=== word alignment ===", "=== phoneme alignment ===",
                     "=== state alignment ==="):
            assert got.count(head) == 2


UNPORTED = [
    (["-nrl", "{d}/back.arpa"], "backward N-gram needs a forward 2-gram"),
]


@pytest.mark.parametrize("extra,item", UNPORTED,
                         ids=[e[0] for e, _ in UNPORTED])
def test_unported_options_raise(task, extra, item):
    """Every option of the reference's command line has its path in the
    port; the ones that cannot decode raise as the reference's do: a
    backward N-gram (-nrl) with no forward 2-gram for pass 1 (neither
    -nlr nor -d) is a ValueError in both packages.  (-nrl beside one
    decodes: tests/test_torch_backward_lm.py.)"""
    d, _, files = task
    tarpa.write_arpa(backward_ngram(read_bingram(files["lm"])),
                     str(d / "back.arpa"))
    argv = ["-h", files["am"], "-v", files["dict"], "-input", "mfcfile",
            files["utts"][0]] + [a.format(d=d) for a in extra]
    for main, kw in ((trec.main, dict(device="cpu")), (jrec.main, {})):
        with pytest.raises(ValueError, match=item):
            run_main(main, argv, **kw)


def test_cli_needs_cuda_unless_cpu_is_asked(task, monkeypatch):
    d, _, files = task
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trec.main(["-C", str(d / "run.jconf"), files["utts"][0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfusion.create_engines(tparse(["-C", str(d / "run.jconf")]))
