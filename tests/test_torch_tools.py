"""Port vs reference: the command line's plugins and model checks
(plugins.py, tools/checkmodel.py, -plugindir and -check in
tools/recognize.py) and the offline tools (tools/profile.py,
tools/modeltools.py, tools/wer.py, tools/visualize.py).

The same inputs (files and numpy arrays, from seeds) go through both
packages, on the CPU:

* `recognize.main` with -plugindir prints the same lines (decimal
  numbers within atol 1e-2, as tests/test_torch_cli.py holds them), on
  feature files (a plugin's fvin_postprocess, -check triphone beside
  it) and on waveforms (its adin_postprocess halves the samples); the
  plugin receives the same calls, its best strings equal to the
  printed sentence1 lines;
* the checkers return the same dicts (monophone and triphone models, a
  model missing a phone, networks, LM coverage), and -check and
  checkmodel.main print the same lines;
* profile_stages returns the reference's stage keys, and the trace
  option writes a Chrome trace;
* every modeltools subcommand writes the same files and prints the same
  text;
* align_counts, WERResult, score_files and synthetic_eval(n_utts=3) give
  the same numbers;
* the visualizer's text and SVG are equal for the same trellis, and its
  command line writes the same files (numbers within atol 1e-2);
* the tools' entry points need CUDA unless the CPU is asked for.
"""

import contextlib
import io
import json
import re
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu import plugins as jplugins
from julius_tpu.engine import Engine as JEngine
from julius_tpu.engine import Result as JResult
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.search.network import build_network as jbuild_network
from julius_tpu.tools import checkmodel as jcheck
from julius_tpu.tools import modeltools as jmt
from julius_tpu.tools import profile as jprofile
from julius_tpu.tools import recognize as jrec
from julius_tpu.tools import visualize as jvis
from julius_tpu.tools import wer as jwer
from julius_tpu.tools.synth import flagship_engine as jflagship
from julius_tpu.utils.callback import CallbackRegistry as JRegistry
from julius_tpu_torch import plugins as tplugins
from julius_tpu_torch.engine import Result as TResult
from julius_tpu_torch.io.arpa import parse_arpa
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param
from julius_tpu_torch.io.wav import write_wav
from julius_tpu_torch.search.network import build_network
from julius_tpu_torch.tools import checkmodel as tcheck
from julius_tpu_torch.tools import modeltools as tmt
from julius_tpu_torch.tools import profile as tprofile
from julius_tpu_torch.tools import recognize as trec
from julius_tpu_torch.tools import visualize as tvis
from julius_tpu_torch.tools import wer as twer
from julius_tpu_torch.tools.synth import flagship_engine, write_gmm_task
from julius_tpu_torch.utils.callback import CallbackRegistry as TRegistry

from fixtures import make_arpa_text, make_dict_text, make_hmmdefs_text, \
    sample_states_and_frames
from test_torch_cli import assert_same_lines, run_main
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

TASK = dict(n_utts=3, n_words=60, n_phones=24, dim=39, n_mix=4,
            min_words=2, max_words=4)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The small GMM-HMM task of tests/test_torch_cli.py as files, and a
    16 kHz WAV beside it."""
    d = tmp_path_factory.mktemp("tools_task")
    truths, files = write_gmm_task(str(d), **TASK)
    rng = np.random.default_rng(5)
    wave = (np.sin(2 * np.pi * 300 * np.arange(12000) / 16000) * 6000
            + rng.standard_normal(12000) * 700).astype(np.float32)
    write_wav(str(d / "tone.wav"), wave, 16000)
    files["wav"] = str(d / "tone.wav")
    return d, truths, files


# ---------------------------------------------------------------------------
# plugins and -check through the command line
# ---------------------------------------------------------------------------

PLUGIN = '''import json
import pathlib

OUT = pathlib.Path({out!r})
LOG = []


def _log(*a):
    LOG.append(list(a))
    OUT.write_text(json.dumps(LOG))


def initialize():
    _log("initialize")


def startup(engines):
    _log("startup", len(engines))


def result_best_str(s):
    _log("best", s)


def result_error(code):
    _log("error", str(code))


def fvin_postprocess(v):
    _log("fvin", list(v.shape))
    return v


def adin_postprocess(samples):
    _log("adin", int(len(samples)))
    return samples * 0.5


callbacks = {{"result": lambda r: _log("callback", bool(r.valid))}}
'''

PLUGIN_CASES = {
    "mfcfile": ["-C", "{d}/run.jconf", "-check", "triphone", "{u0}",
                "{u1}"],
    "rawfile": ["-h", "{am}", "-v", "{dict}", "-d", "{lm}", "-input",
                "rawfile", "{wav}", "{u2wav}"],
}


@pytest.mark.parametrize("case", sorted(PLUGIN_CASES))
def test_plugins_print_and_receive_like_reference(task, case):
    d, _, files = task
    (d / "run.jconf").write_text(
        f"-h {files['am']}\n-v {files['dict']}\n-d {files['lm']}\n"
        "-input mfcfile\n-batchsize 2\n")
    shutil.copy(files["wav"], d / "tone2.wav")
    lines, logs = {}, {}
    for pkg, main, kw in (("torch", trec.main, dict(device="cpu")),
                          ("jax", jrec.main, {})):
        pdir = d / f"plugins_{case}_{pkg}"
        pdir.mkdir()
        out = d / f"plugin_{case}_{pkg}.json"
        (pdir / "recv.py").write_text(PLUGIN.format(out=str(out)))
        argv = [a.format(d=d, u0=files["utts"][0], u1=files["utts"][1],
                         u2wav=d / "tone2.wav", **files)
                for a in PLUGIN_CASES[case]] + ["-plugindir", str(pdir)]
        lines[pkg] = run_main(main, argv, **kw)
        logs[pkg] = json.loads(out.read_text())
    assert_same_lines(lines["torch"], lines["jax"])
    assert logs["torch"] == logs["jax"]
    got = lines["torch"]
    best = [a[1] for a in logs["torch"] if a[0] == "best"]
    assert best == [ln.split(": ", 1)[1] for ln in got
                    if ln.startswith("sentence1: ")]
    assert len(best) == 2 and logs["torch"][:2] == [["initialize"],
                                                   ["startup", 1]]
    kinds = [a[0] for a in logs["torch"]]
    assert kinds.count("callback") == 2
    if case == "mfcfile":
        assert kinds.count("fvin") == 2 and "adin" not in kinds
        assert got[0].startswith("-check triphone: {")
    else:
        assert kinds.count("adin") == 2 and "fvin" not in kinds


def test_plugin_manager_matches_reference(tmp_path):
    """load_dir skips '_' files and files that fail to load, and the
    result receiver gets the error path for a rejected result."""
    (tmp_path / "_private.py").write_text("raise RuntimeError('no')\n")
    (tmp_path / "broken.py").write_text("raise RuntimeError('broken')\n")
    (tmp_path / "notes.txt").write_text("not a plugin\n")
    (tmp_path / "recv.py").write_text(PLUGIN.format(
        out=str(tmp_path / "log.json")))
    got = {}
    for name, mod, Registry, Result in (
            ("torch", tplugins, TRegistry, TResult),
            ("jax", jplugins, JRegistry, JResult)):
        pm = mod.PluginManager()
        n = pm.load_dir(str(tmp_path))
        missing = pm.load_dir(str(tmp_path / "nowhere"))
        eng = types.SimpleNamespace(callbacks=Registry())
        pm.startup([eng])
        eng.callbacks.exec("result", Result(words=["<s>", "AB", "</s>"],
                                            texts=["", "ab", ""]))
        eng.callbacks.exec("result", Result(valid=False,
                                            reject_reason="too short"))
        x = np.arange(6, dtype=np.float32)
        got[name] = (n, missing, pm.adin_postprocess(x).tolist(),
                     pm.fvin_postprocess(x.reshape(2, 3)).tolist(),
                     json.loads((tmp_path / "log.json").read_text()))
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (1, 0)
    assert ["best", "ab"] in got["torch"][4]
    assert ["error", "too short"] in got["torch"][4]


def check_models():
    """Monophone, triphone and missing-phone model / dictionary texts."""
    tri = ("a", "b", "c", "sil", "a-b+c", "b-c+a", "sil-a+b", "c-a")
    words = [("<s>", "[]", ["sil"]), ("</s>", "[]", ["sil"]),
             ("ABC", "[abc]", ["a", "b", "c"]),
             ("CAB", "[cab]", ["c", "a", "b"]), ("BA", "[ba]", ["b", "a"])]
    return {
        "mono": (make_hmmdefs_text(), make_dict_text()),
        "triphone": (make_hmmdefs_text(phones=tri), make_dict_text(words)),
        "missing": (make_hmmdefs_text(phones=("a", "sil")),
                    make_dict_text([("<s>", "[]", ["sil"]),
                                    ("BAD", "[bad]", ["a", "zz"])])),
    }


@pytest.mark.parametrize("case", ["mono", "triphone", "missing"])
def test_checkers_return_the_reference_dicts(case):
    hmm_text, dict_text = check_models()[case]
    out = {}
    for name, mod, parse_hmm, Voca, parse_dict, build, parse_lm in (
            ("torch", tcheck, parse_hmmdefs_text, Vocabulary,
             parse_dict_line, build_network, parse_arpa),
            ("jax", jcheck, jparse_hmm, JVocabulary, jparse_dict,
             jbuild_network, jparse_arpa)):
        hmm = parse_hmm(hmm_text)
        voca = Voca()
        for line in dict_text.splitlines():
            parse_dict(line, voca)
        r = dict(hmm=mod.check_hmm(hmm),
                 cov=mod.check_triphone_coverage(hmm, voca),
                 lm=mod.check_lm_coverage(voca, parse_lm(
                     io.StringIO(make_arpa_text()))))
        if case != "missing":
            r["net"] = mod.check_network(build(hmm, voca))
        out[name] = r
    assert out["torch"] == out["jax"]
    cov = out["torch"]["cov"]
    if case == "missing":
        assert cov["missing_names"] == ["zz"]
    elif case == "triphone":
        assert cov["exact"] > 0 and cov["n_names"] > cov["exact"]


def capture(main, argv, **kw):
    """(return code, stdout lines, stderr lines) of main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def test_check_modes_print_like_reference(task):
    """-check triphone / wchmm / hmm / lm (and an unknown mode, a
    warning) without inputs, and checkmodel.main, print the same lines
    in both packages."""
    files = task[2]
    models = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"]]
    argv = models + [a for m in ("triphone", "wchmm", "hmm", "lm", "nosuch")
                     for a in ("-check", m)]
    got = capture(trec.main, argv, device="cpu")
    want = capture(jrec.main, argv)
    assert got[:2] == want[:2] and got[0] == 0
    assert [ln for ln in got[2] if "-check" in ln] == \
        [ln for ln in want[2] if "-check" in ln]
    assert [ln.split(":")[0] for ln in got[1]] == [
        "-check triphone", "-check wchmm", "-check hmm", "-check lm"]
    assert any("-check nosuch" in ln for ln in got[2])
    got = capture(tcheck.main, models, device="cpu")
    want = capture(jcheck.main, models)
    assert got[:2] == want[:2] and got[0] == 0 and len(got[1]) == 5


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

SMALL = dict(trained=True, n_words=120, n_phones=48, hidden=128,
             n_layers=2)


def test_profile_stages_and_trace(tmp_path):
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, 8000)) * 2000).astype(np.float32)
    lens = np.asarray([8000, 6400], np.int32)
    teng, _ = flagship_engine(device="cpu", **SMALL)
    jeng, _ = jflagship(**SMALL)
    got = tprofile.profile_stages(teng, wave, lens, n_iter=1)
    want = jprofile.profile_stages(jeng, wave, lens, n_iter=1)
    assert list(got) == list(want) == [
        "features", "outprob", "pass1", "pass2+host", "total", "xRT"]
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    assert got["total"] == pytest.approx(sum(
        got[k] for k in ("features", "outprob", "pass1", "pass2+host")))
    assert got["xRT"] == pytest.approx(14400 / 16000 / got["total"])
    stats = tprofile.trace_stages(teng, wave, lens, str(tmp_path / "tr"))
    assert list(stats) == list(want)
    trace = json.loads((tmp_path / "tr" / tprofile.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


# ---------------------------------------------------------------------------
# modeltools
# ---------------------------------------------------------------------------

GRAMMAR = ("S : NS_B SENT NS_E\nSENT : WORD\nSENT : WORD WORD\n"
           "SENT : WORD AND WORD\nWORD : W\nAND : A\n")
VOCA = ("% NS_B\nsilb sil\n% NS_E\nsile sil\n% W\nhello a b\nbye b a\n"
        "cab c a b\n% A\nand a c\n")


@pytest.fixture(scope="module")
def tool_inputs(tmp_path_factory):
    """Inputs of the model tools: an ARPA LM and its bingram, hmmdefs
    and an HTK config, a grammar compiled by the reference's mkdfa, a
    near-silent WAV."""
    d = tmp_path_factory.mktemp("modeltools_in")
    (d / "lm.arpa").write_text(make_arpa_text())
    (d / "am.hmm").write_text(make_hmmdefs_text(dim=8))
    (d / "Config").write_text(
        "SOURCERATE = 625\nTARGETKIND = MFCC_E\nNUMCEPS = 12\n")
    (d / "g.grammar").write_text(GRAMMAR)
    (d / "g.voca").write_text(VOCA)
    with contextlib.redirect_stdout(io.StringIO()):
        assert jmt.main(["mkbingram", str(d / "lm.arpa"),
                         str(d / "lm.bingram")]) == 0
        assert jmt.main(["mkdfa", str(d / "g")]) == 0
    rng = np.random.default_rng(9)
    write_wav(str(d / "silence.wav"),
              (rng.standard_normal(16000) * 40).astype(np.float32), 16000)
    return d


MODELTOOLS = {
    "mkbingram": ["{i}/lm.arpa", "{o}/lm.bingram"],
    "binlm2arpa": ["{i}/lm.bingram", "{o}/lm.arpa"],
    "mkbinhmm": ["-htkconf", "{i}/Config", "{i}/am.hmm", "{o}/am.binhmm"],
    "mkdfa": ["{o}/g"],
    "generate-ngram": ["{i}/lm.bingram", "-n", "4"],
    "accept-check": ["{i}/g", "silb hello sile", "silb bye and cab sile",
                     "hello silb", "silb nosuch sile"],
    "generate": ["{i}/g", "-n", "5"],
    "dfa-minimize": ["{i}/g.dfa", "{o}/min.dfa"],
    "dfa-determinize": ["{i}/g.dfa"],
    "nextword": ["{i}/g", "", "silb", "silb hello and"],
    "mkss": ["{i}/silence.wav", "{o}/noise.ss"],
    "mkgshmm": ["{i}/am.hmm", "{o}/gs.hmm"],
}


@pytest.mark.parametrize("cmd", sorted(MODELTOOLS))
def test_modeltools_match_reference(tool_inputs, tmp_path, cmd):
    out = {}
    for name, mod in (("torch", tmt), ("jax", jmt)):
        o = tmp_path / name
        o.mkdir()
        if cmd == "mkdfa":
            for ext in ("grammar", "voca"):
                shutil.copy(tool_inputs / f"g.{ext}", o / f"g.{ext}")
        argv = [cmd] + [a.format(i=tool_inputs, o=o)
                        for a in MODELTOOLS[cmd]]
        rc, lines, err = capture(mod.main, argv)
        out[name] = (rc, [ln.replace(str(o), "OUT") for ln in lines], err,
                     {p.name: p.read_bytes() for p in sorted(o.iterdir())})
    assert out["torch"] == out["jax"]
    rc, lines, _, files = out["torch"]
    assert rc == (1 if cmd == "accept-check" else 0)
    assert lines or files


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------

def sentence_pairs(n=40, seed=3):
    rng = np.random.default_rng(seed)
    vocab = list("abcdef")
    return [([vocab[i] for i in rng.integers(0, 6, rng.integers(0, 7))],
             [vocab[i] for i in rng.integers(0, 6, rng.integers(0, 7))])
            for _ in range(n)]


def test_wer_scoring_matches_reference(tmp_path):
    pairs = sentence_pairs()
    for ref, hyp in pairs:
        assert twer.align_counts(ref, hyp) == jwer.align_counts(ref, hyp)
    got, want = twer.WERResult(), jwer.WERResult()
    for ref, hyp in pairs:
        got.add(ref, hyp)
        want.add(ref, hyp)
    assert vars(got) == vars(want) and str(got) == str(want)
    assert (got.wer, got.ser) == (want.wer, want.ser)
    (tmp_path / "ref.txt").write_text(
        "".join(" ".join(r) + "\n" for r, _ in pairs))
    (tmp_path / "hyp.txt").write_text(
        "".join(" ".join(h) + "\n" for _, h in pairs))
    paths = [str(tmp_path / "ref.txt"), str(tmp_path / "hyp.txt")]
    assert vars(twer.score_files(*paths)) == vars(jwer.score_files(*paths))
    assert capture(twer.main, paths, device="cpu") == \
        capture(jwer.main, paths)
    assert capture(twer.main, [], device="cpu")[0] == 1


def test_synthetic_eval_matches_reference():
    got = twer.synthetic_eval(noise=0.8, n_utts=3, seed=2, device="cpu")
    want = jwer.synthetic_eval(noise=0.8, n_utts=3, seed=2)
    assert vars(got) == vars(want)
    assert got.n_sent == 3 and got.n_ref > 0


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vis_task(tmp_path_factory):
    """The reference's small GMM N-gram model as files and a jconf, one
    utterance of it as an HTK parameter file, and the reference
    engine's trellis and pass-2 result of it."""
    d = tmp_path_factory.mktemp("visualize")
    hmm_text, dict_text = make_hmmdefs_text(), make_dict_text()
    (d / "am.hmm").write_text(hmm_text)
    (d / "words.dict").write_text(dict_text)
    (d / "lm.arpa").write_text(make_arpa_text())
    (d / "run.jconf").write_text(f"-h {d}/am.hmm\n-v {d}/words.dict\n"
                                 f"-d {d}/lm.arpa\n-input mfcfile\n")
    hmm = jparse_hmm(hmm_text)
    voca = JVocabulary()
    for line in dict_text.splitlines():
        jparse_dict(line, voca)
    eng = JEngine(hmm, voca, jparse_arpa(io.StringIO(make_arpa_text())))
    name2id = {n: i for i, n in enumerate(voca.names)}
    pids = [hmm.phone_index[p] for w in ("<s>", "AB", "ABC", "BA", "</s>")
            for p in voca.phones[name2id[w]]]
    frames, _ = sample_states_and_frames(hmm, pids,
                                         np.random.default_rng(4))
    write_htk_param(str(d / "utt.mfc"), HTKParam(
        data=frames, samp_period=100000, kind="MFCC_E"))
    n = frames.shape[0]
    tr = eng._pass1_jit(eng._outprob_jit(jnp.asarray(frames[None])),
                        jnp.asarray([n]))
    tb = type(tr)(*[np.asarray(a)[0] for a in tr])
    return d, tb, n, voca.names, eng._pass2_result(tb, n)


def test_renderers_match_reference(vis_task):
    _, tb, n, names, res = vis_task
    assert tvis.trellis_to_text(tb, n, names) == \
        jvis.trellis_to_text(tb, n, names)
    for kw in (dict(), dict(max_atoms=5)):
        assert tvis.trellis_to_text(tb, n, names, **kw) == \
            jvis.trellis_to_text(tb, n, names, **kw)
    svg = tvis.trellis_to_svg(tb, n, names, nbest=[res])
    assert svg == jvis.trellis_to_svg(tb, n, names, nbest=[res])
    assert "stroke='red'" in svg
    empty = type(tb)(*[np.full_like(a, -1) if a.dtype.kind == "i" else a
                       for a in tb])
    assert tvis.trellis_to_svg(empty, n, names) == \
        jvis.trellis_to_svg(empty, n, names)


@pytest.mark.parametrize("mode", ["text", "svg"])
def test_visualize_main_matches_reference(vis_task, mode):
    d = vis_task[0]
    written = {}
    for name, main, kw in (("torch", tvis.main, dict(device="cpu")),
                           ("jax", jvis.main, {})):
        dest = d / f"{name}.{mode}"
        argv = ["-C", str(d / "run.jconf"), str(d / "utt.mfc"), "-o",
                str(dest)] + (["-text"] if mode == "text" else [])
        rc, lines, _ = capture(main, argv, **kw)
        assert rc == 0 and lines == [f"visualized {d}/utt.mfc -> {dest}"]
        written[name] = dest.read_text().splitlines()
    assert_same_lines(written["torch"], written["jax"])
    assert len(written["torch"]) > 3


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_tool_entry_points_need_cuda_unless_cpu_is_asked(task, vis_task,
                                                         monkeypatch):
    files = task[2]
    models = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"]]
    vis = ["-C", str(vis_task[0] / "run.jconf"),
           str(vis_task[0] / "utt.mfc"), "-text", "-o",
           str(vis_task[0] / "cuda_check.txt")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tcheck.main, models), (tvis.main, vis),
                       (twer.main, ["--synthetic", "0.0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert capture(tcheck.main, models, device="cpu")[0] == 0
    assert capture(tvis.main, vis, device="cpu")[0] == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twer.synthetic_eval(n_utts=1)
    assert re.match(r"WER", str(twer.synthetic_eval(n_utts=1,
                                                    device="cpu")))
