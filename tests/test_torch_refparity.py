"""Port vs reference: the reference-binary tools (tools/refbaseline.py,
tools/refparity.py).

* Every file the exports write (binhmm, HTK dictionary, ARPA, ascii
  hmmdefs, HMMList, dnnconf, npy weights, prior, wav) is byte-equal to
  what the JAX package writes for the same seed, and the objects the
  exports return equal the reference's;
* the port's readers read the exported files back to the in-memory
  model: binary tables (binhmm, npy) bit-equal (a square DNN layer
  transposed, as the reference's reader reads it), text tables (ARPA,
  prior) equal to the in-memory values at their printed digits;
* `parse_ref_output` and `wer` on fixed text;
* `--update-baseline PATH` writes PATH and nothing else;
* the scenarios that drive the julius 4.6 binary run only where
  `JULIUS_BIN` names one, as tests/test_reference_binary.py does, and
  skip here."""

import filecmp
import json
import math
import os

import numpy as np
import pytest

from julius_tpu.tools import refbaseline as jrb
from julius_tpu.tools import refparity as jrp
from julius_tpu_torch.io.arpa import load_arpa
from julius_tpu_torch.io.binhmm import read_binhmm
from julius_tpu_torch.io.dnn import load_dnn, parse_dnnconf
from julius_tpu_torch.io.htk_dict import load_htkdict
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.tools import refbaseline as trb
from julius_tpu_torch.tools import refparity as trp

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

BASE = dict(n_words=60, n_phones=20, hidden=64, n_layers=2)
FLAG = dict(n_phones=20, n_words=60, hidden=64, n_layers=3, dim=16,
            context=3)
TRI = dict(n_base=8, variants=4, n_words=50, dim=8, tied_pool=60)
JULIUS_BIN = os.environ.get("JULIUS_BIN", "")


def snapshot(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def export_both(tmp_path, fn_ref, fn_port):
    """Run the reference's export, then the port's, into one directory
    (the dnnconf names its directory); every file byte-equal."""
    want = fn_ref(tmp_path)
    ref_files = snapshot(tmp_path)
    for name in ref_files:
        (tmp_path / name).unlink()
    got = fn_port(tmp_path)
    port_files = snapshot(tmp_path)
    assert sorted(port_files) == sorted(ref_files)
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    return got, want


def test_refbaseline_export_is_byte_equal(tmp_path):
    got, want = export_both(
        tmp_path, lambda d: jrb.export_model(str(d), **BASE),
        lambda d: trb.export_model(str(d), **BASE))
    assert got == want
    assert {"flagship.binhmm", "flagship.dict", "flagship.arpa",
            "flagship.dnnconf", "htkconfig", "prior.dnn", "W1.npy",
            "B2.npy", "W_out.npy"} <= set(os.listdir(tmp_path))


def test_refbaseline_wavs_are_byte_equal(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jw = jrb.write_wavs(str(tmp_path / "j"), 2, audio_sec=0.25)
    tw = trb.write_wavs(str(tmp_path / "t"), 2, audio_sec=0.25)
    assert [os.path.basename(p) for p in tw] == \
        [os.path.basename(p) for p in jw]
    for a, b in zip(jw, tw):
        assert filecmp.cmp(a, b, shallow=False)


def test_refbaseline_export_reads_back(tmp_path):
    from julius_tpu_torch.tools.synth import (make_dnn, make_hmmset,
                                              make_ngram, make_vocabulary)
    paths = trb.export_model(str(tmp_path), **BASE)
    hmm = make_hmmset(n_phones=BASE["n_phones"], dim=120, seed=0)
    voca = make_vocabulary(hmm, n_words=BASE["n_words"], seed=1)
    lm = make_ngram(voca, seed=2)
    dnn = make_dnn(dim_in=1320, hidden=BASE["hidden"],
                   n_layers=BASE["n_layers"], n_out=hmm.n_states, seed=3)
    rhmm, para = read_binhmm(paths["hmm"])
    for f in ("means", "ivars", "gconst", "state_mix", "phone_states",
              "phone_trans"):
        assert np.array_equal(getattr(rhmm, f), getattr(hmm, f)), f
    assert para.fbank_num == 40
    rvoca = load_htkdict(paths["dict"])
    assert rvoca.names == voca.names and rvoca.phones == voca.phones
    rlm = load_arpa(paths["lm"])
    for k in (0, 1):
        assert set(rlm.ngrams[k]) == set(lm.ngrams[k])
        for t, (p, _) in lm.ngrams[k].items():
            assert rlm.ngrams[k][t][0] == float(f"{p:.6f}")
    rdnn = load_dnn(parse_dnnconf(paths["dnnconf"]), str(tmp_path))
    assert_read_back(rdnn, dnn, paths["dnnconf"], str(tmp_path))
    for a, b in zip(rdnn.biases + [rdnn.output_b],
                    dnn.biases + [dnn.output_b]):
        assert np.array_equal(a, b)


def assert_read_back(rdnn, dnn, conf, base):
    """The npy weights read back bit-equal, as the reference's reader
    reads them: the files hold [out][in] rows and the reader turns a
    layer back to [in][out] only when it is not square, so a square
    hidden layer comes back transposed (a reference defect the port
    keeps; ROADMAP.md queue 3)."""
    from julius_tpu.io.dnn import load_dnn as jload_dnn
    from julius_tpu.io.dnn import parse_dnnconf as jparse_dnnconf
    want = jload_dnn(jparse_dnnconf(conf), base)
    n_square = 0
    for a, b, w in zip(rdnn.weights + [rdnn.output_w],
                       dnn.weights + [dnn.output_w],
                       want.weights + [want.output_w]):
        assert np.array_equal(a, w)
        square = b.shape[0] == b.shape[1]
        n_square += square
        assert np.array_equal(a, b.T if square else b)
    assert n_square > 0


def test_refparity_flagship_export_is_byte_equal(tmp_path):
    got, want = export_both(
        tmp_path, lambda d: jrp.export_flagship(str(d), **FLAG),
        lambda d: trp.export_flagship(str(d), **FLAG))
    ghmm, gvoca, glm, gdnn, gprotos = got
    whmm, wvoca, wlm, wdnn, wprotos = want
    for f in ("means", "ivars", "state_mix", "phone_states", "phone_trans"):
        assert np.array_equal(getattr(ghmm, f), getattr(whmm, f)), f
    assert gvoca.names == wvoca.names and glm.ngrams == wlm.ngrams
    for a, b in zip(gdnn.weights + [gdnn.output_w, gdnn.log_prior],
                    wdnn.weights + [wdnn.output_w, wdnn.log_prior]):
        assert np.array_equal(a, b)
    assert np.array_equal(gprotos, wprotos)
    # the exported DNN reads back, its prior at %e digits
    conf = str(tmp_path / "dnn.conf")
    rdnn = load_dnn(parse_dnnconf(conf), str(tmp_path))
    assert_read_back(rdnn, gdnn, conf, str(tmp_path))
    assert rdnn.context_len == FLAG["context"]
    n_out = ghmm.n_states
    np.testing.assert_allclose(rdnn.log_prior, math.log10(
        float(f"{1.0 / n_out:e}")), rtol=0, atol=1e-6)


def test_refparity_triphone_export_is_byte_equal(tmp_path):
    got, want = export_both(
        tmp_path, lambda d: jrp.export_triphone(str(d), **TRI),
        lambda d: trp.export_triphone(str(d), **TRI))
    assert got[1].names == want[1].names
    assert got[0].logical_map == want[0].logical_map
    assert {"hmmdefs", "hmmlist", "words.dict", "lm.arpa"} == \
        set(os.listdir(tmp_path))
    rng = [np.random.default_rng(3), np.random.default_rng(3)]
    seq = [0, 5, 9, 1]
    a = trp._triphone_utt_frames(got[0], got[1], seq, rng[0])
    b = jrp._triphone_utt_frames(want[0], want[1], seq, rng[1])
    assert np.array_equal(a, b)


def test_generated_text_models_and_frames_match():
    phones = [f"ph{i}" for i in range(6)] + ["sil"]
    for kw in (dict(kind="USER"), dict(kind="MFCC", with_sid=True)):
        text = trp.gen_hmmdefs(phones, 5, 3, 2, seed=1, **kw)
        assert text == jrp.gen_hmmdefs(phones, 5, 3, 2, seed=1, **kw)
    dtext, words = trp.gen_dict(phones, 12, seed=2)
    assert (dtext, words) == jrp.gen_dict(phones, 12, seed=2)
    atext = trp.gen_arpa([w for w, _ in words], seed=3)
    assert atext == jrp.gen_arpa([w for w, _ in words], seed=3)
    hmm = parse_hmmdefs_text(trp.gen_hmmdefs(phones, 5, 3, 2, seed=1))
    pids = [0, 3, 6]
    a = trp.sample_frames(hmm, pids, np.random.default_rng(4))
    b = jrp.sample_frames(hmm, pids, np.random.default_rng(4))
    assert a.dtype == np.float32 and np.array_equal(a, b)


REF_OUTPUT = """\
STAT: include config
input MFCC file: utt000.mfc
pass1_best: W0001 W0002
sentence1: W0001 W0003
input MFCC file: utt001.mfc
pass1_best: W0004
<search failed>
input MFCC file: utt002.mfc
sentence1:
input MFCC file: utt003.mfc
pass1_best: W0007 W0008
sentence1: W0007  W0008 W0009
"""


def test_parse_ref_output_and_wer():
    got = trp.parse_ref_output(REF_OUTPUT)
    assert got == jrp.parse_ref_output(REF_OUTPUT)
    assert got == [["W0001", "W0003"], ["W0004"], [],
                   ["W0007", "W0008", "W0009"]]
    assert trp.parse_ref_output("") == []
    for ref, hyp in ((["a", "b", "c"], ["a", "x", "c", "d"]),
                     ([], ["a"]), (["a", "b"], []), (["a"], ["a"])):
        assert trp.wer(ref, hyp) == jrp.wer(ref, hyp)
    assert trp.wer(["a", "b", "c"], ["a", "x", "c", "d"]) == (2, 3)


def test_update_baseline_writes_only_the_given_path(tmp_path, monkeypatch):
    repo_baseline = os.path.join(os.path.dirname(__file__), os.pardir,
                                 "BASELINE.json")
    before = open(repo_baseline, "rb").read()
    path = tmp_path / "base.json"
    path.write_text(json.dumps({"kept": 1}))
    seen = {}

    def fake(ref, workdir, n_utts, seed=0, device="cuda"):
        seen.update(ref=ref, workdir=workdir, n=n_utts, device=device)
        return {"ref_xrt": 2.5, "ref_wer": 0.1, "our_wer": 0.0}

    monkeypatch.setattr(trp, "scenario_small", fake)
    r = trp.main(["--ref", "julius", "--n-utts", "3", "--workdir",
                  str(tmp_path / "w"), "--update-baseline", str(path)],
                 device="cpu")
    assert r["ref_xrt"] == 2.5
    assert seen == dict(ref="julius", workdir=str(tmp_path / "w"), n=3,
                        device="cpu")
    assert json.loads(path.read_text()) == {
        "kept": 1, "measured": {"ref_xrt": 2.5, "ref_wer": 0.1,
                                "our_wer": 0.0, "scale": "small",
                                "n_utts": 3}}
    assert open(repo_baseline, "rb").read() == before
    assert sorted(os.listdir(tmp_path)) == ["base.json"]


def test_refbaseline_needs_a_binary(monkeypatch, capsys):
    monkeypatch.delenv("JULIUS_BIN", raising=False)
    with pytest.raises(SystemExit):
        trb.main(["--scale", "small"])
    assert "JULIUS_BIN" in capsys.readouterr().err


@pytest.mark.parametrize("scale", ["small", "triphone"])
def test_scenarios_against_the_reference_binary(tmp_path, scale):
    """Transcript parity with the julius 4.6 binary, the port decoding
    on the CPU; runs only where JULIUS_BIN names a built binary."""
    if not os.path.exists(JULIUS_BIN):
        pytest.skip("reference julius binary not built (set JULIUS_BIN)")
    fn = {"small": trp.scenario_small, "triphone": trp.scenario_triphone}
    r = fn[scale](JULIUS_BIN, str(tmp_path), 4, device="cpu")
    assert r["transcript_agreement"] >= 0.75


def test_wide_feature_files_read_back(tmp_path):
    """The spliced DNN input rows refparity writes for the reference
    binary (11 x 120 = 1320 floats, 5280 bytes a vector) read back in
    the port; julius_tpu's reader takes such a header for a
    little-endian one and raises (a deliberate difference, ROADMAP.md
    queue 3).  Narrow files read as the reference's reader reads them."""
    from julius_tpu.io.htk_param import read_htk_param as jread
    from julius_tpu_torch.io.htk_param import (HTKParam, read_htk_param,
                                               write_htk_param)
    rng = np.random.default_rng(0)
    for dim in (1320, 39):
        data = rng.standard_normal((7, dim)).astype(np.float32)
        path = str(tmp_path / f"w{dim}.mfc")
        write_htk_param(path, HTKParam(data=data, samp_period=100000,
                                       kind="USER"))
        got = read_htk_param(path)
        assert got.kind == "USER" and np.array_equal(got.data, data)
        if dim > 1250:
            with pytest.raises(ValueError, match="corrupted"):
                jread(path)
        else:
            assert np.array_equal(jread(path).data, data)
