"""Port vs reference: the model and data files (io/).

Each file is read by both packages, and each package's writer output is
read by the other's reader: HTK hmmdefs (mixtures, macros, tied-mixture
codebooks, <SID>), HMMList, binhmm (with and without embedded feature
parameters), bingram (2- and 3-gram), ARPA output, HTK parameter files,
WAV and RAW audio, dictionaries and word lists.  The arrays read must be
equal (float arrays exactly: both packages run the same numpy code on
the same bytes), and the two writers must write the same bytes.
"""

import dataclasses
import io

import numpy as np
import pytest

from julius_tpu.config import FrontendConfig as JFrontendConfig
from julius_tpu.io import arpa as jarpa
from julius_tpu.io import bingram as jbingram
from julius_tpu.io import binhmm as jbinhmm
from julius_tpu.io import hmmlist as jhmmlist
from julius_tpu.io import htk_dict as jdict
from julius_tpu.io import htk_hmm as jhtk
from julius_tpu.io import htk_param as jparam
from julius_tpu.io import wav as jwav
from julius_tpu_torch.config import FrontendConfig as TFrontendConfig
from julius_tpu_torch.io import arpa as tarpa
from julius_tpu_torch.io import bingram as tbingram
from julius_tpu_torch.io import binhmm as tbinhmm
from julius_tpu_torch.io import hmmlist as thmmlist
from julius_tpu_torch.io import htk_dict as tdict
from julius_tpu_torch.io import htk_hmm as thtk
from julius_tpu_torch.io import htk_param as tparam
from julius_tpu_torch.io import wav as twav

from fixtures import make_arpa_text, make_dict_text, make_hmmdefs_text
from test_bingram import make_trigram_text
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

MACROS = (
    '~o <VecSize> 2 <MFCC> <DIAGC>\n'
    '~v "gvar" <Variance> 2\n 1.0 2.0\n'
    '~t "tr" <TransP> 3\n 0 1 0\n 0 0.5 0.5\n 0 0 0\n'
    '~s "st" <Mean> 2\n 0.5 -0.5\n ~v "gvar"\n'
    '~h "x" <BeginHMM> <NumStates> 3\n<State> 2 ~s "st"\n~t "tr"\n'
    '<EndHMM>\n'
    '~h "y" <BeginHMM> <NumStates> 3\n<State> 2 ~s "st"\n~t "tr"\n'
    '<EndHMM>\n')
TIEDMIX = (
    '~o <VecSize> 2 <MFCC> <DIAGC>\n'
    '~m "cb1" <Mean> 2\n 0 0\n <Variance> 2\n 1 1\n'
    '~m "cb2" <Mean> 2\n 1 1\n <Variance> 2\n 1 1 <GConst> 3.5\n'
    '~h "x" <BeginHMM> <NumStates> 3\n'
    '<State> 2 <NumMixes> 2 <TMix> cb 0.7 0.3\n'
    '<TransP> 3\n 0 1 0\n 0 0.5 0.5\n 0 0 0\n<EndHMM>\n')
SID = (
    '~o <VecSize> 2 <USER> <DIAGC>\n'
    '~h "x" <BeginHMM> <NumStates> 3\n'
    '<State> 2 <SID> 42 <Mean> 2\n 0 0\n <Variance> 2\n 1 1\n'
    '<TransP> 3\n 0 1 0\n 0 0.5 0.5\n 0 0 0\n<EndHMM>\n')
HMMDEFS = {
    "mixtures": make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=8,
                                  n_states=3, n_mix=3),
    "triphones": make_hmmdefs_text(phones=("a", "b", "sil", "a-b+a"),
                                   dim=4, n_states=3, n_mix=1, seed=2),
    "macros": MACROS, "tiedmix": TIEDMIX, "sid": SID,
}


def assert_same_hmmset(a, b):
    """Every field of two HMMSets equal (arrays exactly, with dtypes)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def assert_same_para(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def assert_same_lm(a, b):
    for name in ("order", "words", "word_index", "ngrams", "direction",
                 "bos_id", "eos_id", "unk_id"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("name", sorted(HMMDEFS))
def test_hmmdefs(tmp_path, name):
    text = HMMDEFS[name]
    assert_same_hmmset(thtk.parse_hmmdefs_text(text),
                       jhtk.parse_hmmdefs_text(text))
    p = tmp_path / "hmmdefs"
    p.write_text(text)
    assert_same_hmmset(thtk.load_hmmdefs(str(p)), jhtk.load_hmmdefs(str(p)))


def test_hmmlist(tmp_path):
    text = make_hmmdefs_text(phones=("a", "b", "sil", "a-b+a"), dim=4,
                             n_mix=1)
    p = tmp_path / "tied.lst"
    p.write_text("# logical physical\na\nb\nsil\nb-b+a a-b+a\n"
                 "a-b+a\nb-a b\n")
    th, jh = thtk.parse_hmmdefs_text(text), jhtk.parse_hmmdefs_text(text)
    tm = thmmlist.load_hmmlist(str(p), th)
    assert tm == jhmmlist.load_hmmlist(str(p), jh) == th.logical_map
    assert_same_hmmset(th, jh)
    p.write_text("zz-b+a nosuchmodel\n")
    with pytest.raises(ValueError, match="not in hmmdefs"):
        thmmlist.load_hmmlist(str(p), th)


def _para(pkg_config, kind):
    cfg = pkg_config(sample_rate=16000, fbank_num=24, mfcc_dim=12,
                     use_energy=True, use_delta=True, use_accel="A" in kind,
                     cmn="Z" in kind)
    cfg.feature_type = kind
    return cfg


@pytest.mark.parametrize("kind", [None, "MFCC_E_D_Z", "MFCC_E_D_A"])
@pytest.mark.parametrize("name", ["mixtures", "tiedmix"])
def test_binhmm(tmp_path, name, kind):
    """binhmm written by either package: the same bytes, read the same
    HMMSet and embedded feature parameters by both."""
    hmm = jhtk.parse_hmmdefs_text(HMMDEFS[name])
    tp, jp = str(tmp_path / "t.binhmm"), str(tmp_path / "j.binhmm")
    tbinhmm.write_binhmm(tp, hmm, para=kind and _para(TFrontendConfig,
                                                      kind))
    jbinhmm.write_binhmm(jp, hmm, para=kind and _para(JFrontendConfig,
                                                      kind))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    th, tpara = tbinhmm.read_binhmm(jp)
    jh, jpara = jbinhmm.read_binhmm(tp)
    assert_same_hmmset(th, jh)
    assert_same_para(tpara, jpara)
    assert th.n_states == hmm.n_states and th.n_gauss == hmm.n_gauss
    np.testing.assert_array_equal(th.state_mix, hmm.state_mix)


def test_binhmm_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"JUNKJUNK\x00" * 20)
    with pytest.raises(ValueError):
        tbinhmm.read_binhmm(str(p))


@pytest.mark.parametrize("text_fn", [make_arpa_text, make_trigram_text])
def test_bingram_and_arpa(tmp_path, text_fn):
    """bingram and ARPA written by either package: the same bytes, read
    the same N-gram by both."""
    lm = jarpa.parse_arpa(io.StringIO(text_fn()))
    assert_same_lm(tarpa.parse_arpa(io.StringIO(text_fn())), lm)
    tp, jp = str(tmp_path / "t.bingram"), str(tmp_path / "j.bingram")
    tbingram.write_bingram(tp, lm)
    jbingram.write_bingram(jp, lm)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    tl, jl = tbingram.read_bingram(jp), jbingram.read_bingram(tp)
    assert_same_lm(tl, jl)
    # the file holds float32 probabilities and back-off weights
    for k in range(lm.order):
        assert set(tl.ngrams[k]) == set(lm.ngrams[k])
        for t, (prob, bo) in lm.ngrams[k].items():
            assert tl.ngrams[k][t][0] == pytest.approx(prob, abs=1e-6)
            if k < lm.order - 1:
                assert tl.ngrams[k][t][1] == pytest.approx(bo, abs=1e-6)
    ta, ja = str(tmp_path / "t.arpa"), str(tmp_path / "j.arpa")
    tarpa.write_arpa(tl, ta)
    jarpa.write_arpa(jl, ja)
    assert open(ta).read() == open(ja).read()
    assert_same_lm(tarpa.load_arpa(ja), jarpa.load_arpa(ta))


@pytest.mark.parametrize("kind", ["MFCC_E_D_A", "USER", "FBANK_D_A_Z"])
def test_htk_param(tmp_path, kind):
    data = np.random.default_rng(0).standard_normal((17, 39)).astype(
        np.float32)
    tp, jp = str(tmp_path / "t.mfc"), str(tmp_path / "j.mfc")
    tparam.write_htk_param(tp, tparam.HTKParam(data, 100000, kind))
    jparam.write_htk_param(jp, jparam.HTKParam(data, 100000, kind))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    t, j = tparam.read_htk_param(jp), jparam.read_htk_param(tp)
    assert t.kind == j.kind == kind and t.samp_period == j.samp_period
    assert np.array_equal(t.data, j.data) and np.array_equal(t.data, data)
    # a little-endian file is detected by its header in both
    le = tmp_path / "le.mfc"
    le.write_bytes(np.asarray([17, 100000], "<i4").tobytes()
                   + np.asarray([39 * 4, jparam.kind_str_to_code(kind)],
                                "<i2").tobytes() + data.astype("<f4").tobytes())
    assert np.array_equal(tparam.read_htk_param(str(le)).data,
                          jparam.read_htk_param(str(le)).data)


def test_audio_files(tmp_path):
    rng = np.random.default_rng(1)
    s = rng.integers(-20000, 20000, 3000).astype(np.float32)
    tw, jw = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    twav.write_wav(tw, s, 16000)
    jwav.write_wav(jw, s, 16000)
    assert open(tw, "rb").read() == open(jw, "rb").read()
    (t, tr), (j, jr) = twav.read_wav(jw), jwav.read_wav(tw)
    assert tr == jr == 16000 and np.array_equal(t, j)
    assert np.array_equal(t, s)
    raw = tmp_path / "a.raw"
    raw.write_bytes(s.astype(">i2").tobytes())
    for path in (str(raw), tw):
        assert np.array_equal(twav.read_audio(path), jwav.read_audio(path))
    assert np.array_equal(twav.read_raw(str(raw)), s)


def test_dictionary_and_wordlist(tmp_path):
    p = tmp_path / "words.dict"
    p.write_text(make_dict_text() + "FOO\t{foo}\ta b c\n"
                 "CLS @-0.5 word [out] :2.5 a b\n")
    assert dataclasses.asdict(tdict.load_htkdict(str(p))) \
        == dataclasses.asdict(jdict.load_htkdict(str(p)))
    w = tmp_path / "words.list"
    w.write_text("# isolated words\nAB a b\nABC a b c\nA a\n")
    assert dataclasses.asdict(tdict.load_wordlist(str(w))) \
        == dataclasses.asdict(jdict.load_wordlist(str(w)))
    w.write_text("LONELY\n")
    with pytest.raises(ValueError):
        tdict.load_wordlist(str(w))
    for phones in (["a"], ["a", "b"], ["a", "b", "c", "d"]):
        assert tdict.word_internal_triphones(phones) \
            == jdict.word_internal_triphones(phones)
