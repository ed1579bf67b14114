"""Port vs reference: the waveform front end (frontend/mfcc.py) and the
engine's waveform entry point `recognize_batch`.

`extract_features` runs in both packages on the same seeded waveforms of
ragged lengths (one shorter than a frame), for the flagship's 40-channel
FBANK_D_A, the default FrontendConfig (MFCC with energy, deltas, CMN),
CMN with CVN, static CMN/CVN vectors, energy normalisation, c0, and
spectral subtraction with a noise spectrum.  Frame masks are equal;
features agree within atol 1e-4 + rtol 1e-4: the FFTs round differently
(about 1e-7 of the largest bin), which the log of a weak filterbank
channel, the lifter and CVN's division raise to a few 1e-5.  Splicing is
a gather and is exact.

`recognize_batch` on a small flagship engine (the reference's tables
carried across by convert.py): the port's waveform path equals its own
feature path exactly; against the reference, frame counts and trellis
integers are equal, outprobs within atol 1e-4, trellis scores within
atol 1e-3, result scores within atol 1e-2, and word ids equal where the
reference's best sentence leads its second by more than that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.config import FrontendConfig as JaxFrontendConfig
from julius_tpu.config import parse_feature_type as jax_feature_type
from julius_tpu.frontend import mfcc as jfe
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch.config import FrontendConfig, parse_feature_type
from julius_tpu_torch.frontend import mfcc as tfe

from test_torch_pass2_device import converted_engine
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
LENGTHS = (16000, 11234, 5000, 300)
ATOL = RTOL = 1e-4


def waves(seed, lengths=LENGTHS):
    """Seeded speech-like waveforms (two tones and noise) of ragged
    lengths, zero past each length."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lengths), max(lengths)), np.float32)
    t = np.arange(max(lengths)) / 16000.0
    for b, n in enumerate(lengths):
        f0, f1 = 150.0 + 90.0 * b, 900.0 + 310.0 * b
        out[b, :n] = (2500.0 * np.sin(2 * np.pi * f0 * t[:n])
                      + 900.0 * np.sin(2 * np.pi * f1 * t[:n] + b)
                      + 300.0 * rng.standard_normal(n))
    return out, np.asarray(lengths, np.int32)


def configs(case):
    """(reference config, port config, extract_features keywords as
    numpy arrays) for one test case."""
    kind, extra = {
        "fbank_d_a_40": ("FBANK_D_A", dict(fbank_num=40)),
        "default": (None, {}),
        "cmn_cvn": ("MFCC_E_D_A_Z", dict(cvn=True)),
        "static_cmn_cvn": ("MFCC_E_D_Z", dict(cvn=True)),
        "enormal": ("MFCC_E_D_N_Z", dict(energy_normalize=True, escale=0.1)),
        "c0": ("MFCC_0_D_Z", {}),
        "noise": (None, {}),
    }[case]
    jc = jax_feature_type(kind) if kind else JaxFrontendConfig()
    tc = parse_feature_type(kind) if kind else FrontendConfig()
    for k, v in extra.items():
        setattr(jc, k, v)
        setattr(tc, k, v)
    rng = np.random.default_rng(7)
    kw = {}
    if case == "noise":
        kw["noise_spectrum"] = (150.0 * np.abs(rng.standard_normal(
            tc.fft_size // 2 + 1))).astype(np.float32)
    if case == "static_cmn_cvn":
        kw["cmn_mean"] = rng.standard_normal(tc.veclen).astype(np.float32)
        kw["cvn_var"] = (0.5 + rng.random(tc.veclen)).astype(np.float32)
    return jc, tc, kw


@pytest.mark.parametrize("case", ["fbank_d_a_40", "default", "cmn_cvn",
                                  "static_cmn_cvn", "enormal", "c0",
                                  "noise"])
def test_extract_features_matches_reference(case):
    jc, tc, kw = configs(case)
    assert tfe.build_tables(tc).mel_w.tobytes() == \
        jfe.build_tables(jc).mel_w.tobytes()
    wave, lens = waves(len(case))
    want, wmask = jfe.extract_features(
        jnp.asarray(wave), jnp.asarray(lens), jfe.build_tables(jc),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, gmask = tfe.extract_features(
        torch.from_numpy(wave), torch.from_numpy(lens), tfe.build_tables(tc),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert gmask.sum(dim=1).tolist() == [
        tfe.num_frames(int(n), tc) for n in lens]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got[3] == 0).all()                       # no whole frame
    spliced = tfe.splice_frames(torch.from_numpy(want), gmask, 11).numpy()
    np.testing.assert_array_equal(spliced, np.asarray(jfe.splice_frames(
        jnp.asarray(want), wmask, 11)))


@pytest.fixture(scope="module")
def engines():
    """The reference flagship engine (nbest 2, for the margins) and the
    port engine on its tables."""
    eng, _ = flagship_engine(trained=True, **SIZE)
    eng.search_cfg = dataclasses.replace(eng.search_cfg, nbest=2)
    return eng, converted_engine(eng)


def test_recognize_batch_equals_decode_features(engines):
    _, teng = engines
    wave, lens = waves(3, LENGTHS[:3])
    got = teng.recognize_batch(wave, lens)
    feats, mask = teng._features(torch.from_numpy(wave),
                                 torch.from_numpy(lens))
    want = teng.decode_features(feats, mask.sum(dim=1).int())
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.score for r in got] == [r.score for r in want]
    assert [r.from_pass for r in got] == [2, 2, 2]


@pytest.mark.parametrize("noise", [False, True])
def test_recognize_batch_matches_reference(engines, noise):
    eng, teng = engines
    wave, lens = waves(4)
    if noise:
        spec = (150.0 * np.abs(np.random.default_rng(2).standard_normal(
            257))).astype(np.float32)
        eng.set_noise_spectrum(jnp.asarray(spec))
        teng.set_noise_spectrum(spec)
    try:
        jtr, jnfr, jout = eng._decode_jit(jnp.asarray(wave),
                                          jnp.asarray(lens))
        want = eng.recognize_batch(wave, lens)
    finally:
        eng.set_noise_spectrum(None)
    with torch.no_grad():
        ttr, tnfr, tout = teng._decode_device(torch.from_numpy(wave),
                                              torch.from_numpy(lens))
    got = teng.recognize_batch(wave, lens)
    teng.set_noise_spectrum(None)
    np.testing.assert_array_equal(tnfr.numpy(), np.asarray(jnfr))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    live = np.asarray(jtr.word) >= 0
    for name in ttr._fields:
        a, b = getattr(ttr, name).numpy(), np.asarray(getattr(jtr, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(np.where(live, a, 0),
                                       np.where(live, b, 0), atol=1e-3,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(a, b)
    assert [r.valid for r in got] == [r.valid for r in want] \
        == [True, True, True, False]
    n_margin = 0
    for g, w in zip(got[:3], want[:3]):
        assert g.from_pass == w.from_pass == 2
        assert g.score == pytest.approx(w.score, abs=1e-2)
        if len(w.nbest) < 2 or w.nbest[0].score - w.nbest[1].score > 1e-2:
            n_margin += 1
            assert g.word_ids == w.word_ids
    assert n_margin >= 2


@pytest.mark.parametrize("reject", ["speech", "other"])
def test_rejection_hooks_match_reference(engines, reject):
    """GMM verification (`gmm_frontend`) and power rejection
    (`power_thres`) on the waveform path: the unspliced features of
    each utterance go through both packages' GMM front ends, with the
    same decision and reason."""
    from julius_tpu.frontend.gmm_frontend import GMMFrontend as JGMM
    from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
    from julius_tpu_torch.frontend.gmm_frontend import GMMFrontend
    from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
    from julius_tpu_torch.tools.synth import write_class_gmm
    import tempfile

    eng, teng = engines
    wave, lens = waves(5, LENGTHS[:3])
    feats, mask = tfe.extract_features(torch.from_numpy(wave),
                                       torch.from_numpy(lens),
                                       tfe.build_tables(teng.fe_cfg))
    x = feats[mask].numpy()
    classes = {"speech": (x.mean(0), x.var(0) + 1.0),
               "other": (x.mean(0) + 50.0, np.ones(x.shape[1]))}
    with tempfile.TemporaryDirectory() as d:
        write_class_gmm(f"{d}/gmm", classes)
        text = open(f"{d}/gmm").read()
    teng.gmm_frontend = GMMFrontend(parse_hmmdefs_text(text),
                                    reject_names=[reject], device="cpu")
    eng.gmm_frontend = JGMM(jparse_hmm(text), reject_names=[reject])
    teng.power_thres = eng.power_thres = 0.5
    try:
        got = teng.recognize_batch(wave, lens)
        want = eng.recognize_batch(wave, lens)
    finally:
        teng.gmm_frontend = eng.gmm_frontend = None
        teng.power_thres = eng.power_thres = 0.0
    assert [(r.valid, r.reject_reason) for r in got] == \
        [(r.valid, r.reject_reason) for r in want]
    assert all(r.valid for r in got) == (reject == "other")
    if reject == "speech":
        assert {r.reject_reason for r in got} == {"GMM rejected (speech)"}
