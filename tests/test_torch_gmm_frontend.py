"""Port vs reference: GMM input verification, GMM-VAD and power
rejection (frontend/gmm_frontend.py and their wiring through
`fusion.create_engines` and the engine).

The same model files and frames (numpy, from seeds) go through both
packages:

* `GMMFrontend.verify`: the same best model and decision, accumulated
  scores within atol 1e-2 (sums of tens of frame scores, each within
  1e-4 as the GMM scorer's, tests/test_torch_gmm.py);
* `frame_margins` within atol 1e-4, `vad_decisions` and `power_reject`
  equal;
* `-gmm` / `-gmmreject` and `-powerthres` from jconf options: the same
  rejected and accepted utterances through `Engine.decode_features`,
  the GMM-VAD gate of `StreamSession` the same segments and words
  (scores within atol 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from julius_tpu.frontend import gmm_frontend as jgf
from julius_tpu.fusion import create_engines as jcreate
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.jconf import parse_jconf as jparse
from julius_tpu.streaming import StreamSession as JSession
from julius_tpu_torch.frontend import gmm_frontend as tgf
from julius_tpu_torch.fusion import create_engines as tcreate
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text as tparse_hmm
from julius_tpu_torch.jconf import parse_jconf as tparse
from julius_tpu_torch.streaming import StreamSession as TSession
from julius_tpu_torch.tools.synth import write_class_gmm

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

DIM = 4
CLASSES = {"voice": (np.zeros(DIM), np.ones(DIM)),
           "noise": (np.full(DIM, 8.0), np.ones(DIM)),
           "hum": (np.full(DIM, -6.0), np.full(DIM, 2.0))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmmfront")
    (d / "hmmdefs").write_text(make_hmmdefs_text(dim=DIM))
    (d / "words.dict").write_text(make_dict_text())
    (d / "lm.arpa").write_text(make_arpa_text())
    write_class_gmm(str(d / "gmmdefs"), CLASSES)
    rng = np.random.default_rng(0)
    hmm = jparse_hmm(make_hmmdefs_text(dim=DIM))
    pids = [hmm.phone_index[p] for p in ("sil", "a", "b", "sil")]
    voice, _ = sample_states_and_frames(hmm, pids, rng)
    noise = (8.0 + rng.standard_normal((60, DIM))).astype(np.float32)
    hum = (-6.0 + rng.standard_normal((30, DIM))).astype(np.float32)
    return d, voice.astype(np.float32), noise, hum


def frontends(d, **kw):
    text = (d / "gmmdefs").read_text()
    return (tgf.GMMFrontend(tparse_hmm(text), device="cpu", **kw),
            jgf.GMMFrontend(jparse_hmm(text), **kw))


@pytest.mark.parametrize("which", ["voice", "noise", "hum", "mixed"])
def test_verify_and_margins_match_reference(setup, which):
    d, voice, noise, hum = setup
    x = {"voice": voice, "noise": noise, "hum": hum,
         "mixed": np.concatenate([noise[:20], voice, hum])}[which]
    tf, jf = frontends(d, reject_names=["noise"],
                       vad_noise_names=["noise", "hum"])
    for n in (None, 25):
        g, w = tf.verify(x, n), jf.verify(jnp.asarray(x), n)
        assert (g.best_name, g.accepted) == (w.best_name, w.accepted)
        assert g.scores.keys() == w.scores.keys()
        for k in g.scores:
            assert g.scores[k] == pytest.approx(w.scores[k], abs=1e-2)
    np.testing.assert_allclose(tf.frame_margins(x), jf.frame_margins(x),
                               rtol=0, atol=1e-4)
    for window in (1, 5):
        assert np.array_equal(tf.vad_decisions(x, window),
                              jf.vad_decisions(x, window))
    assert tf.verify(voice).accepted and not tf.verify(noise).accepted


def test_margins_without_noise_models_are_zero(setup):
    d, voice, _, _ = setup
    tf, jf = frontends(d)
    assert np.array_equal(tf.frame_margins(voice), jf.frame_margins(voice))
    assert not tf.frame_margins(voice).any()
    assert tf.vad_decisions(voice[:0]).shape == (0,)


@pytest.mark.parametrize("thres", [-1.0, 0.5, 100.0])
def test_power_reject_matches_reference(setup, thres):
    _, voice, noise, _ = setup
    for x in (voice, noise, voice[:0]):
        for idx in (0, DIM - 1):
            assert tgf.power_reject(x, idx, thres) == \
                jgf.power_reject(x, idx, thres)


def engines(d, extra):
    argv = ["-h", str(d / "hmmdefs"), "-v", str(d / "words.dict"),
            "-nlr", str(d / "lm.arpa"), *extra, "-lmp", "2.0", "-0.0"]
    return (tcreate(tparse(argv), device="cpu")[0],
            jcreate(jparse(argv))[0])


@pytest.mark.parametrize("extra", [
    ["-gmm", "{d}/gmmdefs", "-gmmreject", "noise"],
    ["-gmm", "{d}/gmmdefs", "-gmmreject", "noise,hum"],
    ["-powerthres", "1.0"],
    ["-powerthres", "100.0"],
], ids=["gmm_noise", "gmm_noise_hum", "power_1", "power_100"])
def test_rejection_from_jconf_matches_reference(setup, extra):
    d, voice, noise, hum = setup
    teng, jeng = engines(d, [a.format(d=d) for a in extra])
    if "-gmm" in extra:
        assert isinstance(teng.gmm_frontend, tgf.GMMFrontend)
        assert teng.gmm_frontend.reject == jeng.gmm_frontend.reject
    else:
        assert teng.power_thres == jeng.power_thres > 0
    parts = (noise, voice, hum)
    T = max(p.shape[0] for p in parts)
    batch = np.zeros((3, T, DIM), np.float32)
    for b, p in enumerate(parts):
        batch[b, :p.shape[0]] = p
    lens = np.asarray([p.shape[0] for p in parts], np.int32)
    got = teng.decode_features(batch, lens)
    want = jeng.decode_features(jnp.asarray(batch), jnp.asarray(lens))
    assert [(r.valid, r.reject_reason) for r in got] == \
        [(r.valid, r.reject_reason) for r in want]
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)
    if "-gmm" in extra:
        assert not got[0].valid and "GMM rejected" in got[0].reject_reason
        assert got[1].valid
    if extra == ["-powerthres", "100.0"]:
        assert [r.reject_reason for r in got] == ["low power"] * 3


def test_gmm_vad_stream_matches_reference(setup):
    """-gmmmargin/-gmmup/-gmmdown + noise names gate a feature stream:
    the same segments, words and scores in both packages."""
    d, voice, noise, _ = setup
    extra = ["-gmm", str(d / "gmmdefs"), "-gmmnoise", "noise", "-gmmup",
             "2.0", "-gmmdown", "-2.0", "-gmmmargin", "5"]
    teng, jeng = engines(d, extra)
    stream = np.concatenate([noise[:40], voice, noise[:40], voice,
                             noise[:30]]).astype(np.float32)
    out = {}
    for key, eng, Session in (("torch", teng, TSession),
                              ("jax", jeng, JSession)):
        sess = Session(eng, use_vad=False, block_frames=8, gmm_vad=True,
                       gmm_margin=5)
        res = []
        for ofs in range(0, stream.shape[0], 8):
            res.extend(sess._feed_gmm_vad(stream[ofs:ofs + 8]))
        res.extend(sess.close())
        out[key] = res, sess.segment_ranges
    (got, granges), (want, wranges) = out["torch"], out["jax"]
    assert len(got) >= 2 and granges == wranges
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)
    assert all(r.valid and r.words for r in got)
