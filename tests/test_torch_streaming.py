"""Port vs reference: streaming recognition (streaming.py StreamSession,
search/pass1.py `pass1_stream_chunk` / `pass1_stream_finalize`,
frontend/stream.py, adin/native_wrapper.py and io/ss.py
`estimate_noise_spectrum`).

The same inputs (numpy, from seeds) go through both packages:

* the chunked pass-1 trellis on the same outprob rows (the reference
  scorer's, small flagship tables carried across by convert.py), fed in
  blocks of 1, 8 and 16 frames as StreamSession feeds it: integers
  equal, scores within atol 1e-5 (the unfused step's tolerance,
  tests/test_torch_pass1_unfused.py), the absolute frame of each atom
  row kept across blocks;
* StreamSession on waveforms (GMM and DNN engines, no VAD, VAD with its
  callbacks, -progout) and on features (decoder-driven segmentation
  with its rewind): the same segments (`segment_ranges`), words and
  event sequence, scores within atol 1e-2 or rtol 1e-6 where larger
  (noise waveforms score near -7e4, where a float32 step is 0.008);
  the stream equal to the port's own batch decode of the same waveform;
* StreamingFrontend (plain, MAP-CMN, live energy normalisation),
  MapCMN and LiveEnergyNorm: frames within atol 1e-4 + rtol 1e-4;
* the VADs and segmenters: events and trigger bits equal; the native
  segmenter against the Python one, the decimator, the capture layer;
* the noise spectrum estimate within rtol 1e-5.
"""

import dataclasses
import io
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.config import FrontendConfig as JFrontendConfig
from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.frontend import stream as jst
from julius_tpu.io import ss as jss
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.dnn import DNNParams as JDNNParams
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.search import pass1 as jp1
from julius_tpu.streaming import StreamSession as JSession
from julius_tpu.tools.synth import flagship_engine, make_flagship_utts
from julius_tpu_torch.adin import native_wrapper as nw
from julius_tpu_torch.config import FrontendConfig, SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.frontend import mfcc as tfe
from julius_tpu_torch.frontend import stream as tst
from julius_tpu_torch.io import ss as tss
from julius_tpu_torch.io.arpa import parse_arpa
from julius_tpu_torch.io.dnn import DNNParams
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.io.wav import write_wav
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.streaming import StreamSession

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
from test_torch_pass2_device import converted_engine
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


def approx_score(a, b):
    assert a == pytest.approx(b, abs=1e-2, rel=1e-6)


# ---------------------------------------------------------------------------
# the chunked pass-1 trellis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """The small flagship (the port's engine on the reference's tables)
    and one utterance's outprob rows from the reference's DNN."""
    eng, protos = flagship_engine(trained=True, n_words=120, n_phones=48,
                                  hidden=128, n_layers=2)
    _, wins, _ = make_flagship_utts(eng.hmm, eng.voca, eng.lm, protos, 1,
                                    120, 11, min_words=3, max_words=5,
                                    seed=4)
    out_ext = np.asarray(eng._outprob_jit(jnp.asarray(wins[0])[None])[0])
    return converted_engine(eng), eng, out_ext


def stream_trellis_ref(eng, out_ext, block):
    """The reference's pass-1 chunk scan fed as StreamSession feeds it:
    [(block's atoms as numpy, n_valid)] and the finalize atoms."""
    chunk = jax.jit(partial(jp1.pass1_stream_chunk, eng.dev_net,
                            eng.ngram_dev, eng.p1_cfg))
    T = out_ext.shape[0]
    state, blocks = None, []
    for start in range(0, T, block):
        count = min(block, T - start)
        rows = np.zeros((block, out_ext.shape[1]), np.float32)
        rows[:count] = out_ext[start:start + count]
        rows = jnp.asarray(rows)
        if state is None:
            state = jp1.pass1_init(eng.dev_net, eng.p1_cfg, rows[0])
            rest, n = rows[1:], count - 1
        else:
            rest, n = rows, count
        if n > 0:
            state, atoms = chunk(state, rest, jnp.asarray(n))
            blocks.append(([np.asarray(a) for a in atoms], n))
    final = jp1.pass1_stream_finalize(eng.dev_net, eng.ngram_dev,
                                      eng.p1_cfg, state)
    return blocks, [np.asarray(a) for a in final], int(state.t)


def stream_trellis_port(eng, out_ext, block):
    T = out_ext.shape[0]
    state, blocks = None, []
    for start in range(0, T, block):
        count = min(block, T - start)
        rows = torch.zeros((block, out_ext.shape[1]))
        rows[:count] = torch.tensor(out_ext[start:start + count])
        if state is None:
            state = tp1.pass1_stream_start(eng.dev_net, eng.p1_cfg, rows[:1])
            rest, n = rows[1:], count - 1
        else:
            rest, n = rows, count
        if n > 0:
            state, atoms = tp1.pass1_stream_chunk(
                eng.dev_net, eng.ngram_dev, eng.p1_cfg, state, rest, n)
            blocks.append(([a.numpy() for a in atoms], n))
    final = tp1.pass1_stream_finalize(eng.dev_net, eng.ngram_dev,
                                      eng.p1_cfg, state)
    return blocks, [a.numpy() for a in final], int(state.t)


def assert_same_atoms(got, want):
    for f, g, w in zip(tp1.Trellis._fields, got, want):
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f)
        else:
            assert np.array_equal(g, w), f


@pytest.mark.parametrize("block", [1, 8, 16])
def test_stream_chunks_match_reference(flagship, block):
    teng, jeng, out_ext = flagship
    got, gfinal, gt = stream_trellis_port(teng, out_ext, block)
    want, wfinal, wt = stream_trellis_ref(jeng, out_ext, block)
    assert gt == wt == out_ext.shape[0] - 1
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (w, _) in zip(got, want):
        assert_same_atoms(g, w)
    assert_same_atoms(gfinal, wfinal)
    # prev ids stay absolute across blocks: every kept atom points at a
    # word end of an earlier frame
    frame = 0
    for atoms, n in got:
        for i in range(n):
            word, prev = atoms[0][i], atoms[3][i]
            M = word.shape[0]
            assert np.all(prev[word >= 0] < frame * M)
            frame += 1


def test_stream_trellis_equals_batch_trellis(flagship):
    """The streamed atoms, stacked as StreamSession stacks them, are the
    batch pass 1's trellis (the kernel path) wherever it kept a word."""
    teng, _, out_ext = flagship
    blocks, final, _ = stream_trellis_port(teng, out_ext, 8)
    rows = [[a[i] for a in atoms] for atoms, n in blocks for i in range(n)]
    rows.append(final)
    stacked = [np.stack(f) for f in zip(*rows)]
    T = out_ext.shape[0]
    batch = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                            torch.from_numpy(out_ext)[None],
                            torch.tensor([T]))
    batch = [a[0].numpy() for a in batch]
    valid = batch[0] >= 0
    assert np.array_equal(stacked[0], batch[0])
    for f, s, b in zip(tp1.Trellis._fields, stacked, batch):
        if f == "word":
            continue
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(s[valid], b[valid], rtol=0, atol=1e-4)
        else:
            assert np.array_equal(s[valid], b[valid]), f


# ---------------------------------------------------------------------------
# StreamSession
# ---------------------------------------------------------------------------

def gmm_engines(dim, fe=None, **search):
    """GMM monophone engines of both packages from the same texts."""
    texts = (make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=dim,
                               n_states=3, n_mix=2),
             make_dict_text(), make_arpa_text())
    fe = dict(cmn=False) if fe is None else fe
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
                       parse_lm(io.StringIO(texts[2])), frontend=Fe(**fe),
                       search=Search(lm_weight=2.0, **search), **kw))
    return out


def dnn_engines():
    """The reference's streaming DNN test engine in both packages."""
    rng = np.random.default_rng(0)
    din, S = 26 * 5, 9
    w = dict(weights=[(rng.standard_normal((din, 32)) * 0.1)
                      .astype(np.float32)],
             biases=[np.zeros(32, dtype=np.float32)],
             output_w=(rng.standard_normal((32, S)) * 0.1).astype(np.float32),
             output_b=np.zeros(S, dtype=np.float32),
             log_prior=np.full(S, np.log10(1.0 / S), dtype=np.float32),
             context_len=5, feature_len=26)
    dict_text = make_dict_text([("<s>", "[]", ["sil"]),
                                ("</s>", "[]", ["sil"]),
                                ("AB", "[ab]", ["a", "b"])])
    out = []
    for parse_hmm, Voca, parse_dict, parse_lm, Eng, Fe, Search, Dnn, kw in (
            (parse_hmmdefs_text, Vocabulary, parse_dict_line, parse_arpa,
             Engine, FrontendConfig, SearchConfig, DNNParams,
             dict(device="cpu")),
            (jparse_hmm, JVocabulary, jparse_dict, jparse_arpa, JEngine,
             JFrontendConfig, JSearchConfig, JDNNParams, {})):
        hmm = parse_hmm(make_hmmdefs_text(phones=("a", "b", "sil"), dim=26,
                                          n_states=3, n_mix=1))
        voca = Voca()
        for line in dict_text.splitlines():
            parse_dict(line, voca)
        out.append(Eng(hmm, voca, parse_lm(io.StringIO(make_arpa_text())),
                       dnn=Dnn(**w), frontend=Fe(cmn=False),
                       search=Search(lm_weight=2.0), **kw))
    return out


@pytest.fixture(scope="module")
def gmm26():
    return gmm_engines(26)


def run_session(Session, eng, wave, step, **kw):
    """Feed `wave` in chunks of `step` samples -> (results, session)."""
    sess = Session(eng, **kw)
    out = []
    for ofs in range(0, len(wave), step):
        out.extend(sess.feed(wave[ofs:ofs + step]))
    out.extend(sess.close())
    return out, sess


def assert_same_results(got, want):
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    assert [r.valid for r in got] == [r.valid for r in want]
    for g, w in zip(got, want):
        approx_score(g.score, w.score)


@pytest.mark.parametrize("block,step", [(8, 1000), (16, 1600), (3, 517)])
def test_session_without_vad_matches_reference(gmm26, block, step):
    teng, jeng = gmm26
    wave = (np.random.default_rng(3).standard_normal(12000) * 3000) \
        .astype(np.float32)
    got, gs = run_session(StreamSession, teng, wave, step, use_vad=False,
                          block_frames=block)
    want, ws = run_session(JSession, jeng, wave, step, use_vad=False,
                           block_frames=block)
    assert len(got) == 1
    assert_same_results(got, want)
    assert gs.segment_ranges == ws.segment_ranges


def test_session_matches_port_batch_decode(gmm26):
    """A stream with no VAD gives the words of recognize_batch on the
    same waveform."""
    teng, _ = gmm26
    wave = (np.random.default_rng(3).standard_normal(12000) * 3000) \
        .astype(np.float32)
    batch = teng.recognize_batch(wave[None], np.asarray([len(wave)]))[0]
    got, _ = run_session(StreamSession, teng, wave, 1000, use_vad=False,
                         block_frames=8)
    assert len(got) == 1
    assert got[0].words == batch.words
    assert abs(got[0].score - batch.score) < 0.5


def test_dnn_session_matches_reference_and_batch():
    """A DNN engine: the splice lag holds blocks back by half the
    context."""
    teng, jeng = dnn_engines()
    wave = (np.random.default_rng(1).standard_normal(12000) * 3000) \
        .astype(np.float32)
    got, gs = run_session(StreamSession, teng, wave, 1500, use_vad=False,
                          block_frames=8)
    want, ws = run_session(JSession, jeng, wave, 1500, use_vad=False,
                           block_frames=8)
    assert_same_results(got, want)
    assert gs.segment_ranges == ws.segment_ranges
    batch = teng.recognize_batch(wave[None], np.asarray([len(wave)]))[0]
    assert got[0].words == batch.words
    assert abs(got[0].score - batch.score) < 1.0


def tone_bursts(n=2, sr=16000, seed=0):
    """Tone bursts of 0.5 s between stretches of near-silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(sr // 2)
    parts = [rng.standard_normal(sr // 2) * 30]
    for k in range(n):
        parts.append(6000 * np.sin(2 * np.pi * (300 + 150 * k) * t / sr)
                     + rng.standard_normal(len(t)) * 300)
        parts.append(rng.standard_normal(sr // 2 + sr // 4) * 30)
    return np.concatenate(parts).astype(np.float32)


EVENTS = ("event_speech_start", "event_speech_stop", "event_pass2_begin",
          "result_pass1", "result_pass1_interim", "result")


def record_events(eng):
    log = []
    ids = [eng.callbacks.add(name, lambda *a, _n=name: log.append(
        (_n, [r.word_ids for r in a[:1]]))) for name in EVENTS]
    return log, ids


@pytest.mark.parametrize("progout", [False, True])
def test_session_with_vad_matches_reference(gmm26, progout):
    """VAD-segmented decoding with every callback (speech start/stop,
    pass 2 begin, the pass-1 result, -progout interim results, the
    result): the same events in the same order, the same words."""
    teng, jeng = gmm26
    wave = tone_bursts()
    vad = dict(level=1000, zc_thres=30, head_margin_ms=50,
               tail_margin_ms=100, sample_rate=16000)
    logs = []
    for Session, eng, Vad in ((StreamSession, teng, tst.VADConfig),
                              (JSession, jeng, jst.VADConfig)):
        log, ids = record_events(eng)
        try:
            res, _ = run_session(Session, eng, wave, 1600, vad=Vad(**vad),
                                 progout=progout, prog_frames=10)
        finally:
            for i in ids:
                eng.callbacks.delete(i)
        logs.append((log, res))
    (glog, got), (wlog, want) = logs
    assert len(got) == 2
    assert_same_results(got, want)
    assert [e[0] for e in glog] == [e[0] for e in wlog]
    assert glog == wlog
    assert any(e[0] == "result_pass1_interim" for e in glog) == progout


@pytest.fixture(scope="module")
def sp_setup():
    """Features of two sentences with a long silence between them, for
    decoder-driven segmentation (the reference's spsegment tests)."""
    teng, jeng = gmm_engines(4)
    rng = np.random.default_rng(7)

    def frames_of(words, min_frames=0):
        pids = [jeng.hmm.phone_index[p] for w in words
                for p in jeng.voca.phones[jeng.voca.names.index(w)]]
        out, _ = sample_states_and_frames(jeng.hmm, pids, rng)
        while out.shape[0] < min_frames:
            more, _ = sample_states_and_frames(jeng.hmm, pids, rng)
            out = np.concatenate([out, more])
        return out

    frames = np.concatenate([
        frames_of(["<s>", "ABC", "</s>"]),
        frames_of(["<s>"] * 6, min_frames=40),
        frames_of(["<s>", "CA", "</s>"])]).astype(np.float32)
    return teng, jeng, frames


def sp_run(Session, eng, frames, sp_frames=12):
    sess = Session(eng, use_vad=False, block_frames=8, spsegment=True,
                   sp_frames=sp_frames)
    results = []
    for ofs in range(0, frames.shape[0], 8):
        sess._feed_frames(frames[ofs: ofs + 8])
        r = sess._check_sp_segment()
        if r is not None:
            results.append(r)
    results.extend(sess.close())
    return results, sess


def test_spsegment_matches_reference(sp_setup):
    teng, jeng, frames = sp_setup
    got, gs = sp_run(StreamSession, teng, frames)
    want, ws = sp_run(JSession, jeng, frames)
    assert len(got) >= 2
    assert gs.segment_ranges == ws.segment_ranges
    assert_same_results(got, want)


def test_spsegment_rewind_matches_buffered(sp_setup):
    """Decoder-VAD rewind parity (reference spsegment.c:770-912): the
    streaming spsegment decode re-decodes from the silence-run onset,
    so each segment's transcript must equal the buffered decode of the
    exact same absolute frame range (the reference's own test, on the
    port)."""
    teng, _, frames = sp_setup
    results, sess = sp_run(StreamSession, teng, frames)
    assert len(results) >= 2
    assert len(sess.segment_ranges) == len(results)
    (a0, a1), (b0, b1) = sess.segment_ranges[0], sess.segment_ranges[1]
    assert b0 < a1, "no rewind: segment 2 started after segment 1 end"
    for r, (f0, f1) in zip(results, sess.segment_ranges):
        buf = teng.decode_features(frames[f0:f1][None], [f1 - f0])[0]
        # the reference's allowance: two near-tied segmentations over
        # trailing silence may trade places
        assert r.words == buf.words or abs(r.score - buf.score) < 1.0, \
            (r.words, r.score, buf.words, buf.score)
    flat = [w for r in results for w in r.words]
    assert "ABC" in flat and "CA" in flat


# ---------------------------------------------------------------------------
# the streaming front end
# ---------------------------------------------------------------------------

FE_CASES = {
    "plain": dict(cmn=False, use_delta=True, use_accel=True),
    "map_cmn": dict(cmn=True, cmn_map_weight=50.0),
    "enormal": dict(cmn=False, energy_normalize=True, escale=0.5),
    "cmn_cvn": dict(cmn=True, cvn=True),
}


@pytest.mark.parametrize("case", sorted(FE_CASES))
def test_streaming_frontend_matches_reference(case):
    kw = FE_CASES[case]
    tcfg, jcfg = FrontendConfig(**kw), JFrontendConfig(**kw)
    rng = np.random.default_rng(0)
    tf = tst.StreamingFrontend(tcfg, device="cpu")
    jf = jst.StreamingFrontend(jcfg)
    for seg in range(2):           # the second segment sees the priors
        wave = (rng.standard_normal(9000 + 700 * seg) * 2000) \
            .astype(np.float32)
        if seg:
            tf.reset()
            jf.reset()
        got, want = [], []
        for ofs in range(0, len(wave), 1300):
            got.append(tf.process(wave[ofs: ofs + 1300]))
            want.append(jf.process(wave[ofs: ofs + 1300]))
        got.append(tf.finalize())
        want.append(jf.finalize())
        assert [g.shape for g in got] == [w.shape for w in want]
        np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                                   rtol=1e-4, atol=1e-4)
    assert tf.lag == jf.lag


def test_streaming_frontend_matches_port_batch_front_end():
    """With CMN off the chunked features are the whole-utterance front
    end's (same windows, deltas with edge replication)."""
    cfg = FrontendConfig(cmn=False, use_delta=True, use_accel=True)
    wave = (np.random.default_rng(0).standard_normal(16000) * 1000) \
        .astype(np.float32)
    tables = tfe.build_tables(cfg)
    batch, mask = tfe.extract_features(torch.from_numpy(wave[None]),
                                       torch.tensor([len(wave)]), tables)
    want = batch[0][:int(mask.sum())].numpy()
    sf = tst.StreamingFrontend(cfg, tables, device="cpu")
    got = [sf.process(wave[ofs: ofs + 1600])
           for ofs in range(0, len(wave), 1600)] + [sf.finalize()]
    np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-4,
                               atol=1e-4)


def test_map_cmn_and_files_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((50, 10)).astype(np.float32) + 3.0
    t = tst.MapCMN(veclen=10, static_dim=8, weight=100.0, do_var=True)
    j = jst.MapCMN(veclen=10, static_dim=8, weight=100.0, do_var=True)
    for cmn in (t, j):
        cmn.load(np.zeros(10), np.full(10, 2.0))
    for k in range(3):
        part = frames[k * 10:(k + 1) * 17]
        np.testing.assert_allclose(t.process(part), j.process(part),
                                   rtol=1e-4, atol=1e-4)
        t.update()
        j.update()
        np.testing.assert_allclose(t.prior, j.prior, rtol=1e-12)
    t.save_file(str(tmp_path / "t.cmn"))
    j.save_file(str(tmp_path / "j.cmn"))
    assert (tmp_path / "t.cmn").read_text() == (tmp_path / "j.cmn").read_text()
    for path in ("t.cmn", "j.cmn"):
        tm, tv = tst.load_cmn_file(str(tmp_path / path))
        jm, jv = jst.load_cmn_file(str(tmp_path / path))
        assert np.array_equal(tm, jm) and np.array_equal(tv, jv)
    # the old binary format: int32 veclen + f32 means
    raw = tmp_path / "old.cmn"
    raw.write_bytes(np.asarray([4], "<i4").tobytes()
                    + np.arange(4, dtype="<f4").tobytes())
    tm, tv = tst.load_cmn_file(str(raw))
    assert np.array_equal(tm, jst.load_cmn_file(str(raw))[0]) and tv is None
    fresh = tst.MapCMN(veclen=10, static_dim=10)
    with pytest.raises(ValueError, match="no CMN statistics"):
        fresh.save_file(str(tmp_path / "none.cmn"))


def test_live_energy_norm_matches_reference():
    """-enormal on live input: each segment is normalised by the
    previous segment's max energy (reference wav2mfcc-pipe.c:711)."""
    tcfg = FrontendConfig(cmn=False, energy_normalize=True, escale=0.5)
    jcfg = JFrontendConfig(cmn=False, energy_normalize=True, escale=0.5)
    t, j = tst.LiveEnergyNorm(tcfg), jst.LiveEnergyNorm(jcfg)
    rng = np.random.default_rng(2)
    for seg in range(3):
        t.prepare()
        j.prepare()
        e = rng.normal(8.0 + seg, 2.0, 40).astype(np.float32)
        np.testing.assert_allclose(t.normalize(e), j.normalize(e),
                                   rtol=1e-4, atol=1e-4)
        assert t.max == j.max
    first = tst.LiveEnergyNorm(tcfg)
    first.prepare()
    min_last = 5.0 - (tcfg.silfloor_db * math.log(10.0)) / 10.0
    assert first.min_last == pytest.approx(min_last)


# ---------------------------------------------------------------------------
# VADs, segmenters, the native layer, capture
# ---------------------------------------------------------------------------

def tone_stream():
    t = np.arange(16000)
    tone = (8000 * np.sin(2 * np.pi * 300 * t / 16000)).astype(np.float32)
    quiet = np.zeros(8000, dtype=np.float32)
    return [quiet, tone[:8000], tone[8000:], quiet, quiet]


def noisy_tone(sr=16000, seed=5):
    """Loud stationary noise + a speech-band tone burst in the middle:
    the level/zero-cross trigger fires on the noise alone, the sub-band
    SNR gate segments the burst."""
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(sr * 3) * 3000).astype(np.float32)
    tt = np.arange(sr) / sr
    sig[sr:2 * sr] += (4000 * np.sin(2 * np.pi * 400 * tt)
                       + 3000 * np.sin(2 * np.pi * 800 * tt)
                       + 2000 * np.sin(2 * np.pi * 1500 * tt))
    return sig


def events_of(det, chunks):
    out = []
    for c in chunks:
        out.extend(det.feed(c))
    return [(e["type"], None if e["type"] != "samples"
             else e["data"].tolist()) for e in out]


def summary(events):
    """Event kinds in order, with the sample count of each segment."""
    out, n = [], 0
    for kind, data in events:
        if kind == "samples":
            n += len(data)
        else:
            if kind == "end":
                out.append(("samples", n))
                n = 0
            out.append((kind, None))
    return out + ([("samples", n)] if n else [])


VAD_CASES = {
    "zero_cross": dict(level=1000, zc_thres=30, head_margin_ms=50,
                       tail_margin_ms=100, sample_rate=16000),
    "defaults": dict(sample_rate=16000),
}


@pytest.mark.parametrize("case", sorted(VAD_CASES))
def test_speech_detector_matches_reference(case):
    kw = VAD_CASES[case]
    zt, zj = tst.ZeroCrossVAD(tst.VADConfig(**kw)), \
        jst.ZeroCrossVAD(jst.VADConfig(**kw))
    for c in tone_stream():
        assert np.array_equal(zt.feed(c), zj.feed(c))
    got = events_of(tst.SpeechDetector(tst.VADConfig(**kw)), tone_stream())
    want = events_of(jst.SpeechDetector(jst.VADConfig(**kw)), tone_stream())
    assert got == want


def test_subband_vad_matches_reference():
    sig = noisy_tone()[:16000 * 2]
    t = tst.SubbandVAD(2, 16000, 5, 0.0)
    j = jst.SubbandVAD(2, 16000, 5, 0.0)
    for ofs in range(0, len(sig), 4000):
        assert np.array_equal(t.feed(sig[ofs:ofs + 4000]),
                              j.feed(sig[ofs:ofs + 4000]))
    kw = dict(level=2000, zc_thres=60, head_margin_ms=100,
              tail_margin_ms=200, sample_rate=16000, fvad_mode=2)
    chunks = [sig[i:i + 1600] for i in range(0, len(sig), 1600)]
    assert events_of(tst.SpeechDetector(tst.VADConfig(**kw)), chunks) == \
        events_of(jst.SpeechDetector(jst.VADConfig(**kw)), chunks)


def test_vad_config_from_matches_reference():
    from julius_tpu.jconf import parse_jconf as jparse
    from julius_tpu_torch.jconf import parse_jconf as tparse
    argv = ["-lv", "1500", "-zc", "40", "-headmargin", "200",
            "-tailmargin", "500", "-fvad", "1", "-fvad_param", "7", "0.5"]
    got = tst.vad_config_from(tparse(argv), 16000)
    want = jst.vad_config_from(jparse(argv), 16000)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


native = pytest.mark.skipif(not nw.native_available(),
                            reason="no C++ compiler")


@native
@pytest.mark.parametrize("case", sorted(VAD_CASES))
def test_native_segmenter_matches_python(case):
    """The C++ segmenter gives the Python segmenter's events on the same
    samples: the same starts and ends, segment lengths within 2
    samples (the reference's own tolerance)."""
    kw = VAD_CASES[case]
    nat = summary(events_of(nw.NativeSpeechDetector(tst.VADConfig(**kw)),
                            tone_stream()))
    py = summary(events_of(tst.SpeechDetector(tst.VADConfig(**kw)),
                           tone_stream()))
    assert [k for k, _ in nat] == [k for k, _ in py]
    for (k, a), (_, b) in zip(nat, py):
        if k == "samples":
            assert abs(a - b) <= 2
    assert nw.library_path().exists()
    assert nw.library_path().parent.name == "_build"


@native
def test_native_fvad_gate_segments_noisy_audio():
    """A case the zero-cross trigger fails (loud stationary noise) that
    the sub-band SNR gate handles, natively and in Python alike."""
    sig = noisy_tone()
    chunks = [sig[i:i + 1600] for i in range(0, len(sig), 1600)]
    base = dict(level=2000, zc_thres=60, head_margin_ms=100,
                tail_margin_ms=200, sample_rate=16000)
    zc = summary(events_of(nw.NativeSpeechDetector(tst.VADConfig(**base)),
                           chunks))
    assert [k for k, _ in zc] == ["start", "samples"]
    for det in (nw.NativeSpeechDetector(tst.VADConfig(fvad_mode=2, **base)),
                tst.SpeechDetector(tst.VADConfig(fvad_mode=2, **base))):
        segs = summary(events_of(det, chunks))
        assert [k for k, _ in segs] == ["start", "samples", "end"]
        assert 16000 * 0.8 < segs[1][1] < 16000 * 1.8


@native
def test_native_decimator_and_capture(tmp_path):
    dec = nw.NativeDecimator(factor=3)
    t = np.arange(48000)
    out = dec.feed(np.sin(2 * np.pi * 1000 * t / 48000).astype(np.float32))
    assert abs(len(out) - 16000) <= 2
    assert 0.9 < np.max(np.abs(out[2000:14000])) < 1.1
    out2 = nw.NativeDecimator(factor=3).feed(
        np.sin(2 * np.pi * 20000 * t / 48000).astype(np.float32))
    assert np.max(np.abs(out2[2000:14000])) < 0.05
    for backend in ("alsa", "pulseaudio", "oss", "auto"):
        with pytest.raises(RuntimeError, match="capture|:"):
            nw.NativeCapture(backend)


def test_fake_capture_replays_a_file(tmp_path):
    rng = np.random.default_rng(0)
    audio = np.concatenate([rng.standard_normal(8000) * 50,
                            np.sin(np.arange(16000) * 0.17) * 12000]) \
        .astype(np.float32)
    path = str(tmp_path / "t.wav")
    write_wav(path, audio, 16000)
    cap = nw.make_capture(f"fake:{path}")
    chunks = []
    while (c := cap.read(4000)) is not None:
        chunks.append(c)
    cap.close()
    assert max(len(c) for c in chunks) == 4000
    assert np.allclose(np.concatenate(chunks), np.round(audio), atol=1.0)
    det = nw.make_speech_detector(tst.VADConfig(sample_rate=16000))
    assert isinstance(det, nw.NativeSpeechDetector) == nw.native_available()


def test_estimate_noise_spectrum_matches_reference():
    cfg, jcfg = FrontendConfig(), JFrontendConfig()
    wave = (np.random.default_rng(4).standard_normal(8000) * 200) \
        .astype(np.float32)
    got = tss.estimate_noise_spectrum(wave, cfg)
    want = jss.estimate_noise_spectrum(wave, jcfg)
    assert got.shape == want.shape == (cfg.fft_size // 2 + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
