"""The device A*'s suffix estimate on the card (ops/suffix_kernel.py,
csrc/suffix.cu).

  * the kernel's plain version, which follows the kernel's push order
    (each trellis row, from the last frame back, pushing its atoms into
    the frames it can follow), is bit-equal to search/pass2_device.py
    `_suffix_estimate_np` (numpy's pull loop) on random trellises: M of
    32 and 128, lookup ranges 0, 5 and 12, no frame maxima, DNN-like and
    GMM-like ones, 1, 2 and 1560 frames, rows of fewer frames than the
    trellis and of none, empty slots and empty rows, atoms that begin at
    frame 0 and windows that run past the utterance;
  * on CPU tensors `prepare` and `run_batch` take the numpy path (no
    launch, `suffix_host` counts the utterances) and `prepare` gives the
    same tables as without the card's arguments;
  * on a card (skipped without one): the kernel bit-equal to numpy on
    the small flagship's decoded batches and on random trellises, with
    its frame arrays in shared memory and in the global scratch; the
    decode counting every utterance under `suffix_card`; `prepare` equal
    to its CPU path with the device trellis and with the lattices
    uploaded.

The card's cases import neither JAX nor the reference package:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_suffix.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.ops import suffix_kernel as tsx
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.tools import synth

from torch_fixtures import LOG_ZERO

SMALL = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


def random_trellis(seed, T, M, lens):
    """A [B, T, M] trellis whose row b holds lens[b] decodable frames:
    words of 1-60 frames (some from frame 0), prev pointing at an atom of
    the frame before the begin, 30% empty slots and 10% empty rows (never
    the last); the frames past lens[b] hold junk no estimate may read."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    word = rng.integers(0, 500, (B, T, M)).astype(np.int32)
    word[rng.random((B, T, M)) < 0.3] = -1
    word[:, rng.random(T) < 0.1] = -1
    t = np.arange(T)[None, :, None]
    begin = np.maximum(t - rng.integers(0, 60, (B, T, M)), 0)
    begin[rng.random((B, T, M)) < 0.05] = 0
    prev = np.where(begin > 0,
                    (begin - 1) * M + rng.integers(0, M, (B, T, M)), -1)
    score = (-40 * rng.random((B, T, M)) - 3.0 * t).astype(np.float32)
    lm = (-8 * rng.random((B, T, M))).astype(np.float32)
    for b, n in enumerate(lens):
        if n:                              # the utterance's last words
            word[b, n - 1, :M // 2] = rng.integers(0, 500, M // 2)
        begin[b, n:] = rng.integers(-5, 2 * T + 5, begin[b, n:].shape)
        score[b, n:] = LOG_ZERO            # junk past the row's end
    return tp1.Trellis(*[torch.from_numpy(np.ascontiguousarray(a, dt))
                         for a, dt in ((word, np.int32),
                                       (score, np.float32),
                                       (lm, np.float32),
                                       (prev, np.int32),
                                       (begin, np.int32),
                                       (word, np.int32))])


def frame_maxima(kind, seed, B, T):
    """[B, T] f32 frame maxima: None, DNN-like (mostly positive) or
    GMM-like (negative)."""
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "dnn":
        x = rng.normal(3.0, 2.0, (B, T))
    else:
        x = -5.0 - 30.0 * rng.random((B, T))
    return torch.from_numpy(x.astype(np.float32))


def search_cfg(lr):
    """A search configuration of lookup range lr whose passes weigh the
    LM differently (a ratio that is not 1)."""
    return dataclasses.replace(SearchConfig(), lookup_range=lr,
                               lm_weight=8.0, lm_weight2=6.5)


def assert_same_as_numpy(got, tr, lens, fmax, cfg):
    """Each row of `got` ([B, T] f64) bit-equal to `suffix_host` on the
    row's lattice, -inf past its frames."""
    got = got.cpu().numpy()
    for b, n in enumerate(lens):
        assert (got[b, n:] == -np.inf).all()
        if n == 0:
            continue
        lat = tp2.TrellisLattice(tp1.Trellis(*[a[b].cpu().numpy()
                                               for a in tr]), n)
        fm = None if fmax is None else fmax[b, :n].cpu().numpy()
        np.testing.assert_array_equal(got[b, :n], tp2d.suffix_host(lat, cfg,
                                                                   fm))


@pytest.mark.parametrize("T", [1, 2, 1560])
@pytest.mark.parametrize("fmax", [None, "dnn", "gmm"])
@pytest.mark.parametrize("lr", [0, 5, 12])
@pytest.mark.parametrize("M", [32, 128])
def test_plain_push_order_equals_numpy(M, lr, fmax, T):
    lens = [T, (T + 1) // 2, 0]
    tr = random_trellis(M + lr + T, T, M, lens)
    fm = frame_maxima(fmax, T + lr, len(lens), T)
    cfg = search_cfg(lr)
    before = tsx.LAUNCHES
    got = tsx.suffix(tr, lens, fm, lr, tp2d._lm_ratio(cfg))
    assert tsx.LAUNCHES == before                 # the CPU's plain path
    assert got.dtype == torch.float64 and got.shape == (len(lens), T)
    assert_same_as_numpy(got, tr, lens, fm, cfg)
    # most frames have a continuation: the maxima were taken
    assert np.isfinite(got[0].numpy()).mean() > (0.9 if T > 2 else 0.4)


@pytest.fixture(scope="module")
def cpu_decode():
    eng, protos = synth.flagship_engine(trained=True, device="cpu", **SMALL)
    _, wins, lens = synth.make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11, min_words=2,
        max_words=5, seed=1)
    feats = np.zeros((3, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, feats, np.asarray(lens, np.int32)


def decoded_batch(eng, feats, lens):
    """The engine's outprob cache, its pass-1 trellis on its device and
    the lattices the A* reads."""
    with torch.no_grad():
        out = eng._outprob(torch.as_tensor(feats, device=eng.device))
        tr = eng._pass1(out, lens)
    host = tp1.Trellis(*[a.cpu().numpy() for a in tr])
    lats = [tp2.TrellisLattice(tp1.Trellis(*[a[b] for a in host]), int(n))
            for b, n in enumerate(lens)]
    return out, tr, lats


def prepare_args(eng, lats, out):
    S = max(64, 4 * int(eng.search_cfg.stack_size))
    best_in = tp2d._best_lm_in(eng._rescan_strategy(),
                               eng.device_chains.loc.shape[0])
    return (lats, out.shape[1], eng._rescan_strategy(), eng.search_cfg, S,
            eng._cprob_arr(), best_in)


def assert_same_prepared(got, want):
    for f in ("ab", "ae", "aw", "ainc", "rest", "last", "packed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for a, b in zip(got.stack0, want.stack0):
        np.testing.assert_array_equal(a, b)


def test_prepare_and_run_batch_on_cpu_take_numpy(cpu_decode):
    eng, feats, lens = cpu_decode
    out, tr, lats = decoded_batch(eng, feats, lens)
    fmax_dev = out.amax(dim=2)
    fmax = fmax_dev.numpy()
    args = prepare_args(eng, lats, out)
    before = tsx.LAUNCHES
    got = tp2d.prepare(*args, fmax=fmax, trellis=tr, fmax_dev=fmax_dev)
    assert (got.suffix_card, got.suffix_host) == (0, len(lats))
    assert_same_prepared(got, tp2d.prepare(*args, fmax=fmax))
    eng.decode_features(feats, lens)
    assert tsx.LAUNCHES == before
    assert (tp2d.LAST_STATS["suffix_card"],
            tp2d.LAST_STATS["suffix_host"]) == (0, len(lats))


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_decode():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, protos = synth.flagship_engine(trained=True, device="cuda", **SMALL)
    _, wins, lens = synth.make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 4, 120, 11, min_words=2,
        max_words=8, seed=3)
    feats = np.zeros((4, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, feats, np.asarray(lens, np.int32)


@pytest.mark.cuda
def test_kernel_equals_numpy_on_decoded_batches(card_decode):
    eng, feats, lens = card_decode
    cfg = eng.search_cfg
    for B in (len(lens), 1):
        out, tr, lats = decoded_batch(eng, feats[:B], lens[:B])
        before = tsx.LAUNCHES
        got = tsx.suffix(tr, lens[:B], out.amax(dim=2).contiguous(),
                         cfg.lookup_range, tp2d._lm_ratio(cfg))
        torch.cuda.synchronize()
        assert tsx.LAUNCHES == before + 1
        assert_same_as_numpy(got, tr, lens[:B], out.amax(dim=2), cfg)
        # the decode: one launch, every utterance's estimate from the card
        before = tsx.LAUNCHES
        eng.decode_features(feats[:B], lens[:B])
        assert tsx.LAUNCHES == before + 1
        assert (tp2d.LAST_STATS["suffix_card"],
                tp2d.LAST_STATS["suffix_host"]) == (B, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("in_shared", [True, False])
@pytest.mark.parametrize("M,lr,fmax", [(32, 5, "dnn"), (32, 0, None),
                                       (128, 12, "gmm"), (64, 5, "dnn")])
def test_kernel_equals_plain_on_random_trellises(cuda, monkeypatch, M, lr,
                                                 fmax, in_shared):
    if not in_shared:
        monkeypatch.setattr(tsx, "SMEM_MAX", 0)   # the global scratch
    T = 1560
    lens = [T, 777, 0, 1, 2]
    tr = random_trellis(M + lr, T, M, lens)
    fm = frame_maxima(fmax, lr, len(lens), T)
    ratio = tp2d._lm_ratio(search_cfg(lr))
    got = tsx.suffix(tp1.Trellis(*[a.to(cuda) for a in tr]), lens,
                     None if fm is None else fm.to(cuda), lr, ratio)
    want = tsx.suffix_plain(tr, lens, fm, lr, ratio)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_prepare_on_card_equals_cpu_path(card_decode):
    eng, feats, lens = card_decode
    out, tr, lats = decoded_batch(eng, feats, lens)
    fmax_dev = out.amax(dim=2)
    fmax = fmax_dev.cpu().numpy()
    args = prepare_args(eng, lats, out)
    want = tp2d.prepare(*args, fmax=fmax)
    for trellis in (tr, None):           # the device trellis, an upload
        got = tp2d.prepare(*args, fmax=fmax, trellis=trellis,
                           fmax_dev=fmax_dev)
        assert (got.suffix_card, got.suffix_host) == (len(lats), 0)
        assert_same_prepared(got, want)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda):
    tr = tp1.Trellis(*[a.to(cuda) for a in random_trellis(0, 8, 4, [8])])
    with pytest.raises(ValueError, match="n_frames"):
        tsx.suffix(tr, [9], None, 1, 1.0)
    with pytest.raises(TypeError, match="score"):
        tsx.suffix(tr._replace(score=tr.score.double()), [8], None, 1, 1.0)
    with pytest.raises(ValueError, match="fmax"):
        tsx.suffix(tr, [8], torch.zeros(1, 7, device=cuda), 1, 1.0)
