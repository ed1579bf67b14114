"""Port vs reference: the GMM acoustic scorer (ops/gmm.py, ops/gms.py)
and GMM-HMM decodes.

The same HMM sets and frames (numpy, from seeds) go through both
packages:

* the scorer's tables: equal, built by either package or carried across
  by convert.py;
* `gauss_scores`, `senone_scores` (all components, and the `gprune`
  top-k mask), over a model with a padded mixture and a state whose
  weights are all LOG_ZERO: within atol 1e-4 of the reference's (one
  float32 product of [x, x*x] by [a; -half_iv] where the reference
  takes two, summed in another order than XLA's; the largest difference
  measured on the CPU is 1.5e-5 on Gaussian scores of magnitude 90),
  no NaN, and the row-chunked gather equal to the whole one;
* the engine's outprob rows of a tied-triphone network (the pseudo
  set-states' columns after the senones'), for each iwcd1 scheme, and
  Gaussian mixture selection (`gms_senone_scores`), within the same
  atol;
* whole decodes from features through `Engine.decode_features` (GMM;
  with gprune, with -gshmm selection, with triphone pseudo sets): word
  ids and `from_pass` equal, scores within atol 0.05 (sums of a few
  hundred GMM scores of magnitude 40).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.config import AMConfig as JAMConfig
from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io.htk_hmm import parse_hmmdefs_text
from julius_tpu.ops import gmm as jgmm
from julius_tpu.ops import gms as jgms
from julius_tpu.search.network import build_network
from julius_tpu.tools import synth as jsynth
from julius_tpu_torch import convert
from julius_tpu_torch.config import AMConfig, SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.ops import gmm as tgmm
from julius_tpu_torch.ops import gms as tgms
from julius_tpu_torch.tools.synth import first_component_hmmset
from julius_tpu_torch.utils.logadd import LOG_ZERO

from fixtures import make_hmmdefs_text
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

ATOL = 1e-4
DIM = 8


def edge_hmmset():
    """3-mixture monophones with a padded mixture (state 1 has one
    component) and a state whose weights are all LOG_ZERO (state 0)."""
    hmm = parse_hmmdefs_text(make_hmmdefs_text(
        phones=("a", "b", "c", "sil"), dim=DIM, n_states=3, n_mix=3))
    mix, lw = hmm.state_mix.copy(), hmm.state_lw.copy()
    lw[0] = LOG_ZERO
    mix[1, 1:] = -1
    lw[1, 1:] = LOG_ZERO
    return dataclasses.replace(hmm, state_mix=mix, state_lw=lw)


@pytest.fixture(scope="module")
def mono():
    hmm = edge_hmmset()
    gs = parse_hmmdefs_text(make_hmmdefs_text(
        phones=("a", "b", "c", "sil"), dim=DIM, n_states=3, n_mix=1,
        seed=9))
    rng = np.random.default_rng(0)
    x = (hmm.means[rng.integers(0, hmm.n_gauss, (2, 9))]
         + rng.standard_normal((2, 9, DIM))).astype(np.float32)
    return hmm, gs, x


def port_tables(ref_tables):
    return convert.load_gmm_tables(convert.numpy_fields(ref_tables), "cpu")


def assert_close(got, want, atol=ATOL):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_tables(mono):
    hmm = mono[0]
    ref = convert.numpy_fields(jgmm.build_gmm_tables(hmm))
    for tabs in (tgmm.build_gmm_tables(hmm, device="cpu"),
                 convert.load_gmm_tables(ref, "cpu")):
        assert np.array_equal(tabs.w.numpy(),
                              np.concatenate([ref["a"], -ref["half_iv"]]))
        for name in ("c", "state_mix", "state_lw"):
            assert np.array_equal(getattr(tabs, name).numpy(), ref[name])
        assert tabs.state_mix.dtype == torch.int64


def test_gauss_scores(mono):
    hmm, _, x = mono
    ref = jgmm.build_gmm_tables(hmm)
    got = tgmm.gauss_scores(port_tables(ref), torch.from_numpy(x))
    assert_close(got, jgmm.gauss_scores(ref, jnp.asarray(x)))


@pytest.mark.parametrize("topk", [0, 1, 2])
def test_senone_scores(mono, topk):
    hmm, _, x = mono
    ref = jgmm.build_gmm_tables(hmm)
    want = jgmm.senone_scores(ref, jnp.asarray(x), topk=topk)
    got = tgmm.senone_scores(port_tables(ref), torch.from_numpy(x),
                             topk=topk)
    assert_close(got, want)
    assert (got[..., 0] == LOG_ZERO).all()       # all-LOG_ZERO weights


def test_senone_scores_in_row_chunks(mono, monkeypatch):
    hmm, _, x = mono
    tabs = tgmm.build_gmm_tables(hmm, device="cpu")
    whole = tgmm.senone_scores(tabs, torch.from_numpy(x), topk=2)
    S, M = tabs.state_mix.shape
    monkeypatch.setattr(tgmm, "CHUNK_BYTES", 4 * S * M * 4)   # 4 rows
    assert torch.equal(
        tgmm.senone_scores(tabs, torch.from_numpy(x), topk=2), whole)


@pytest.fixture(scope="module")
def triphones():
    """A tied-triphone set (6 base phones x 3 variants), its vocabulary
    and N-gram, and the network's pseudo phone sets."""
    hmm = jsynth.make_triphone_hmmset(n_base=6, variants=3, dim=DIM,
                                      tied_pool=36, seed=0)
    voca = jsynth.make_vocabulary(hmm, 40, min_phones=2, max_phones=4,
                                  seed=1)
    jsynth.bind_triphones(hmm, voca, n_base=6, variants=3)
    lm = jsynth.make_ngram(voca, seed=2)
    net = build_network(hmm, voca, use_triphone=True)
    assert net.pseudo is not None and net.pseudo.n_set_states > 0
    return hmm, voca, lm, net.pseudo


@pytest.fixture(scope="module")
def triphone_engine(triphones):
    hmm, voca, lm, _ = triphones
    return Engine(hmm, voca, lm, device="cpu")


@pytest.mark.parametrize("scheme", [("max", 1), ("avg", 3), ("best", 3)])
def test_pseudo_scores(triphones, triphone_engine, scheme):
    """The engine's outprob rows of a GMM triphone network (senone
    scores, then the pseudo set-states' columns aggregated from them)
    against the reference scorer's senone_scores with pseudo tables."""
    hmm, _, _, pseudo = triphones
    ref = jgmm.build_gmm_tables(hmm, pseudo)
    eng = triphone_engine
    members, segids, n_pseudo = convert.pseudo_fields(eng).values()
    assert np.array_equal(members, np.asarray(ref.pseudo_members))
    assert np.array_equal(segids, np.asarray(ref.pseudo_segids))
    assert n_pseudo == ref.n_pseudo == pseudo.n_set_states
    eng.am_cfg = dataclasses.replace(eng.am_cfg, iwcd_scheme=scheme[0],
                                     iwcd_nbest=scheme[1])
    x = np.random.default_rng(3).standard_normal((3, 7, DIM)).astype(
        np.float32)
    want = jgmm.senone_scores(ref, jnp.asarray(x), iwcd_scheme=scheme[0],
                              iwcd_nbest=scheme[1])
    got = eng._outprob(torch.from_numpy(x))
    assert got.shape[-1] == hmm.n_states + pseudo.n_set_states
    assert_close(got, want)


@pytest.mark.parametrize("gsnum,topk", [(2, 0), (5, 2), (12, 0)])
def test_gms_senone_scores(mono, gsnum, topk):
    hmm, gs, x = mono
    ref_tabs = jgmm.build_gmm_tables(hmm)
    ref_gms = jgms.build_gms(hmm, gs, gsnum)
    port_gms = convert.load_gms_tables(convert.gms_fields(ref_gms), "cpu")
    own = tgms.build_gms(hmm, gs, gsnum, device="cpu")
    assert torch.equal(own.state2gs, port_gms.state2gs)
    assert np.array_equal(own.state2gs.numpy(), np.asarray(ref_gms.state2gs))
    want = jgms.gms_senone_scores(ref_tabs, ref_gms, jnp.asarray(x),
                                  topk=topk)
    got = tgms.gms_senone_scores(port_tables(ref_tabs), port_gms,
                                 torch.from_numpy(x), topk=topk)
    assert_close(got, want)
    if gsnum >= gs.n_states:       # every state selected: the full scores
        assert_close(got, jgmm.senone_scores(ref_tabs, jnp.asarray(x)))


def mono_task():
    """24 monophones x 3 states x 4 diagonal Gaussians at 12 dims, 60
    words; utterances from each state's first component plus noise."""
    hmm = jsynth.make_hmmset(n_phones=24, n_states=3, dim=12, n_mix=4,
                             seed=0)
    voca = jsynth.make_vocabulary(hmm, 60, seed=1)
    lm = jsynth.make_ngram(voca, seed=2)
    truths, frames, lens = jsynth.make_flagship_utts(
        hmm, voca, lm, hmm.means[hmm.state_mix[:, 0]], 3, 12, 1,
        min_words=2, max_words=4, seed=1)
    return hmm, voca, lm, truths, frames, lens


def tri_task(triphones):
    hmm, voca, lm, _ = triphones
    eng = JEngine(hmm, voca, lm, am_cfg=JAMConfig(iwcd_scheme="max"))
    truths, frames, lens = jsynth.make_lvcsr_utts(
        eng, hmm.means, 3, DIM, 1, min_words=2, max_words=4, seed=4)
    return hmm, voca, lm, truths, frames, lens


CONFIGS = {
    "default": dict(),
    "gprune_topk": dict(am=dict(gprune="topk", gprune_num=2)),
    "gshmm": dict(am=dict(gsnum=8), gshmm=True),
    "frozen": dict(search=dict(pass2_rescan=False)),
    "triphone_pseudo": dict(am=dict(iwcd_scheme="max")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_features(name, triphones):
    cfg = CONFIGS[name]
    hmm, voca, lm, truths, frames, lens = (
        tri_task(triphones) if name.startswith("triphone") else mono_task())
    feats = np.zeros((len(frames), max(lens), frames[0].shape[1]),
                     np.float32)
    for u, f in enumerate(frames):
        feats[u, :len(f)] = f
    lens = np.asarray(lens, np.int32)
    gshmm = first_component_hmmset(hmm) if cfg.get("gshmm") else None
    search = dict(lm_weight=8.0, lm_penalty=-2.0, **cfg.get("search", {}))
    ref = JEngine(hmm, voca, lm, search=JSearchConfig(**search),
                  am_cfg=JAMConfig(**cfg.get("am", {})), gshmm=gshmm)
    eng = Engine(hmm, voca, lm, search=SearchConfig(**search),
                 am_cfg=AMConfig(**cfg.get("am", {})), gshmm=gshmm,
                 device="cpu")
    assert eng.dnn_scorer is None and (eng.gms is not None) == bool(gshmm)
    want = ref.decode_features(jnp.asarray(feats), jnp.asarray(lens))
    got = eng.decode_features(feats, lens)
    assert [g.word_ids for g in got] == [r.word_ids for r in want]
    assert [g.from_pass for g in got] == [r.from_pass for r in want]
    for g, r in zip(got, want):
        assert g.score == pytest.approx(r.score, abs=0.05)
        assert g.am_score == pytest.approx(r.am_score, abs=0.05)
    if name in ("default", "gprune_topk"):
        assert [g.words for g in got] == truths
    rows = eng.compute_outprob(feats)
    assert rows.shape == feats.shape[:2] + (hmm.n_states,)
    np.testing.assert_allclose(
        rows, ref.compute_outprob(jnp.asarray(feats)), rtol=0, atol=ATOL)
