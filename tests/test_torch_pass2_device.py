"""Port vs reference: the device A* (search/pass2_device.py `run_batch`).

Both packages search the SAME pass-1 lattices with the SAME outprob
cache: the reference engine's (`out_ext` of its bf16 DNN, the trellis of
its pass 1), handed to the port as numpy arrays, with the chain tables
and the hashed N-gram carried across by convert.py.  Feeding one
`out_ext` keeps the DNN's own drift between the packages out of this
test, so the searches must agree exactly: N-best word ids, refined word
bounds, the number of rounds and every utterance's pop count are equal,
scores within atol 1e-4 (sums of the same float32 terms).

The helpers here (`converted_engine`, `reference_batch`) also serve the
re-scan and engine tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.search import pass2 as jp2
from julius_tpu.search import pass2_device as jp2d
from julius_tpu.tools.synth import flagship_engine, make_flagship_utts
from julius_tpu_torch import convert
from julius_tpu_torch.config import AMConfig, FrontendConfig, SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.search import pass2 as tp2
from julius_tpu_torch.search import pass2_device as tp2d

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

SIZE = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


def converted_engine(eng, **search):
    """A port Engine (CPU) computing from the reference engine's own
    tables (DNN, network, N-gram, pass-2 chains, and for a triphone
    network its pseudo set-states and strict head tables), with its
    front-end configuration and its search config with `search`
    replaced."""
    cfg = dataclasses.replace(eng.search_cfg, **search)
    am = eng.am_cfg
    teng = Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                  frontend=FrontendConfig(**dataclasses.asdict(eng.fe_cfg)),
                  search=SearchConfig(**dataclasses.asdict(cfg)),
                  am_cfg=AMConfig(iwcd_scheme=am.iwcd_scheme,
                                  iwcd_nbest=am.iwcd_nbest),
                  device="cpu")
    strict = eng.iwcd2_tables if cfg.strict_iwcd2 else None
    convert.load_tables(
        teng, convert.numpy_fields(eng.dnn_scorer),
        convert.numpy_fields(eng.dev_net),
        convert.numpy_fields(eng.ngram_dev),
        convert.chain_fields(eng.device_chains),
        pseudo=convert.pseudo_fields(eng),
        iwcd2=convert.iwcd2_fields(strict) if strict is not None else None)
    return teng


def reference_batch(eng, protos, n, min_words, max_words, seed):
    """Generative utterances through the reference's DNN and pass 1:
    (truths, feats, lens, out_ext numpy [B, T, R], per-utterance numpy
    trellises)."""
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, n, 120, 11,
        min_words=min_words, max_words=max_words, seed=seed)
    return (truths,) + reference_outputs(eng, wins, lens)


def reference_outputs(eng, wins, lens):
    """Spliced windows through the reference's DNN and pass 1: (feats,
    lens, out_ext numpy [B, T, R], per-utterance numpy trellises)."""
    n = len(wins)
    feats = np.zeros((n, max(lens), 120 * 11), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    lens = np.asarray(lens, np.int32)
    out_ext = eng._outprob_jit(jnp.asarray(feats))
    host = jax.tree_util.tree_map(
        np.asarray, eng._pass1_jit(out_ext, jnp.asarray(lens)))
    trellises = [jax.tree_util.tree_map(lambda a: a[b], host)
                 for b in range(n)]
    return feats, lens, np.array(out_ext), trellises


def assert_same_nbest(got, want, atol=1e-4):
    assert len(got) == len(want)
    for g_list, w_list in zip(got, want):
        assert [r.word_ids for r in g_list] == [r.word_ids for r in w_list]
        for g, w in zip(g_list, w_list):
            assert [tuple(b) for b in g.bounds] == \
                [tuple(b) for b in w.bounds]
            assert g.score == pytest.approx(w.score, abs=atol)
            assert g.lm_score == pytest.approx(w.lm_score, abs=atol)
            assert g.am_score == pytest.approx(w.am_score, abs=atol)


@pytest.fixture(scope="module")
def reference():
    return flagship_engine(trained=True, **SIZE)


@pytest.fixture(scope="module")
def batches(reference):
    eng, protos = reference
    return {"short": reference_batch(eng, protos, 3, 2, 5, seed=1),
            "long": reference_batch(eng, protos, 4, 6, 12, seed=2)}


@pytest.mark.parametrize("batch,nbest", [("short", 1), ("short", 3),
                                         ("long", 1)])
def test_run_batch_matches_reference(reference, batches, batch, nbest):
    eng, _ = reference
    _, _, lens, out_ext, trs = batches[batch]
    cfg = dataclasses.replace(eng.search_cfg, nbest=nbest)
    want = jp2d.run_batch(
        [jp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        eng.device_chains, eng.ngram_dev, eng._wid2lm_p2, eng._cprob_arr(),
        jnp.asarray(out_ext), eng._rescan_strategy(), cfg)
    want_stats = dict(jp2d.LAST_STATS)
    teng = converted_engine(eng, nbest=nbest)
    got = tp2d.run_batch(
        [tp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        teng.device_chains, teng.ngram_dev, teng._wid2lm, teng._cprob_arr(),
        torch.from_numpy(out_ext), teng._rescan_strategy(),
        teng.search_cfg)
    got_stats = dict(tp2d.LAST_STATS)
    assert_same_nbest(got, want)
    assert all(got)                  # every utterance found a sentence
    if nbest > 1:
        assert max(len(r) for r in got) > 1
    for key in ("rounds", "n_pops", "max_rounds", "CAPP", "S", "CA", "CK",
                "NA"):
        assert got_stats[key] == want_stats[key], key
    assert got_stats["rounds"] < got_stats["max_rounds"]


def test_prepare_and_estimates_match_reference(reference, batches):
    """The host half (copied code): candidate tables, suffix estimates
    and initial stacks come out identical."""
    eng, _ = reference
    _, _, lens, out_ext, trs = batches["short"]
    teng = converted_engine(eng)
    fmax = out_ext.max(axis=2)
    jbest = jp2d._best_lm_in(eng._rescan_strategy(), 121)
    tbest = tp2d._best_lm_in(teng._rescan_strategy(), 121)
    np.testing.assert_array_equal(tbest, jbest)
    T = out_ext.shape[1]
    want = jp2d.prepare(
        [jp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        T, eng._rescan_strategy(), eng.search_cfg, 2000, None, jbest,
        fmax=fmax)
    got = tp2d.prepare(
        [tp2.TrellisLattice(tr, int(n)) for tr, n in zip(trs, lens)],
        T, teng._rescan_strategy(), teng.search_cfg, 2000, None, tbest,
        fmax=torch.from_numpy(fmax))
    for f in ("ab", "ae", "aw", "ainc", "rest", "last", "packed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for a, b in zip(got.stack0, want.stack0):
        np.testing.assert_array_equal(a, b)


def test_hashes_are_bit_equal_to_uint32():
    """The sequence, envelope and recombination hashes against the
    reference's uint32 expressions (pass2_device.py:360, :516, :894,
    :909), on ids that reach 2^31 and on the -1 of a missing prev."""
    rng = np.random.default_rng(3)
    h = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 5001, 4000).astype(np.int32)
    key = rng.integers(0, 5001 * 510, 4000).astype(np.int32)
    prev = rng.integers(-1, 5000, 4000).astype(np.int32)
    prev[:50] = -1
    u32 = np.uint32
    with np.errstate(over="ignore"):
        seq = h * u32(1000003) + w.astype(u32) + u32(1)
        env = (h * u32(2654435761)) % u32(tp2d.ENV_H)
        k1 = ((key.astype(u32) * u32(2654435761))
              ^ (prev.astype(u32) * u32(2246822519))) % u32(tp2d.DH)
        k2 = ((w.astype(u32) * u32(40503))
              ^ (prev.astype(u32) * u32(2654435761))) % u32(tp2d.DH)
    th = torch.from_numpy(h.astype(np.int64))
    tw, tk, tprev = (torch.from_numpy(a.astype(np.int64))
                     for a in (w, key, prev))
    np.testing.assert_array_equal(tp2d._seq_mix(th, tw).numpy(), seq)
    np.testing.assert_array_equal(tp2d._env_key(th).numpy(), env)
    g1, g2 = tp2d._recomb_keys(tk, tw, tprev)
    np.testing.assert_array_equal(g1.numpy(), k1)
    np.testing.assert_array_equal(g2.numpy(), k2)
