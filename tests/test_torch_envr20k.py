"""The port on a tied-state triphone model (asrbench's envr20k builder at
a small size) against the benchmark's plain reference, on the CPU.

An engine built by the benchmark's adapter (`asrbench/program.py`) over
triphones tied into clusters of uneven size, with pass-1 pseudo phone
sets under `-iwcd1 max`, strict inter-word heads in pass 2 and M = 128
word ends a frame, decodes a batch of four utterances.  It must take
the device A* (not the host re-scan), and the reference
(`asrbench/reference/`: plain PyTorch and NumPy) must find its extended
scores (senones and every pseudo set-state), its trellis word ends and
its pass-2 sentence scores within the limits of the `envr20k.batch16`
cell.  With the tracer on, the aggregation is a `dnn.pseudo` span
under `dnn` and its counters add up; off, nothing is recorded.
"""

import json

import numpy as np
import pytest
import torch

from asrbench import harness, synth
from asrbench.program import build_engine
from asrbench.reference.judge import judge, reference_scores
from asrbench.reference.lexicon import Lexicon
from julius_tpu_torch.ops import gmm
from julius_tpu_torch.search import pass2_device as tp2d
from julius_tpu_torch.utils import trace

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

CFG = harness.load_json(harness.HERE / "configs" / "envr20k.json")
LIMITS = harness.load_json(harness.HERE / "limits" / "envr20k.batch16.json")
#: small widths; the search as the configuration sets it (M = 128 over
#: 300 words, so the word-end stage ranks 256 of 300 exits)
SMALL = dict(feat_dim=6, input_size=66, hidden_size=32, num_hidden_layers=2,
             num_phones=8, variants=5, num_senones=80, vocab_size=300)
WORDS = [3, 5, 4, 6]


@pytest.fixture(scope="module")
def decoded():
    """(model, engine, batch, results, kept outputs, LAST_STATS, the
    tracer's records and counters of the decode)."""
    cfg = dict(CFG, **SMALL)
    assert cfg["search"]["trellis_topm"] == 128
    builder = harness.load_module(harness.HERE / "configs" / "envr20k.py")
    model = builder.build(cfg, 0)
    eng = build_engine(model, "cpu")
    truths, wins = synth.make_utterances(model, WORDS, 2**31 + 5, 0.85)
    batch = harness._pad(wins, truths, model.context)
    kept = {}
    outprob, pass1 = eng._outprob, eng._pass1

    def keep_outprob(feats):
        kept["ext"] = outprob(feats)
        return kept["ext"]

    def keep_pass1(out_ext, n_frames):
        kept["trellis"] = pass1(out_ext, n_frames)
        return kept["trellis"]

    eng._outprob, eng._pass1 = keep_outprob, keep_pass1
    trace.drain()
    trace.drain_counts()
    trace.enable(True)
    try:
        with torch.no_grad():
            res = eng.decode_features(batch.feats, batch.nfr)
        stats = dict(tp2d.LAST_STATS)
        records, counts = trace.drain(), trace.drain_counts()
    finally:
        trace.enable(False)
    return model, eng, batch, res, kept, stats, records, counts


def test_pass2_is_the_device_astar_with_strict_heads(decoded):
    model, eng, batch, res, kept, stats, records, counts = decoded
    assert eng.net.pseudo is not None and eng._pseudo is not None
    assert eng._device_astar_ok()
    assert [r.from_pass for r in res] == [2] * len(WORDS)
    names = [r.name for r in records]
    assert "astar.rounds" in names and names.count("astar") == 1
    assert stats["B"] == len(WORDS) and stats["rounds"] > 0
    # a trellis of 128 word ends a frame pops 32 hypotheses a round
    assert stats["P"] == tp2d.pops_per_round(128) == 32
    # 8 base phones' last phones: classes 1..8, class 0 for no context
    assert stats["strict_classes"] == eng.iwcd2_tables.head_sidx.shape[1]
    assert stats["strict_classes"] > 1
    # with pseudo sets the retry net spot-checks the worst utterance of
    # a first batch on the host; no other utterance leaves the card
    assert eng.last_pass2["retried"] <= 1


def test_the_reference_holds_the_extended_scores(decoded):
    model, eng, batch, res, kept, stats, records, counts = decoded
    lex = Lexicon(model)
    S = model.n_states
    mem, seg, nq = eng._pseudo
    mem, seg = mem.numpy(), seg.numpy()
    keys = [tuple(sorted(set(mem[seg == q].tolist()))) for q in range(nq)]
    assert set(keys) >= set(lex.sets)
    ext = kept["ext"]
    assert ext.shape[-1] == S + nq
    for u, n in enumerate(batch.nfr):
        ref = reference_scores(model, [batch.feats[u, :n]], "cpu")[0]
        ref_ext = lex.extend(ref.double(), "max")
        prog = ext[u, :n].double()
        assert float((prog[:, :S] - ref_ext[:, :S]).abs().max()) \
            <= LIMITS["dnn_gap"]
        pairs = [(S + q, S + lex.sets[k]) for q, k in enumerate(keys)
                 if k in lex.sets]
        cols_p, cols_r = zip(*pairs)
        gap = (prog[:, list(cols_p)] - ref_ext[:, list(cols_r)]).abs().max()
        assert float(gap) <= LIMITS["dnn_gap"]


def test_the_reference_holds_word_ends_and_sentences(decoded):
    model, eng, batch, res, kept, stats, records, counts = decoded
    tr = kept["trellis"]
    samples = []
    for u, r in enumerate(res):
        n = int(batch.nfr[u])
        samples.append(dict(
            feats=batch.feats[u, :n],
            prog=kept["ext"][u, :n, :model.n_states].float().numpy(),
            trellis={f: getattr(tr, f)[u, :n].numpy() for f in tr._fields},
            result=dict(word_ids=list(r.word_ids), score=float(r.score),
                        am_score=float(r.am_score),
                        lm_score=float(r.lm_score),
                        from_pass=int(r.from_pass), valid=bool(r.valid)),
            truth=batch.truths[u]))
    nums, _ = judge(model, samples, True, "cpu")
    assert set(nums) == set(LIMITS)
    for k, v in nums.items():
        assert v <= LIMITS[k], (k, v, json.dumps(nums))
    assert sum(r.word_ids == t for r, t in zip(res, batch.truths)) >= 3


def test_the_tracer_records_the_aggregation_and_its_counters(decoded):
    model, eng, batch, res, kept, stats, records, counts = decoded
    by_id = {r.id: r for r in records}
    pseudo = [r for r in records if r.name == "dnn.pseudo"]
    assert len(pseudo) == 1
    parent = by_id[pseudo[0].parent]
    assert parent.name == trace.PARENT["dnn.pseudo"] == "dnn"
    assert parent.start_ns <= pseudo[0].start_ns <= pseudo[0].end_ns \
        <= parent.end_ns
    mem, seg, nq = eng._pseudo
    rows = batch.feats.shape[0] * batch.feats.shape[1]
    L = int(mem.shape[0])
    assert nq > 0 and L > nq
    assert counts["pseudo.rows"] == rows
    assert counts["pseudo.chunks"] == -(-rows // gmm.chunk_rows(rows, L))
    assert set(counts) <= set(trace.COUNTERS)


def test_a_smaller_chunk_gives_the_same_scores_and_counts_its_chunks(
        decoded, monkeypatch):
    model, eng, batch, res, kept, stats, records, counts = decoded
    rows = torch.as_tensor(kept["ext"][..., :model.n_states])
    L = int(eng._pseudo[0].shape[0])
    monkeypatch.setattr(gmm, "CHUNK_BYTES", 4 * L * 7)
    trace.drain_counts()
    trace.enable(True)
    try:
        again = eng._extend(rows)
        counts = trace.drain_counts()
    finally:
        trace.enable(False)
    n = rows.shape[0] * rows.shape[1]
    assert counts["pseudo.chunks"] == -(-n // 7)
    assert torch.equal(again, kept["ext"])


def test_off_the_tracer_records_nothing(decoded):
    model, eng, batch, res, kept, stats, records, counts = decoded
    trace.enable(False)
    trace.drain()
    trace.drain_counts()
    with torch.no_grad():
        eng._extend(kept["ext"][..., :model.n_states])
        trace.count("pseudo.chunks", 5)
    assert trace.drain() == [] and trace.drain_counts() == {}


@pytest.mark.parametrize("M,pops", [(16, 8), (32, 8), (64, 8), (65, 8),
                                    (127, 8), (128, 32)])
def test_pops_a_round_rise_past_a_trellis_of_64(M, pops):
    assert tp2d.pops_per_round(M) == pops


def test_the_round_budget_does_not_depend_on_the_pops(decoded, monkeypatch):
    """The arena holds P rows a round and is sized in rounds: 8 pops and
    32 get the same max_rounds, and the same words."""
    model, eng, batch, res, kept, stats, records, counts = decoded
    assert stats["CAPP"] == stats["max_rounds"] * stats["P"]
    monkeypatch.setattr(tp2d, "WIDE_POPS", tp2d.POPS)
    with torch.no_grad():
        narrow_res = eng.decode_features(batch.feats, batch.nfr)
    narrow = dict(tp2d.LAST_STATS)
    assert narrow["P"] == tp2d.POPS < stats["P"]
    assert narrow["max_rounds"] == stats["max_rounds"] > stats["rounds"]
    assert narrow["CAPP"] == narrow["max_rounds"] * tp2d.POPS
    assert [r.word_ids for r in narrow_res] == [r.word_ids for r in res]
