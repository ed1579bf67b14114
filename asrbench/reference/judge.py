"""The numbers that decide `correct`, worked out by the plain reference.

For each utterance of the sample the reference scores its features with
the plain DNN (`dnn.py`) and then judges what the program produced:

* `dnn_gap`: the largest gap between a senone score of the program's
  outprob cache and the reference's, over the utterance's frames;
* `atom_gap`: for every word end the program's pass 1 recorded (its
  trellis), the gap between its score and its predecessor's score plus
  the exact weighted 2-gram score of the word after the predecessor's
  word plus the reference's best in-word score over the atom's frames;
* `bad_links`: word ends whose predecessor is not the best word end of
  the frame before the word's first frame (pass 1's cross-word rule
  under unigram factoring), or that start a sentence elsewhere than
  with <s> at frame 0;
* `missing`: sampled utterances with no valid result, or one that came
  from another pass than the cell runs;
* `p1_wrong` (pass 1 only): results whose words or score differ from
  the best path of the program's own trellis;
* `nbest_gap` (two passes): the gap between the pass-2 result's score
  and the reference's best sentence Viterbi of its words plus their
  weighted 2-gram score;
* `search_gap` (two passes): by how much the reference scores the
  result's words below the words the utterance was made from, each by
  its best sentence Viterbi and weighted 2-gram: what the search lost,
  where every score it kept is right;
* `truth_lost`: word ends of the utterance's own words on their forced
  alignment (the reference's best path through the true sentence) that
  the trellis lacks at their last frame although they score above that
  frame's M-th word end by more than the program's rounding: word ends
  the frame's top M should have kept.

None of it imports the program: it reads the program's outputs as numpy
arrays and Python values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from asrbench.reference.dnn import PlainDNN
from asrbench.reference.lexicon import Bigram, Lexicon
from asrbench.reference.viterbi import (forced_alignment, sentence_scores,
                                        word_scores)

#: score units by which a lost word end has to beat the frame's M-th
#: kept one: above the program's rounding of a word end's score (atom
#: gaps read under 0.003 on sound runs)
TIE = 0.5


def reference_scores(model, feats: List[np.ndarray], device,
                     operand: str = "bf16") -> List[torch.Tensor]:
    """The plain DNN's [T, S] senone scores of each utterance."""
    dnn = PlainDNN(model, device, operand)
    x = torch.as_tensor(np.concatenate(feats), device=device)
    with torch.no_grad():
        out = dnn(x)
    return list(torch.split(out, [f.shape[0] for f in feats]))


def lm_sum(bigram: Bigram, words: List[int], lw: float, pen: float) -> float:
    """Weighted 2-gram score of a sentence, each word after its
    predecessor (the first after no context), plus the penalty a word."""
    return sum(lw * bigram(words[i - 1] if i else -1, w) + pen
               for i, w in enumerate(words))


def judge(model, samples: List[dict], two_pass: bool, device,
          lex: Lexicon = None):
    """The numbers of one run's sample (see the module's docstring).
    Each sample holds `feats` [T, D], `prog` [T, S] (the program's
    senone scores), `trellis` (word, score, lm, prev, begin, ectx as
    [T, M] arrays), `result` (word_ids, score, am_score, lm_score,
    from_pass, valid) and `truth` (word ids).  Returns (the compared
    numbers, other readings)."""
    s = model.search
    nums = dict(dnn_gap=0.0, atom_gap=0.0, bad_links=0, missing=0,
                truth_lost=0)
    info = {}
    if two_pass:
        nums["nbest_gap"] = 0.0
        nums["search_gap"] = 0.0
    else:
        nums["p1_wrong"] = 0
    if not samples:
        return nums, info
    lex = lex or Lexicon(model)
    bigram = Bigram(model)
    ref = reference_scores(model, [x["feats"] for x in samples], device)
    ext = [lex.extend(r.double(), s["iwcd_scheme"]) for r in ref]
    # 1. the DNN
    for x, r in zip(samples, ref):
        prog = torch.as_tensor(x["prog"], device=device, dtype=torch.float32)
        nums["dnn_gap"] = max(nums["dnn_gap"],
                              float((prog - r).abs().max()))
    # 2. pass 1's word ends
    rows0, words, begins, ends, want, lm_want, got, lm_got = \
        [], [], [], [], [], [], [], []
    lw, pen = s["lm_weight"], s["lm_penalty"]
    offset = 0
    for x in samples:
        tr = x["trellis"]
        T, M = tr["word"].shape
        t, m = np.nonzero(tr["word"] >= 0)
        w, prev, b = tr["word"][t, m], tr["prev"][t, m], tr["begin"][t, m]
        best = np.max(np.where(tr["word"] >= 0, tr["score"], -np.inf),
                      axis=1)
        pt, pm = np.divmod(np.maximum(prev, 0), M)
        v = np.where(prev >= 0, tr["word"][pt, pm], -1)
        base = np.where(prev >= 0, tr["score"][pt, pm], 0.0)
        # the predecessor is the best word end of the frame before the
        # word's first; a sentence starts with <s> at frame 0
        ok = np.where(prev >= 0, (pt == b - 1) & (v >= 0)
                      & (tr["score"][pt, pm] == best[pt]),
                      (b == 0) & (w == 0)) & (b >= 0) & (b <= t)
        nums["bad_links"] += int(np.sum(~ok))
        lm = np.asarray([lw * bigram(int(vv), int(ww)) + pen
                         for vv, ww in zip(v[ok], w[ok])], np.float64)
        rows0.append(np.full(int(ok.sum()), offset, np.int64))
        words.append(w[ok])
        begins.append(b[ok])
        ends.append(t[ok])
        want.append(base[ok] + lm)
        lm_want.append(lm)
        got.append(tr["score"][t, m][ok].astype(np.float64))
        lm_got.append(tr["lm"][t, m][ok].astype(np.float64))
        offset += x["feats"].shape[0]
    rows0, words, begins, ends, want, lm_want, got, lm_got = [
        np.concatenate(a) for a in (rows0, words, begins, ends, want,
                                    lm_want, got, lm_got)]
    ext_flat = torch.cat(ext)
    # every row reads the LOG_ZERO column's own value for padding
    acoustic = word_scores(lex, ext_flat, rows0, words.astype(np.int64),
                           begins.astype(np.int64), ends.astype(np.int64))
    if len(got):
        nums["atom_gap"] = float(np.max(np.abs(got - (want + acoustic))))
        info["lm_gap"] = float(np.max(np.abs(lm_got - lm_want)))
    # 3. results
    chains, rows, pairs = [], [], []
    for k, x in enumerate(samples):
        r = x["result"]
        if not r["valid"] or not r["word_ids"] \
                or r["from_pass"] != (2 if two_pass else 1):
            nums["missing"] += 1
            continue
        if not two_pass:
            best = _backtrace(x["trellis"])
            if best is None or best[0] != list(r["word_ids"]) \
                    or best[1] != r["score"]:
                nums["p1_wrong"] += 1
            continue
        for words_ in (list(r["word_ids"]), list(x["truth"])):
            chains.append(lex.sentence(words_, s["strict_iwcd2"]))
            rows.append(ext[k])
        pairs.append((r, list(x["truth"])))
    if two_pass and pairs:
        am = sentence_scores(chains, rows)
        lw2, pen2 = s["lm_weight2"], s["lm_penalty2"]
        for i, (r, truth) in enumerate(pairs):
            lm_r = lm_sum(bigram, r["word_ids"], lw2, pen2)
            lm_t = lm_sum(bigram, truth, lw2, pen2)
            nums["nbest_gap"] = max(nums["nbest_gap"],
                                    abs(r["score"] - (am[2 * i] + lm_r)))
            nums["search_gap"] = max(nums["search_gap"],
                                     (am[2 * i + 1] + lm_t)
                                     - (am[2 * i] + lm_r))
    # 4. the true words' ends against each frame's top M
    nums["truth_lost"] = _truth_lost(lex, bigram, samples, ext, lw, pen)
    return nums, info


def _truth_lost(lex, bigram, samples, ext, lw, pen) -> int:
    """Word ends of the forced alignment of each utterance's own words
    (pass 1's word models) that its trellis lacks at their last frame
    while beating that frame's M-th kept word end by more than TIE."""
    truths = [list(x["truth"]) for x in samples]
    chains = [lex.sentence(t, False) for t in truths]
    owners = [np.repeat(np.arange(len(t)), lex.length[t]) for t in truths]
    _, ends = forced_alignment(chains, owners, ext)
    lost = 0
    rows0, words, begins, ends_, lms, where = [], [], [], [], [], []
    offset = 0
    for k, (x, t, e) in enumerate(zip(samples, truths, ends)):
        if len(e) != len(t):
            lost += len(t)          # no path through the true sentence
        else:
            b = np.concatenate([[0], e[:-1] + 1])
            rows0.append(np.full(len(t), offset, np.int64))
            words.append(np.asarray(t, np.int64))
            begins.append(b)
            ends_.append(e)
            lms.append([lw * bigram(t[i - 1] if i else -1, w) + pen
                        for i, w in enumerate(t)])
            where.append(k)
        offset += x["feats"].shape[0]
    if not where:
        return lost
    acoustic = word_scores(lex, torch.cat(ext), np.concatenate(rows0),
                           np.concatenate(words), np.concatenate(begins),
                           np.concatenate(ends_))
    i = 0
    for k, e, lm in zip(where, ends_, lms):
        n = len(e)
        prefix = np.cumsum(acoustic[i:i + n] + np.asarray(lm))
        i += n
        tr = samples[k]["trellis"]
        M = tr["word"].shape[1]
        for w, f, p in zip(truths[k], e, prefix):
            row_w, row_s = tr["word"][f], tr["score"][f]
            if (row_w == w).any():
                continue
            kept = row_s[row_w >= 0]
            floor = kept.min() if len(kept) >= M else -np.inf
            lost += int(p > floor + TIE)
    return lost


def _backtrace(tr):
    """(words, score) of the best path through one utterance's trellis:
    the best word end of the last frame that is </s>, else the best of
    any word, followed back through its predecessors."""
    word, score, prev = tr["word"], tr["score"], tr["prev"]
    T, M = word.shape
    last = word[T - 1]
    cand = np.where(last == 1, score[T - 1], -np.inf)
    if not np.isfinite(cand).any():
        cand = np.where(last >= 0, score[T - 1], -np.inf)
        if not np.isfinite(cand).any():
            return None
    m = int(np.argmax(cand))
    total = float(score[T - 1, m])
    out = []
    a = (T - 1) * M + m
    while a >= 0:
        t, mm = divmod(a, M)
        out.append(int(word[t, mm]))
        a = int(prev[t, mm])
    return out[::-1], total
