"""Pass 2: stack-decoding search over the pass-1 word trellis with full
N-gram rescoring.

The reference's second pass (`libjulius/src/search_bestfirst_main.c:1234`
wchmm_fbs) grows hypotheses backward from the sentence end with a
backward N-gram, re-running per-word Viterbi (`search_bestfirst_v1.c:589`
scan_word) against the trellis.  Here the equivalent search runs
*forward* over the lattice implied by the trellis: word-end atoms are
lattice nodes, an atom b can follow a when b.begin == a.end + 1, and the
exact prefix score uses the full forward N-gram — so no backward model or
forw2back conversion (`ngram_decode.c:139`) is needed, and any order
works directly.

A* admissible-ish heuristic: the pass-1 score itself estimates the best
completion (rest = best_total - atom.pass1_score), the mirror image of
the reference using pass-1 scores as the forward estimate
(`search.h` NODE.g[] + backtrellis lookup).  The stack, hypothesis cap
and beam mirror `-s`/`-m`/`-n` (`jconf.h` JCONF_SEARCH pass2 block).

Word boundaries are fixed to pass-1 Viterbi boundaries (the reference
re-derives them in scan_word; a device-batched boundary refinement is the
planned next step — see SURVEY.md §7 step 6).

This is a copy of `julius_tpu/search/pass2.py`'s forward frozen-score
search (with `TrellisLattice`, `NBestResult` and `confidence_scores`);
the backward-LM and DFA searches come with the ROADMAP items that need
them.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.io.arpa import NGramLM


@dataclass
class Hypo:
    """A sentence prefix (reference NODE, search.h:88)."""

    score: float            # exact prefix score (AM + weighted pass-2 LM)
    atom: int               # flattened trellis atom id of last word
    words: Tuple[int, ...]  # vocab word ids so far
    lm_score: float = 0.0   # accumulated weighted LM portion
    am_score: float = 0.0   # accumulated AM portion
    bounds: Tuple[Tuple[int, int], ...] = ()

    def __lt__(self, other):  # heapq tie-break
        return self.score > other.score


@dataclass
class NBestResult:
    word_ids: List[int]
    score: float
    am_score: float
    lm_score: float
    bounds: List[Tuple[int, int]]
    cm: Optional[List[float]] = None


class TrellisLattice:
    """Host view of the pass-1 trellis as a lattice (one utterance)."""

    def __init__(self, trellis, n_frames: int):
        self.word = np.asarray(trellis.word)[:n_frames]     # [T, M]
        self.score = np.asarray(trellis.score)[:n_frames]
        self.lm = np.asarray(trellis.lm)[:n_frames]
        self.prev = np.asarray(trellis.prev)[:n_frames]
        self.begin = np.asarray(trellis.begin)[:n_frames]
        self.T, self.M = self.word.shape
        self._by_begin: Optional[Dict[int, List[Tuple[int, int]]]] = None

    @property
    def by_begin(self) -> Dict[int, List[Tuple[int, int]]]:
        """Atoms grouped by begin frame (successor lookup).  Lazy: only
        the frozen-score searches walk it; the rescan paths read the
        arrays directly, and building ~10k-atom dicts per utterance was
        ~3 s of the flagship batch's wall."""
        if self._by_begin is None:
            self._by_begin = {}
            t_idx, m_idx = np.nonzero(self.word >= 0)
            for b, t, m in zip(self.begin[t_idx, m_idx].tolist(),
                               t_idx.tolist(), m_idx.tolist()):
                self._by_begin.setdefault(b, []).append((t, m))
        return self._by_begin

    def by_end(self, t: int) -> List[Tuple[int, int]]:
        """Atoms whose word ends at frame t (trellis row t)."""
        if t < 0 or t >= self.T:
            return []
        return [(t, m) for m in range(self.M) if self.word[t, m] >= 0]

    def atom_id(self, t: int, m: int) -> int:
        return t * self.M + m

    def am_of(self, t: int, m: int) -> float:
        """Acoustic (+ HMM transition) score of the word span alone:
        cumulative pass-1 score minus predecessor cumulative minus the
        pass-1 LM portion."""
        prev = int(self.prev[t, m])
        base = 0.0
        if prev >= 0:
            pt, pm = divmod(prev, self.M)
            base = float(self.score[pt, pm])
        return float(self.score[t, m]) - base - float(self.lm[t, m])


def pass2_search(
    lattice: TrellisLattice,
    lm: Optional[NGramLM],
    wid2lm: Optional[np.ndarray],
    cfg: SearchConfig,
    tail_word: int,
    transparent: Optional[np.ndarray] = None,
    cprob: Optional[np.ndarray] = None,
) -> List[NBestResult]:
    """A* N-best over the trellis lattice.  Returns up to cfg.nbest
    sentences, best first (reference result_reorder_and_output)."""
    T, M = lattice.T, lattice.M
    if T == 0:
        return []
    lw2, pen2 = cfg.lm_weight2, cfg.lm_penalty2

    def word_pen(w: int) -> float:
        # class N-gram in-class prob added unweighted (ngram_decode.c:274)
        return pen2 + (float(cprob[w]) if cprob is not None else 0.0)

    def lm_logprob(ctx_words: Tuple[int, ...], w: int) -> float:
        if lm is None or wid2lm is None:
            return 0.0
        wl = int(wid2lm[w])
        if wl < 0:
            return -99.0
        ctx = tuple(int(wid2lm[c]) for c in ctx_words if wid2lm[c] >= 0)
        return lm.logprob(ctx, wl)

    def lm_ctx(words: Tuple[int, ...]) -> Tuple[int, ...]:
        """Last (order-1) non-transparent words (reference skips
        transparent words for LM context)."""
        need = (lm.order - 1) if lm is not None else 1
        out = []
        for w in reversed(words):
            if transparent is not None and transparent[w]:
                continue
            out.append(w)
            if len(out) >= need:
                break
        return tuple(reversed(out))

    best_total = _final_best(lattice)
    if not np.isfinite(best_total):
        return []

    # initial hypotheses: atoms beginning at frame 0
    stack: List[Hypo] = []
    for (t, m) in lattice.by_begin.get(0, []):
        w = int(lattice.word[t, m])
        am = lattice.am_of(t, m)
        lms = lw2 * lm_logprob((), w) + word_pen(w)
        sc = am + lms
        rest = best_total - float(lattice.score[t, m])
        heapq.heappush(stack, Hypo(
            score=sc + rest, atom=lattice.atom_id(t, m), words=(w,),
            lm_score=lms, am_score=am, bounds=((int(lattice.begin[t, m]), t),)))

    results: List[NBestResult] = []
    seen: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    n_pop = 0
    while stack and len(results) < cfg.nbest and n_pop < cfg.max_hypo_pop:
        h = heapq.heappop(stack)
        n_pop += 1
        t, m = divmod(h.atom, M)
        key = (h.atom, lm_ctx(h.words))
        cnt = seen.get(key, 0)
        if cnt >= cfg.nbest:
            continue
        seen[key] = cnt + 1
        if t == T - 1:
            # only sentences ending with the tail word are acceptable
            # (reference ngram_acceptable, ngram_decode.c:616)
            if int(lattice.word[t, m]) == tail_word:
                exact = h.score - (best_total - float(lattice.score[t, m]))
                results.append(NBestResult(
                    word_ids=list(h.words),
                    score=exact,
                    am_score=h.am_score,
                    lm_score=h.lm_score,
                    bounds=list(h.bounds),
                ))
            continue
        # expand with atoms starting right after this one
        exact = h.score - (best_total - float(lattice.score[t, m]))
        for (nt, nm) in lattice.by_begin.get(t + 1, []):
            w = int(lattice.word[nt, nm])
            am = lattice.am_of(nt, nm)
            lms = lw2 * lm_logprob(lm_ctx(h.words), w) + word_pen(w)
            nsc = exact + am + lms
            rest = best_total - float(lattice.score[nt, nm])
            if len(stack) >= cfg.stack_size * 4:
                # bound the stack like the reference's fixed stack -s
                stack.sort()
                del stack[cfg.stack_size:]
                heapq.heapify(stack)
            heapq.heappush(stack, Hypo(
                score=nsc + rest,
                atom=lattice.atom_id(nt, nm),
                words=h.words + (w,),
                lm_score=h.lm_score + lms,
                am_score=h.am_score + am,
                bounds=h.bounds + ((int(lattice.begin[nt, nm]), nt),),
            ))
    results.sort(key=lambda r: -r.score)
    return results


def _final_best(lattice: TrellisLattice) -> float:
    """Best pass-1 cumulative score over FINAL-FRAME atoms (complete
    paths — a max over ALL atoms picks an early-frame atom whenever
    frame scores are negative, e.g. GMM log-likelihoods)."""
    row = lattice.score[lattice.T - 1]
    valid = lattice.word[lattice.T - 1] >= 0
    if not valid.any():
        return float("-inf")
    return float(np.max(np.where(valid, row, -np.inf)))


def confidence_scores(results: List[NBestResult],
                      alpha: float = 0.05) -> None:
    """Per-word posterior confidence from the N-best list (reference
    cm_compute_from_nbest, search_bestfirst_main.c:635): for each word
    occurrence, the normalised exp(alpha * score) mass of hypotheses
    containing the same word at an overlapping position."""
    if not results:
        return
    smax = max(r.score for r in results)
    weights = [np.exp(alpha * (r.score - smax)) for r in results]
    z = sum(weights)
    for r in results:
        cms = []
        for w, (b, e) in zip(r.word_ids, r.bounds):
            mass = 0.0
            for r2, wt in zip(results, weights):
                for w2, (b2, e2) in zip(r2.word_ids, r2.bounds):
                    if w2 == w and not (e2 < b or b2 > e):
                        mass += wt
                        break
            cms.append(min(1.0, mass / z))
        r.cm = cms
