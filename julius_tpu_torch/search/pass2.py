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

This is a copy of `julius_tpu/search/pass2.py`'s frozen-score searches:
the forward N-gram one, the backward one for an RL model
(`pass2_search_backward`, growing sentence suffixes from the end with
the backward N-gram) and the DFA grammar one (with `TrellisLattice`,
`NBestResult` and `confidence_scores`); the reference's unused
`_suffix_table` is left out.  Both re-scanning A* searches read the
lattice's `atom_table` and its `suffix_estimate` from here.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

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


class AtomTable(NamedTuple):
    """Every atom of one utterance's trellis, sorted by begin frame
    (stable): the re-scans' candidate lookup and the suffix estimate's
    input."""

    ab: np.ndarray        # begin frames (int64)
    ae: np.ndarray        # end frames (int64)
    am: np.ndarray        # trellis slots (int64)
    aw: np.ndarray        # word ids (int64)
    asc: np.ndarray       # pass-1 cumulative scores (f64)
    alm: np.ndarray       # pass-1 LM portions (f64)
    pscore: np.ndarray    # the predecessors' cumulative scores (0: none)


def atom_table(lat: TrellisLattice) -> AtomTable:
    """The atom table of one utterance's lattice."""
    flat = np.flatnonzero(lat.word >= 0)
    b = lat.begin.reshape(-1)[flat].astype(np.int64)
    order = np.argsort(b, kind="stable")
    idx = flat[order]              # row-major atom ids, by begin frame
    ae, am = np.divmod(idx, lat.M)
    prev = lat.prev.reshape(-1)[idx]
    score = lat.score.reshape(-1)
    return AtomTable(
        ab=b[order], ae=ae, am=am,
        aw=lat.word.reshape(-1)[idx].astype(np.int64),
        asc=score[idx].astype(np.float64),
        alm=lat.lm.reshape(-1)[idx].astype(np.float64),
        pscore=np.where(prev >= 0, score[np.maximum(prev, 0)], 0.0))


def suffix_estimate(ab, ae, inc, T: int, lr: int,
                    fmax: Optional[np.ndarray] = None) -> np.ndarray:
    """The A*'s completion estimate over one utterance's atoms (an
    `AtomTable`'s begin and end frames, `inc` each atom's pass-1
    increment): rest[t] = best pass-1 continuation covering frames
    t+1..T-1, a backward DP whose chain step admits begin frames in
    [t+1-lr, t+1+lr] (the next-word lookup's window, so any anchor the
    search can extend has a finite estimate), every frame of boundary
    slack CHARGED through `fmax`, the frame's best outprob: a late entry
    (gap) adds the skipped frames' fmax — a real path must cover them
    at <= fmax each, so the bound stays admissible — and an early entry
    (overlap) subtracts the doubled frames' fmax.

    This mirrors the reference's completion estimate: the backtrellis
    atom scores it adds to a hypothesis's g[] are pass-1 FULL scores, LM
    included (`search.h` NODE score, ngram_decode.c:334).  Both halves
    of the formula carry a scar.  An AM-only estimate degenerated the
    A* under lm_weight ~8 into breadth-first over the whole envelope
    budget (~13k scans an utterance); AM-only spans with a best-case
    per-word LM bound were ~100+ log points optimistic on DNN configs
    and churned the queue to death (LVCSR 0/32).  Full increments
    without the charge were fine on DNN (positive outprobs make an
    uncovered gap a LOSS) and catastrophic on GMM: at ~-20/frame, +-5
    uncharged slack hands every chain hop up to +100 free log points,
    rest inflates ~+700, and the re-scans churned out empty while the
    reference decoded the same GMM-triphone files exactly.  Full
    increments + slack charge is right for both signs.

    GAP frames charge min(fmax, 0): when outprobs are positive (DNN),
    +fmax per skipped frame is admissible but LOOSE — it re-inflated
    the queue into budget exhaustion (179/179 rounds) the moment the
    charge came back — while 0 is tight and only pessimistic by the
    cover value a real word could actually collect there.  OVERLAP
    frames always subtract full fmax (removes the double count at the
    optimistic rate for both signs)."""
    if fmax is not None:
        cfm = np.concatenate([[0.0], np.cumsum(fmax)])
        cfm0 = np.concatenate([[0.0], np.cumsum(np.minimum(fmax, 0.0))])
    else:
        cfm = cfm0 = np.zeros(T + 1)
    rest = np.full(T + 1, -np.inf)
    rest[T - 1] = 0.0            # nothing left after the final frame
    for t in range(T - 2, -1, -1):
        i0 = np.searchsorted(ab, t + 1 - lr)
        i1 = np.searchsorted(ab, t + 1 + lr, side="right")
        best = -np.inf
        if i1 > i0:
            b = np.clip(ab[i0:i1], 0, T)
            e = ae[i0:i1]
            adj = np.where(b >= t + 1,
                           cfm0[b] - cfm0[t + 1],
                           cfm[b] - cfm[t + 1])
            v = adj + inc[i0:i1] + rest[e]
            v = np.where(e > t, v, -np.inf)
            best = v.max()
        rest[t] = best
    return rest[:T]


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


def pass2_search_backward(
    lattice: TrellisLattice,
    lm: Optional[NGramLM],
    wid2lm: Optional[np.ndarray],
    cfg: SearchConfig,
    tail_word: int,
    head_word: int,
    transparent: Optional[np.ndarray] = None,
) -> List[NBestResult]:
    """Backward stack decoding with a BACKWARD (RL) N-gram — the exact
    shape of the reference's pass 2 (search_bestfirst_main.c:1234
    wchmm_fbs growing hypotheses from the sentence end with the -nrl
    model).  Hypotheses are sentence suffixes; extending with an earlier
    word v scores P_bwd(v | following words), i.e. lm.logprob with the
    following words as context (nearest last, reversed-text
    convention)."""
    T, M = lattice.T, lattice.M
    if T == 0:
        return []
    lw2, pen2 = cfg.lm_weight2, cfg.lm_penalty2

    def lm_logprob(following: Tuple[int, ...], w: int) -> float:
        if lm is None or wid2lm is None:
            return 0.0
        wl = int(wid2lm[w])
        if wl < 0:
            return -99.0
        # context ordered oldest-first in reversed text = farthest
        # following word first
        ctx = []
        need = lm.order - 1
        for f in following[:need][::-1]:
            if wid2lm[f] >= 0:
                ctx.append(int(wid2lm[f]))
        return lm.logprob(tuple(ctx), wl)

    def suffix_ctx(words: Tuple[int, ...]) -> Tuple[int, ...]:
        """Nearest following words first, transparent skipped."""
        out = []
        need = (lm.order - 1) if lm is not None else 1
        for w in words:
            if transparent is not None and transparent[w]:
                continue
            out.append(w)
            if len(out) >= need:
                break
        return tuple(out)

    best_total = float(np.max(np.where(lattice.word >= 0, lattice.score,
                                       -np.inf)))
    if not np.isfinite(best_total):
        return []

    stack: List[Hypo] = []
    # initial: tail-word atoms at the final frame; the suffix LM score
    # P_bwd(</s>) is its unigram
    for (t, m) in lattice.by_end(T - 1):
        w = int(lattice.word[t, m])
        if w != tail_word:
            continue
        am = lattice.am_of(t, m)
        lms = lw2 * lm_logprob((), w) + pen2
        rest = _prefix_estimate(lattice, int(lattice.begin[t, m]))
        heapq.heappush(stack, Hypo(
            score=am + lms + rest, atom=lattice.atom_id(t, m),
            words=(w,), lm_score=lms, am_score=am,
            bounds=((int(lattice.begin[t, m]), t),)))

    results: List[NBestResult] = []
    seen: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    n_pop = 0
    while stack and len(results) < cfg.nbest and n_pop < cfg.max_hypo_pop:
        h = heapq.heappop(stack)
        n_pop += 1
        t, m = divmod(h.atom, M)
        key = (h.atom, suffix_ctx(h.words))
        cnt = seen.get(key, 0)
        if cnt >= cfg.nbest:
            continue
        seen[key] = cnt + 1
        b = int(lattice.begin[t, m])
        exact = h.score - _prefix_estimate(lattice, b)
        if b == 0:
            results.append(NBestResult(
                word_ids=list(reversed(h.words)),
                score=exact,
                am_score=h.am_score, lm_score=h.lm_score,
                bounds=list(reversed(h.bounds))))
            continue
        for (pt, pm) in lattice.by_end(b - 1):
            v = int(lattice.word[pt, pm])
            am = lattice.am_of(pt, pm)
            lms = lw2 * lm_logprob(suffix_ctx(h.words), v) + pen2
            nsc = exact + am + lms
            rest = _prefix_estimate(lattice, int(lattice.begin[pt, pm]))
            if len(stack) >= cfg.stack_size * 4:
                stack.sort()
                del stack[cfg.stack_size:]
                heapq.heapify(stack)
            heapq.heappush(stack, Hypo(
                score=nsc + rest,
                atom=lattice.atom_id(pt, pm),
                words=h.words + (v,),
                lm_score=h.lm_score + lms,
                am_score=h.am_score + am,
                bounds=h.bounds + ((int(lattice.begin[pt, pm]), pt),)))
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


def _prefix_estimate(lattice: TrellisLattice, begin: int) -> float:
    """Pass-1 estimate of the best path covering frames 0..begin-1
    (the reference uses pass-1 backscores the same way): best atom score
    ending at begin-1."""
    if begin <= 0:
        return 0.0
    row = lattice.score[begin - 1]
    valid = lattice.word[begin - 1] >= 0
    if not valid.any():
        return 0.0
    return float(np.max(np.where(valid, row, -np.inf)))


def pass2_search_dfa(
    lattice: TrellisLattice,
    dfa,
    word_cat: np.ndarray,
    cfg: SearchConfig,
) -> List[NBestResult]:
    """A* N-best over the trellis lattice under exact DFA grammar
    acceptance (reference dfa_decode.c dfa_firstwords/dfa_nextwords/
    dfa_acceptable).  The hypothesis state is the reverse-NFA state set
    of the (reversed-convention) .dfa; a sentence is acceptable when the
    set contains an initial state at the final frame."""
    T, M = lattice.T, lattice.M
    if T == 0:
        return []
    pen2 = cfg.lm_penalty2
    best_total = _final_best(lattice)
    if not np.isfinite(best_total):
        return []

    g0 = dfa.accept_start_set()
    step_cache: Dict[Tuple[frozenset, int], frozenset] = {}

    def nfa_step(g: frozenset, cat: int) -> frozenset:
        key = (g, cat)
        out = step_cache.get(key)
        if out is None:
            out = dfa.reverse_nfa_step(g, cat)
            step_cache[key] = out
        return out

    stack: List[Tuple[float, Hypo, frozenset]] = []

    def push(h: Hypo, g: frozenset):
        heapq.heappush(stack, (-h.score, h, g))

    for (t, m) in lattice.by_begin.get(0, []):
        w = int(lattice.word[t, m])
        g = nfa_step(g0, int(word_cat[w]))
        if not g:
            continue
        am = lattice.am_of(t, m)
        sc = am + pen2
        rest = best_total - float(lattice.score[t, m])
        push(Hypo(score=sc + rest, atom=lattice.atom_id(t, m), words=(w,),
                  am_score=am, lm_score=pen2,
                  bounds=((int(lattice.begin[t, m]), t),)), g)

    results: List[NBestResult] = []
    seen: Dict[Tuple[int, frozenset], int] = {}
    n_pop = 0
    while stack and len(results) < cfg.nbest and n_pop < cfg.max_hypo_pop:
        _, h, g = heapq.heappop(stack)
        n_pop += 1
        t, m = divmod(h.atom, M)
        key = (h.atom, g)
        cnt = seen.get(key, 0)
        if cnt >= cfg.nbest:
            continue
        seen[key] = cnt + 1
        exact = h.score - (best_total - float(lattice.score[t, m]))
        if t == T - 1:
            if any(dfa.initial[s] for s in g):
                results.append(NBestResult(
                    word_ids=list(h.words), score=exact,
                    am_score=h.am_score, lm_score=h.lm_score,
                    bounds=list(h.bounds)))
            continue
        for (nt, nm) in lattice.by_begin.get(t + 1, []):
            w = int(lattice.word[nt, nm])
            ng = nfa_step(g, int(word_cat[w]))
            if not ng:
                continue
            am = lattice.am_of(nt, nm)
            nsc = exact + am + pen2
            rest = best_total - float(lattice.score[nt, nm])
            push(Hypo(score=nsc + rest,
                      atom=lattice.atom_id(nt, nm),
                      words=h.words + (w,),
                      am_score=h.am_score + am,
                      lm_score=h.lm_score + pen2,
                      bounds=h.bounds + ((int(lattice.begin[nt, nm]), nt),)),
                 ng)
    results.sort(key=lambda r: -r.score)
    return results


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
