"""Pass-2 A* stack decoding with the whole search state on the device.

Port of `julius_tpu/search/pass2_device.py`.  The host-driven re-scan
A* (`pass2_rescan.py`) pays one host round trip per batched round plus
Python bookkeeping per expansion.  This module keeps the WHOLE second
pass - stack, pops, word re-scans, LM probes, pushes, N-best
termination - in device tensors.  The reference runs its rounds inside
one jitted `lax.while_loop`; here one round is `_Rounds.step` over
fixed tensors, gated on the device by the loop's condition so that a
round past the end changes nothing.  On a CUDA card the round is
captured once as a CUDA graph (`GraphCache` on the chain tables) and
replayed, the host reading the stop flag once every STOP_EVERY
replays; on the CPU, and with `eager=True`, the same step runs once a
round from Python.

Algorithmically this is the reference's stack decoder with the
scan-at-pop structure of `search_bestfirst_main.c:787` (wchmm_fbs):

* a stack entry is a sentence prefix whose LAST word has not yet been
  acoustically re-scanned; its priority is the parent's exact g at the
  word's trellis begin + the pass-2 LM add + the word's pass-1 AM span
  score + the pass-1 suffix estimate (the reference pushes NEXTWORD
  candidates scored from the backtrellis the same way,
  `ngram_decode.c:566` ngram_nextwords + `search.h` NODE score);
* popping an entry runs the seeded word Viterbi against the outprob
  cache (`search_bestfirst_v1.c:589` scan_word; `ops/scan_kernel.py` -
  one launch of the scan kernel advances all B*P popped words), which re-derives
  the exact score and refined boundary; the exact g row is stored so
  every descendant seeds from it.  The pop is LAZY (deferred-evaluation
  A*): a freshly scanned entry is re-pushed with its exact priority
  FANNED OUT over the top A_RP boundary anchors of its own g+rest
  curve (one scan serves all of a word's boundary variants — the
  host's sibling-anchor merge, and the reason fresh entries recombine
  per (word, prev) regardless of pass-1 anchor), and only expands on a
  later pop, so expansion order and the N-best termination test run on
  exact scores — estimates only order the queue;
* next-word candidates come from trellis atoms whose begin frame falls
  within +-lookup_range of the boundary (`ngram_decode.c:428`), the
  stack keeps the best `4 * stack_size` anchor-variant entries (-s),
  and a hypothesis completes when the sentence-tail word is popped at
  the final frame with nothing on the stack estimating above the
  n-best-th completion (`search_bestfirst_main.c:1645`).

Differences from the host path, chosen for device-shaped execution:

* duplicate suppression is a keep-best merge over the (last word,
  boundary anchor, previous word) class at every push — (word, prev)
  for unscanned entries — instead of the host's pop-time `seen` map:
  for a 2-gram LM that class captures the LM context exactly, so the
  merge is the reference's hypothesis recombination done eagerly;
  already-scanned (exact-priority) entries may only be evicted by
  other exact entries, never by estimate-priority ones;
* the word envelope (-b2 wb_ok) admits `word_envelope` distinct word
  SEQUENCES per hypothesis length (rolling sequence hash);
* strict inter-word CD heads (v2) substitute the popped word's head
  columns by its previous word's left-context class
  (iwcd2.StrictIWCDTables), as the host re-scan does;
* the host-only semantics (order > 2 LMs, transparent words,
  `nbest > NB_SLOTS`) take the host path (`engine._device_astar_ok`).

Translation rules from the reference, each held by a CPU parity test:
`lax.top_k` and `approx_max_k` become a stable descending sort sliced
(ties to the lowest index), uint32 hashes run in int64 masked to 32
bits (`ngram_device._mul_u32`), `.at[].max` / `.at[].add` become
`scatter_reduce(amax)` / `scatter_add_` (duplicate keys are the normal
case), the vmapped `searchsorted` a batched `torch.searchsorted`, and
the [K, W, N] one-hot product that fetched the outprob window a gather
fused into the scan kernel.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.ops import scan_kernel as sk
from julius_tpu_torch.ops import suffix_kernel
from julius_tpu_torch.ops.scan_kernel import scan_core_win
from julius_tpu_torch.search.ngram_device import (U32, DeviceNgram,
                                                  _mul_u32, bigram_score)
from julius_tpu_torch.search.pass1 import Trellis, _capture, topk_stable
from julius_tpu_torch.search.pass2 import (NBestResult, TrellisLattice,
                                          atom_table)
from julius_tpu_torch.search.scan import (DeviceChainTables,
                                          head_substituted_sidx)
from julius_tpu_torch.utils import trace
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
NEG_INF = float("-inf")

#: hypotheses popped per utterance per round: POPS over trellises of
#: fewer than WIDE_M word ends a frame, WIDE_POPS from there.  The
#: suffix estimate charges each later word the pass-1 LM of pass 1's own
#: predecessor, so where pass 1 followed a confusable word the true next
#: word's entry is underestimated by that LM difference and enters the
#: stack at ranks 8-24; at 8 pops the wrong path completes first and the
#: stop test (nothing on the stack above the result) ends the search.
#: Measured at M = 128 only, the 20k-word configuration: 8 pops lost 7
#: of 672 searches that the host re-scan won, 32 none of 2848, in the
#: same time a batch (PERF.md §6)
POPS = 8
WIDE_M = 128
WIDE_POPS = 32
#: candidate-table prune (prepare): anchor end-frames kept per
#: (begin, word) pair (the host's A_CAND analogue) ...
A_ENDS = 16
#: ... and atoms kept per begin frame overall — the candidate window
#: then holds at most (2*lookup_range+1) * Q_PER_FRAME atoms, which
#: sizes the round body's contiguous CA slice for COMPLETE coverage
Q_PER_FRAME = 96
#: children kept per pop after ranking (MAX_NEXT_WORDS-analogue)
CHILD_KEEP = 64
#: boundary anchors fanned out per scanned word (re-push slots; the
#: host's MAX_ANCHORS analogue, taken from the scan's own g+rest
#: peaks instead of pass-1 atom ends)
A_RP = 4
#: scan window frames per pop (words span tens of frames; utterances
#: hundreds — the scan only needs [anchor - (SCAN_WIN - WIN_TAIL),
#: anchor + WIN_TAIL).  Must exceed the longest plausible word span
#: plus boundary slack; entries earlier than the window are lost,
#: which only matters for words longer than ~SCAN_WIN - WIN_TAIL
#: frames (none in any tested config)
SCAN_WIN = 160
WIN_TAIL = 24
#: completion slots tracked per utterance (host filters to nbest)
NB_SLOTS = 8

#: search statistics of the last run_batch dispatch (profiling)
LAST_STATS: dict = {}
#: g/beg-store budget (MB) at POPS a round, bounding the rounds
MEM_MB = 384
#: rounds the card replays between two host reads of the stop flag: 1,
#: by measurement on the H100 (PERF.md §6) a host read costs less
#: than the round past the end that a larger value may run
STOP_EVERY = 1
#: captured rounds kept per set of chain tables; each holds its own
#: g/beg stores (up to MEM_MB x P / POPS) and a copy of its batch's
#: outprob cache
GRAPHS_KEPT = 3


@dataclass
class _Prepared:
    """Host-built per-batch inputs for the device A*."""

    ab: np.ndarray        # [B, NA] atom begin frames (sorted per utt)
    ae: np.ndarray        # [B, NA] atom end frames
    aw: np.ndarray        # [B, NA] atom word ids
    ainc: np.ndarray      # [B, NA] atom pass-1 AM span score
    rest: np.ndarray      # [B, T] suffix estimate (LOG_ZERO = dead)
    last: np.ndarray      # [B] final frame per utt (-1 = skip)
    packed: np.ndarray    # [B, NA, 6] per-atom candidate columns
    stack0: Tuple[np.ndarray, ...]   # initial stack field arrays


def _best_path_rest(lat: TrellisLattice,
                    ratio: float) -> Optional[np.ndarray]:
    """Suffix-score curve of pass-1's best path: rest1[t] = (path
    total) - (path cumulative through frame t), linearly interpolated
    inside word spans, with each word's pass-1 LM portion re-weighted
    by `ratio` (`_lm_ratio`).  The best path tiles every frame, so this
    estimate is finite everywhere and achievable by construction."""
    T, M = lat.T, lat.M
    row_s = np.where(lat.word[T - 1] >= 0, lat.score[T - 1], -np.inf)
    if not np.isfinite(row_s).any():
        return None
    m = int(np.argmax(row_s))
    ends, cums = [], []
    a = (T - 1) * M + m
    raw = []
    while a >= 0:
        t, mm = divmod(a, M)
        raw.append((t, float(lat.score[t, mm]), float(lat.lm[t, mm])))
        a = int(lat.prev[t, mm])
    raw.reverse()
    cum = 0.0
    prev_raw = 0.0
    for (t, c, l) in raw:
        inc = c - prev_raw
        prev_raw = c
        cum += inc + l * (ratio - 1.0)
        ends.append(t)
        cums.append(cum)
    total = cums[-1]
    xp = np.asarray([-1] + ends, dtype=np.float64)
    fp = np.asarray([0.0] + cums)
    cum_at = np.interp(np.arange(T), xp, fp)
    return (total - cum_at).astype(np.float64)


def _best_lm_in(strategy, n_words: int) -> np.ndarray:
    """best_in[w] = an upper bound on log10 P(w | any context) under
    the strategy's N-gram: max of the best bigram into w and the
    unigram+best-back-off path.  Used to make the suffix estimate's
    per-word LM charge optimistic — pass-1 atoms record the LM of
    pass-1's OWN best predecessor, and inheriting that (often back-off)
    cost makes the estimate pessimistic exactly on the paths whose
    context pass 2 is supposed to fix, burying them below junk and
    burning the word envelope before they pop."""
    lm = getattr(strategy, "lm", None)
    wid2lm = getattr(strategy, "wid2lm", None)
    if wid2lm is not None:
        n_words = max(n_words, len(wid2lm))
    out = np.full(n_words, -99.0, np.float64)
    if lm is None or wid2lm is None:
        return out
    Vl = len(lm.words)
    uni = np.full(Vl, -99.0)
    bo = np.zeros(Vl)
    for (i,), (lp, b) in lm.ngrams[0].items():
        uni[i] = lp
        bo[i] = b
    best_bi = np.full(Vl, -np.inf)
    if lm.order >= 2:
        for (v, w), (lp, _b) in lm.ngrams[1].items():
            if lp > best_bi[w]:
                best_bi[w] = lp
    max_bo = max(0.0, bo.max()) if Vl else 0.0
    best = np.maximum(uni + max_bo, best_bi)
    wl = np.asarray(wid2lm)
    okm = wl >= 0
    out[:len(wl)][okm] = best[np.clip(wl, 0, Vl - 1)][okm]
    return out


def _lm_ratio(cfg: SearchConfig) -> float:
    """lm_weight2 / lm_weight (1 without a pass-1 weight): the factor
    that moves a pass-1 LM score into the pass-2 scale."""
    lw1 = float(cfg.lm_weight)
    return (float(cfg.lm_weight2) / lw1) if lw1 else 1.0


def _suffix_launch(lattices: List[Optional[TrellisLattice]], T: int,
                  trellis, fmax: Optional[torch.Tensor], cfg: SearchConfig
                  ) -> torch.Tensor:
    """Start the batch's suffix estimate on fmax's device (one kernel
    launch on a card, the plain version on the CPU): [B, T] f64 there,
    to read once it ends; over `trellis`, the [B, T, M] pass-1 trellis
    there, else the lattices' rows uploaded.  Each atom's LM portion is
    re-weighted into the PASS-2 scale (lw2/lw1, as in _best_path_rest):
    exact scores accumulate lm_weight2-weighted probs, so without it the
    estimate is off by (lw2-lw1)*|log p| a remaining word whenever the
    passes weigh the LM differently (-lmp vs -lmp2)."""
    if trellis is None:
        B = len(lattices)
        M = next(lat.M for lat in lattices if lat is not None)
        rows = [np.full((B, T, M), -1, np.int32)] + [
            np.zeros((B, T, M), dt)
            for dt in (np.float32, np.float32, np.int32, np.int32)]
        for b, lat in enumerate(lattices):
            if lat is not None:
                for a, x in zip(rows, (lat.word, lat.score, lat.lm,
                                       lat.prev, lat.begin)):
                    a[b, :lat.T] = x
        dev = fmax.device if fmax is not None else torch.device("cpu")
        trellis = Trellis(*[torch.from_numpy(a).to(dev) for a in rows],
                          None)
    n = [0 if lat is None else lat.T for lat in lattices]
    return suffix_kernel.suffix(trellis, n, fmax,
                                max(0, int(cfg.lookup_range)),
                                _lm_ratio(cfg))


def _lm_opt(aw, cfg: SearchConfig, cprob_np: Optional[np.ndarray],
            best_in: np.ndarray) -> np.ndarray:
    """The optimistic pass-2 LM add of each word id in `aw`: its best
    LM probability into it from any context (`best_in`), weighted, with
    the penalty and the class probability."""
    return (float(cfg.lm_weight2) * best_in[np.minimum(aw, len(best_in) - 1)]
            + float(cfg.lm_penalty2)
            + (cprob_np[np.minimum(aw, len(cprob_np) - 1)]
               if cprob_np is not None else 0.0))


def _prune(ab, ae, aw, ainc, rest, strategy, cfg: SearchConfig,
           cprob_np: Optional[np.ndarray], best_in: np.ndarray):
    """Prune one utterance's CANDIDATE table (the suffix DP used the
    FULL atom set): the kept (begin, end, word, AM span) columns.

    Within one begin frame the candidate ranking is parent-independent —
    est0 = gb(begin) + (lm_opt + AM span + rest[end]) and gb depends only
    on the begin — so keeping the top Q_PER_FRAME atoms per begin frame
    provably preserves every window's true top-CHILD_KEEP children, and
    bounds the window population to (2lr+1)*Q so the contiguous CA slice
    in the round body never overflows.  (Round 4 sliced a fixed 768
    atoms out of windows holding 1500+; whole words silently vanished
    from the candidate set — the LVCSR truth path among them.)
    Tail-word atoms bypass the cap: completion anchors must survive (the
    host appends the Tl-1 anchor for may_final words the same way,
    _cand_for)."""
    lm_opt_at = _lm_opt(aw, cfg, cprob_np, best_in)
    rest_ae = rest[np.minimum(ae, len(rest) - 1)]
    indep = np.where(np.isfinite(rest_ae),
                     ainc + lm_opt_at + rest_ae, -np.inf)
    is_tail = aw == int(strategy.tail_word)
    n_at = len(ab)
    pos = np.arange(n_at)
    # rank within (begin, word) groups, best-indep first
    o2 = np.lexsort((-indep, aw, ab))
    newg = np.r_[True, (ab[o2][1:] != ab[o2][:-1])
                 | (aw[o2][1:] != aw[o2][:-1])]
    rank_bw = pos - np.maximum.accumulate(np.where(newg, pos, 0))
    keep = np.zeros(n_at, bool)
    keep[o2] = rank_bw < A_ENDS
    # rank within begin frames among survivors
    ind2 = np.where(keep, indep, -np.inf)
    o3 = np.lexsort((-ind2, ab))
    newb = np.r_[True, ab[o3][1:] != ab[o3][:-1]]
    rank_b = pos - np.maximum.accumulate(np.where(newb, pos, 0))
    keep2 = np.zeros(n_at, bool)
    keep2[o3] = rank_b < Q_PER_FRAME
    keep &= keep2 | is_tail
    keep &= np.isfinite(indep) | is_tail
    return ab[keep], ae[keep], aw[keep], ainc[keep]


def prepare(lattices: List[Optional[TrellisLattice]], T: int,
            strategy, cfg: SearchConfig, stack_size: int,
            cprob_np: Optional[np.ndarray], best_in: np.ndarray,
            fmax: Optional[torch.Tensor] = None, trellis=None) -> _Prepared:
    """Build the per-batch atom tables, suffix estimates, and initial
    stacks (sentence-head candidates at frame 0, reference
    get_backtrellis_words' first-word seeding, ngram_decode.c:334).

    `fmax` is the [B, T] f32 frames' best outprob on the batch's device
    (None: no slack charge).  The atom-chain suffix DP runs on that
    device (`_suffix_launch`) over `trellis`, the batch's [B, T, M]
    pass-1 trellis there (the lattices' rows uploaded where None), while
    the host builds the atom tables and the best-path curves; the
    estimates are read back in one copy before the prunes."""
    lattices = [lat if lat is not None and lat.T else None
                for lat in lattices]
    per = [None] * len(lattices)
    tables = []           # (utterance, atom table, best-path curve)
    if any(lat is not None for lat in lattices):
        with trace.span("prepare.suffix"):
            rest_dev = _suffix_launch(lattices, T, trellis, fmax, cfg)
    for b, lat in enumerate(lattices):
        if lat is None:
            continue
        a = atom_table(lat)
        # AM-only span score of the atom's word (pass-1 LM removed):
        # a CANDIDATE's estimate adds its exact pass-2 LM instead
        ainc = a.asc - a.pscore - a.alm
        with trace.span("prepare.suffix"):
            # anchor the estimate on pass-1's own best path: a REAL path
            # covering every frame, so its suffix curve has no holes and
            # no compounding per-word bounds — the atom-chain DP can
            # only raise it where a better continuation provably exists.
            # (LM portions re-weighted into the pass-2 scale.)
            r1 = _best_path_rest(lat, _lm_ratio(cfg))
        tables.append((b, (a.ab, a.ae, a.aw, ainc), r1))
    if tables:
        with trace.span("prepare.suffix"):
            rest_all = rest_dev.cpu().numpy()
            rests = {}
            for b, _, r1 in tables:
                rest = rest_all[b, :lattices[b].T]
                rests[b] = rest if r1 is None else np.maximum(rest, r1)
    for b, table, _ in tables:
        with trace.span("prepare.prune"):
            per[b] = (*_prune(*table, rests[b], strategy, cfg, cprob_np,
                              best_in), rests[b])
    na = max([1] + [len(p[0]) for p in per if p is not None])
    with trace.span("prepare.seed"):
        return _seed(lattices, per, na, T, strategy, cfg, stack_size,
                     cprob_np, best_in)


def _seed(lattices, per, na: int, T: int, strategy, cfg: SearchConfig,
          stack_size: int, cprob_np: Optional[np.ndarray],
          best_in: np.ndarray) -> _Prepared:
    """`prepare`'s tables from each utterance's kept atoms and suffix
    estimate (`per`): padded to `na` atoms and T frames, the initial
    stacks seeded from the atoms that begin at frame 0, and the packed
    candidate columns."""
    B = len(lattices)
    ab_a = np.full((B, na), 1 << 30, np.int32)
    ae_a = np.zeros((B, na), np.int32)
    aw_a = np.zeros((B, na), np.int32)
    ainc_a = np.full((B, na), LOG_ZERO, np.float32)
    rest_a = np.full((B, T), LOG_ZERO, np.float32)
    last_a = np.full(B, -1, np.int32)
    S = stack_size
    s_prio = np.full((B, S), NEG_INF, np.float32)
    s_w = np.zeros((B, S), np.int32)
    s_t = np.zeros((B, S), np.int32)
    s_prev = np.full((B, S), -1, np.int32)
    s_parent = np.full((B, S), -1, np.int32)
    s_lm_add = np.zeros((B, S), np.float32)
    s_lm_sum = np.zeros((B, S), np.float32)
    s_row = np.full((B, S), -1, np.int32)
    s_len = np.ones((B, S), np.int32)
    s_seqh = np.zeros((B, S), np.uint32)
    for bidx, (lat, p) in enumerate(zip(lattices, per)):
        if p is None:
            continue
        ab, ae, aw, ainc, rest = p
        n = len(ab)
        ab_a[bidx, :n] = ab
        ae_a[bidx, :n] = ae
        aw_a[bidx, :n] = aw
        ainc_a[bidx, :n] = ainc
        rest_a[bidx, :lat.T] = np.where(np.isfinite(rest), rest, LOG_ZERO)
        last_a[bidx] = lat.T - 1
        # initial candidates: atoms beginning at frame 0 (lr = 0 for
        # the sentence-initial lookup), deduped (word, end) best-first
        i1 = np.searchsorted(ab, 0, side="right")
        if i1 == 0:
            last_a[bidx] = -1
            continue
        w0, e0, inc0 = aw[:i1], ae[:i1], ainc[:i1]
        r0 = rest[e0]
        lm0 = np.array([strategy.lm_add((), int(w)) for w in w0],
                       np.float64)
        est = lm0 + inc0 + r0
        est = np.where(np.isfinite(est), est, NEG_INF)
        key = w0 * (T + 1) + e0
        order = np.lexsort((-est, key))
        keep = np.r_[True, key[order][1:] != key[order][:-1]]
        sel = order[keep]
        sel = sel[np.argsort(-est[sel], kind="stable")][:S]
        n0 = len(sel)
        s_prio[bidx, :n0] = est[sel]
        s_w[bidx, :n0] = w0[sel]
        s_t[bidx, :n0] = e0[sel]
        s_lm_add[bidx, :n0] = lm0[sel]
        s_lm_sum[bidx, :n0] = lm0[sel]
        w_sel = torch.from_numpy(w0[sel])
        s_seqh[bidx, :n0] = _seq_mix(torch.zeros_like(w_sel), w_sel).numpy()
    # per-atom packed columns (the device candidate block fetches them
    # as one contiguous slice per pop): begin, end, word, AM span,
    # rest[end], and the optimistic LM add for the word — the latter
    # two precomputed here so the round body never random-gathers them
    lm_opt_a = _lm_opt(aw_a, cfg, cprob_np, best_in)
    rest_ae = np.take_along_axis(
        rest_a, np.minimum(ae_a, rest_a.shape[1] - 1), axis=1)
    packed = np.stack(
        [ab_a.astype(np.float32), ae_a.astype(np.float32),
         aw_a.astype(np.float32), ainc_a.astype(np.float32),
         rest_ae.astype(np.float32), lm_opt_a.astype(np.float32)],
        axis=2)
    return _Prepared(
        ab=ab_a, ae=ae_a, aw=aw_a, ainc=ainc_a, rest=rest_a, last=last_a,
        packed=packed,
        stack0=(s_prio, s_w, s_t, s_prev, s_parent, s_lm_add, s_lm_sum,
                s_row, s_len, s_seqh))


#: word-envelope hash slots, recombination hash slots and envelope
#: lengths per utterance
ENV_H = 8192
DH = 1 << 14
LEN_CAP = 128


def _seq_mix(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rolling word-sequence hash h * 1000003 + w + 1 in uint32 (held in
    int64 in [0, 2^32)): sequence identity for completion dedup and the
    word envelope; anchor variants of one sequence share it, distinct
    sequences collide with ~2^-32 probability."""
    return (_mul_u32(h, 1000003) + w + 1) & U32


def _env_key(seqh: torch.Tensor) -> torch.Tensor:
    """Word-envelope slot of a sequence hash: (h * 2654435761) mod 2^32
    mod ENV_H."""
    return _mul_u32(seqh, 2654435761) % ENV_H


def _recomb_keys(key: torch.Tensor, w: torch.Tensor, prev: torch.Tensor):
    """Recombination slots of (key, prev) and (word, prev), the uint32
    casts of the int32 ids included (-1 -> 2^32 - 1)."""
    prev_u = prev & U32
    k1 = (_mul_u32(key & U32, 2654435761)
          ^ _mul_u32(prev_u, 2246822519)) % DH
    k2 = (_mul_u32(w & U32, 40503) ^ _mul_u32(prev_u, 2654435761)) % DH
    return k1, k2


class _Dims(NamedTuple):
    """What fixes one batch's A* program: its shapes and static values
    (the reference's jit static arguments and traced shapes)."""

    B: int
    T: int
    R: int
    NA: int
    P: int
    S: int
    CA: int
    CK: int
    CAPP: int
    max_rounds: int
    lr: int
    tail: int
    nbest: int
    lw2: float
    pen2: float
    wb: int


class _Inputs(NamedTuple):
    """One batch's inputs to the rounds, on the device."""

    out_ext: torch.Tensor   # [B, T, R] f32 outprob cache
    wid2lm: torch.Tensor    # [V+1] i64 word -> LM id (-1 none)
    cprobv: torch.Tensor    # [V+1] f32 class probability add
    ab: torch.Tensor        # [B, NA] i64 atom begin frames
    packed: torch.Tensor    # [B, NA, 6] f32 per-atom candidate columns
    rest: torch.Tensor      # [B, T] f32 suffix estimate
    cfm: torch.Tensor       # [B, T+1] f32 cumulative frame maxima
    last: torch.Tensor      # [B] i64 final frame (-1 = skip)
    stack: Tuple[torch.Tensor, ...]   # initial stack fields [B, S]


class _Rounds:
    """The whole batched A* over fixed tensors: the inputs, the stack,
    the g/beg stores, the arena, the results, the envelope counters,
    `n_pops`, `active` and a [1] round counter.  `step` is one round
    under the reference's `cond` (some utterance active and fewer than
    max_rounds run), computed on the device as `go`: with `go` false it
    changes nothing, so replaying it past the end is exact.  It writes
    everything back in place, so a CUDA graph of it replays the loop.
    `more` holds `cond` of the current state; the host reads it to stop.
    `iwcd2` (search.iwcd2.StrictIWCDTables) turns on strict inter-word
    CD heads."""

    def __init__(self, tabs: DeviceChainTables, ng: DeviceNgram, iwcd2,
                 d: _Dims, x: _Inputs):
        self.tabs, self.ng, self.iwcd2, self.d = tabs, ng, iwcd2, d
        dev = x.out_ext.device
        B, T, P, CAPP = d.B, d.T, d.P, d.CAPP
        f32, i64 = torch.float32, torch.int64

        def new(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        self.x = _Inputs(*[torch.empty_like(a) for a in x[:-1]],
                         tuple(torch.empty_like(a) for a in x.stack))
        self.stack = self.x.stack
        self.g_store = new((B * CAPP, T), f32)
        self.beg_store = new((B * CAPP, T), torch.int32)
        self.arena_w = new((B, CAPP), i64)
        self.arena_t = new((B, CAPP), i64)
        self.arena_parent = new((B, CAPP), i64)
        self.arena_lm_sum = new((B, CAPP), f32)
        self.res_score = new((B, NB_SLOTS), f32)
        self.res_arena = new((B, NB_SLOTS), i64)
        self.res_seqh = new((B, NB_SLOTS), i64)
        self.n_pops = new(B, i64)
        self.active = new(B, torch.bool)
        self.env_cnt = new((B, LEN_CAP), i64)
        self.env_seen = new((B, ENV_H), i64)
        self.round_i = new(1, i64)
        self.more = new(1, torch.bool)
        self.bvec = torch.arange(B, device=dev)
        self.bidx = self.bvec[:, None].expand(B, P).reshape(B * P).to(
            torch.int32)
        self.arP = torch.arange(P, device=dev)

    def load(self, x: _Inputs) -> None:
        """Start a batch: copy its inputs in and reset the state."""
        for buf, a in zip((*self.x[:-1], *self.stack), (*x[:-1], *x.stack)):
            buf.copy_(a)
        self.g_store.fill_(LOG_ZERO)
        self.beg_store.zero_()
        self.arena_w.fill_(-1)
        self.arena_t.zero_()
        self.arena_parent.fill_(-1)
        self.arena_lm_sum.zero_()
        self.res_score.fill_(NEG_INF)
        self.res_arena.fill_(-1)
        self.res_seqh.zero_()
        self.n_pops.zero_()
        self.active.copy_(self.x.last >= 0)
        self.env_cnt.zero_()
        self.env_seen.zero_()
        self.round_i.zero_()
        self.more.copy_(self._cond())

    def _cond(self) -> torch.Tensor:
        return self.active.any() & (self.round_i < self.d.max_rounds)

    def step(self) -> None:
        """One round (the reference's `body`), gated by `go`."""
        d, tabs, x = self.d, self.tabs, self.x
        B, P, T, CAPP, lr, tail = d.B, d.P, d.T, d.CAPP, d.lr, d.tail
        dev = x.out_ext.device
        K = B * P
        V_dead = tabs.loc.shape[0] - 1
        f32, i64 = torch.float32, torch.int64
        bvec, arP = self.bvec, self.arP
        W = min(SCAN_WIN, T)
        W11 = 2 * lr + 1
        rest, cfm, last = x.rest, x.cfm, x.last
        g_store = self.g_store
        go = self._cond()                                        # [1]
        # a gated-off round pops nothing: no utterance is valid in it
        act = self.active & go
        (s_prio, s_w, s_t, s_prev, s_parent, s_lm_add, s_lm_sum, s_row, s_len,
         s_seqh) = self.stack

        # ---- pop the top P entries of every active utterance
        pprio, pop_idx = topk_stable(s_prio, P)
        pw, pt, pprev, pparent, plm_add, plm_sum, prow_own, plen, pseqh = (
            a.gather(1, pop_idx) for a in (s_w, s_t, s_prev, s_parent,
                                           s_lm_add, s_lm_sum, s_row, s_len,
                                           s_seqh))
        s_prio = s_prio.scatter(1, pop_idx, NEG_INF)
        valid = (pprio > NEG_HALF) & act[:, None]
        scanned = valid & (prow_own >= 0)
        fresh = valid & (prow_own < 0)
        # envelope class = the word SEQUENCE (rolling hash); fresh pops
        # of a full, never-admitted sequence are killed before their scan
        lidx = plen.clamp(0, LEN_CAP - 1)
        ekey = _env_key(pseqh)
        eseen = self.env_seen.gather(1, ekey) > 0
        env_ok = eseen | (self.env_cnt.gather(1, lidx) < d.wb)
        fresh = fresh & (env_ok | (pw == tail))

        # ---- arena slots for this round (one row per pop slot); the
        # clamp keeps a gated-off round's slots inside the arena
        base = self.round_i.clamp(max=d.max_rounds - 1) * P       # [1]
        aidx = base + arP                                        # [P]
        rows = (bvec[:, None] * CAPP + aidx).reshape(K)

        # ---- scan-at-(first-)pop, windowed to SCAN_WIN frames ending a
        # little past the entry's anchor (scanned re-pops ride a dead
        # chain); sentence-initial entries include frame 0
        wids = torch.where(fresh, pw, V_dead).reshape(K)
        has_parent = (pparent >= 0).reshape(K)
        prow = torch.where(pparent >= 0, bvec[:, None] * CAPP + pparent,
                           0).reshape(K)
        w0 = (pt.reshape(K) - (W - WIN_TAIL)).clamp(0, max(T - W, 0))
        w0 = torch.where(has_parent, w0, 0)
        idx_t = w0[:, None] + torch.arange(W, device=dev)        # [K, W]
        lm_k = plm_add.reshape(K)[:, None]
        pgw = g_store[prow[:, None], (idx_t - 1).clamp(min=0)]
        ext_seed = torch.where(idx_t >= 1, pgw, LOG_ZERO) + lm_k
        init_seed = torch.where(idx_t == 0, lm_k, LOG_ZERO)
        seed_w = torch.where(has_parent[:, None], ext_seed, init_seed)
        sidx_k = tabs.sidx[wids]
        if self.iwcd2 is not None:
            # strict inter-word CD (PASS2_STRICT_IWCD,
            # search_bestfirst_v2.c:911): the word-head states read the
            # EXACT left-context triphone of the popped entry's previous
            # word; class 0 (no previous word / no exact model) keeps the
            # v1 pseudo columns (outprob_style.c lcdset fallback)
            iw = self.iwcd2
            lc = torch.where(pprev >= 0,
                             iw.lc_of_word_dev[pprev.clamp(min=0)], 0)
            sidx_k = head_substituted_sidx(sidx_k, wids, lc.reshape(K),
                                           iw.head_sidx, iw.head_ns)
        g_w, beg_w, _ = scan_core_win(
            tabs.loc[wids], tabs.ent[wids], tabs.ext[wids], sidx_k,
            seed_w, x.out_ext, self.bidx, w0.to(torch.int32))
        g = torch.full((K, T), LOG_ZERO, dtype=f32, device=dev)
        g.scatter_(1, idx_t, g_w)
        beg = torch.zeros((K, T), dtype=torch.int32, device=dev)
        beg.scatter_(1, idx_t, beg_w)
        for store, new in ((g_store, g), (self.beg_store, beg)):
            store.index_copy_(0, rows, torch.where(
                go[:, None], new, store.index_select(0, rows)))
        gBPT = g.reshape(B, P, T)
        exact = gBPT.gather(2, pt[..., None])[..., 0]            # [B, P]

        # ---- arena append (fresh pops only carry a word)
        for buf, new in ((self.arena_w, torch.where(fresh, pw, -1)),
                         (self.arena_t, pt), (self.arena_parent, pparent),
                         (self.arena_lm_sum, plm_sum)):
            buf.index_copy_(1, aidx, torch.where(
                go, new, buf.index_select(1, aidx)))

        # ---- completions: tail word first-popped at the final frame;
        # a sequence already recorded (or recorded by a lower pop slot
        # this round) is a boundary variant, not a new sentence
        res_score, res_arena, res_seqh = (self.res_score, self.res_arena,
                                          self.res_seqh)
        is_final = (fresh & (pw == tail) & (pt == last[:, None])
                    & (exact > NEG_HALF))
        comp_s = torch.where(is_final, exact, NEG_INF)
        dup_prev = ((pseqh[:, :, None] == res_seqh[:, None, :])
                    & (res_score[:, None, :] > NEG_HALF)).any(dim=2)
        tri = arP[:, None] > arP[None, :]                        # [P, P]
        dup_self = ((pseqh[:, :, None] == pseqh[:, None, :])
                    & is_final[:, None, :] & tri).any(dim=2)
        comp_s = torch.where(dup_prev | dup_self, NEG_INF, comp_s)
        rs2 = torch.cat([res_score, comp_s], dim=1)
        ra2 = torch.cat([res_arena, aidx.expand(B, P)], dim=1)
        rh2 = torch.cat([res_seqh, pseqh], dim=1)
        order_r = torch.argsort(-rs2, dim=1, stable=True)[:, :NB_SLOTS]
        res_score, res_arena, res_seqh = (
            a.gather(1, order_r) for a in (rs2, ra2, rh2))

        # ---- lazy A* re-push with anchor fan-out: a fresh non-final pop
        # goes back on the stack at the top A_RP local maxima (+-2 frames)
        # of its own exact g + rest curve
        live = (gBPT > NEG_HALF) & (rest[:, None, :] > NEG_HALF)
        gr = torch.where(live, gBPT + rest[:, None, :], NEG_INF)
        grp = gr
        for dd in (1, 2):
            grp = torch.maximum(grp, torch.maximum(
                F.pad(gr[:, :, dd:], (0, dd), value=NEG_INF),
                F.pad(gr[:, :, :-dd], (dd, 0), value=NEG_INF)))
        gr_lm = torch.where(gr >= grp, gr, NEG_INF)
        rp_prio, rp_t = topk_stable(gr_lm, A_RP)                 # [B,P,A]
        repush = (fresh & ~is_final & (exact > NEG_HALF))[..., None]
        r_prio = torch.where(repush & (rp_prio > NEG_HALF), rp_prio,
                             NEG_INF).reshape(B, P * A_RP)
        r_t = rp_t.reshape(B, P * A_RP)
        # each pop's fields repeated A_RP times in place (a
        # repeat_interleave whose output size needs no host read)
        r_w, r_prev, r_parent, r_lm_add, r_lm_sum, r_row, r_len, r_seqh = (
            a[..., None].expand(B, P, A_RP).reshape(B, P * A_RP)
            for a in (pw, pprev, pparent, plm_add, plm_sum,
                      aidx.expand(B, P), plen, pseqh))

        # ---- next-word candidates for SCANNED pops: trellis atoms whose
        # begin falls in +-lr of the boundary (ngram_decode.c:428); the
        # word envelope charges each new (length, sequence) class once
        tau = pt + 1                                             # [B, P]
        expandable = scanned & (pw != tail) & env_ok
        newclass = expandable & ~eseen
        env_cnt = self.env_cnt.scatter_add(1, lidx, newclass.to(i64))
        env_seen = self.env_seen.scatter_reduce(
            1, ekey, expandable.to(i64), reduce="amax", include_self=True)
        NA, CA, CK = d.NA, d.CA, d.CK
        i0 = torch.searchsorted(x.ab, tau - lr, right=False)     # [B, P]
        idx = (i0.clamp(max=NA - CA).clamp(min=0)[..., None]
               + torch.arange(CA, device=dev))                   # [B,P,CA]
        inb = idx < NA
        packed = x.packed[bvec[:, None, None], idx]           # [B,P,CA,6]
        cb = packed[..., 0].to(i64)
        ce = packed[..., 1].to(i64)
        cw = packed[..., 2].to(i64)
        cinc = packed[..., 3]
        rest_e = packed[..., 4]
        lm_opt_c = packed[..., 5]
        ok = (inb & expandable[..., None]
              & (cb <= (tau + lr)[..., None])
              & (ce >= tau[..., None]) & (cb >= 1))
        # a tail-word child is only useful anchored at the final frame;
        # a non-tail child at the final frame is dead weight
        last_c = last[:, None, None].expand_as(ce)
        ce = torch.where(cw == tail, last_c, ce)
        ok = ok & ((cw == tail) | (ce != last_c))
        # entry bound: max over entry frames t' in +-lr of the atom's
        # begin of g[t'] - cfm[t'+1], plus cfm[begin]
        g_own_rows = torch.where(scanned, bvec[:, None] * CAPP + prow_own,
                                 0)                              # [B, P]
        posw = (tau[..., None] - 2 * lr - 1
                + torch.arange(4 * lr + 1, device=dev))          # [B,P,4lr+1]
        posc = posw.clamp(0, T - 1)
        h_at = (g_store[g_own_rows[..., None], posc]
                - cfm[bvec[:, None, None], posc + 1])
        h_at = torch.where(posw >= 0, h_at, LOG_ZERO)
        h_sel = h_at.unfold(2, W11, 1).amax(dim=3)               # [B,P,W11]
        cfm_sel = cfm[bvec[:, None, None],
                      (tau[..., None] - lr
                       + torch.arange(W11, device=dev)).clamp(0, T)]
        cb_rel = (cb - (tau[..., None] - lr)).clamp(0, W11 - 1)
        gb = (h_sel + cfm_sel).gather(2, cb_rel)
        est0 = gb + lm_opt_c + cinc + rest_e
        ok = ok & (gb > NEG_HALF) & (rest_e > NEG_HALF) & (cinc > NEG_HALF)
        prio0 = torch.where(ok, est0, NEG_INF)
        # keep the best CK children per pop (MAX_NEXT_WORDS analogue)
        top_p, top_i = topk_stable(prio0, CK)                    # [B,P,CK]
        c_w = cw.gather(2, top_i).reshape(B, P * CK)
        c_t = ce.gather(2, top_i).reshape(B, P * CK)

        def per_child(a):
            return a[..., None].expand(B, P, CK).reshape(B, P * CK)

        # exact weighted 2-gram for the survivors (hash probe); a word
        # outside the LM scores -99 (its id is clamped for the probe)
        w_lm = x.wid2lm[c_w]
        lp = bigram_score(self.ng, per_child(x.wid2lm[pw]),
                          w_lm.clamp(min=0))
        lp = torch.where(w_lm < 0, -99.0, lp)
        c_lm_add = d.lw2 * lp + d.pen2 + x.cprobv[c_w]
        c_opt = lm_opt_c.gather(2, top_i).reshape(B, P * CK)
        top_p = top_p.reshape(B, P * CK)
        c_prio = torch.where(top_p > NEG_HALF, top_p - c_opt + c_lm_add,
                             NEG_INF)
        c_prev = per_child(pw)
        c_parent = per_child(prow_own)
        c_lm_sum = per_child(plm_sum) + c_lm_add
        c_row = torch.full((B, P * CK), -1, dtype=i64, device=dev)
        c_len = per_child(plen) + 1
        c_seqh = _seq_mix(per_child(pseqh), c_w)

        # ---- merge the (popped-out) stack + re-pushes + children;
        # recombine duplicates, then trim back to S
        m_prio = torch.cat([s_prio, r_prio, c_prio], dim=1)
        m_w = torch.cat([s_w, r_w, c_w], dim=1)
        m_t = torch.cat([s_t, r_t, c_t], dim=1)
        m_prev = torch.cat([s_prev, r_prev, c_prev], dim=1)
        m_parent = torch.cat([s_parent, r_parent, c_parent], dim=1)
        m_lm_add = torch.cat([s_lm_add, r_lm_add, c_lm_add], dim=1)
        m_lm_sum = torch.cat([s_lm_sum, r_lm_sum, c_lm_sum], dim=1)
        m_row = torch.cat([s_row, r_row, c_row], dim=1)
        m_len = torch.cat([s_len, r_len, c_len], dim=1)
        m_seqh = torch.cat([s_seqh, r_seqh, c_seqh], dim=1)
        # (a) (word, anchor, prev) class keeps its best entry; fresh
        # entries recombine per (word, prev) regardless of anchor, and
        # exact (scanned) entries may only be evicted by exact ones
        is_exact = m_row >= 0
        key = torch.where(is_exact, m_w * (T + 1) + m_t, m_w * (T + 1) + T)
        prio_ex = torch.where(is_exact, m_prio, NEG_INF)

        def class_best(k, v):
            best = torch.full((B, DH), NEG_INF, dtype=f32, device=dev)
            best.scatter_reduce_(1, k, v, reduce="amax", include_self=True)
            return best.gather(1, k)

        k1, k2 = _recomb_keys(key, m_w, m_prev)
        keep = m_prio >= class_best(k1, m_prio) - 1e-4
        keep |= is_exact & (m_prio >= class_best(k1, prio_ex) - 1e-4)
        # (b) (word, prev) anchor beam of 40 below the class best
        keep &= ((m_prio >= class_best(k2, m_prio) - 40.0)
                 | (is_exact & (m_prio >= class_best(k2, prio_ex) - 40.0)))
        m_prio = torch.where(keep, m_prio, NEG_INF)
        s_prio, sel = topk_stable(m_prio, d.S)
        stack = [s_prio] + [a.gather(1, sel) for a in (
            m_w, m_t, m_prev, m_parent, m_lm_add, m_lm_sum, m_row, m_len,
            m_seqh)]

        # ---- termination bookkeeping (expansions count as the -m pop
        # budget; the exact-scan re-pop is bookkeeping)
        n_pops = self.n_pops + scanned.sum(dim=1)
        n_res = (res_score > NEG_HALF).sum(dim=1)
        kth = res_score[:, d.nbest - 1]
        top = m_prio.amax(dim=1)
        done = (((n_res >= d.nbest) & (top <= kth + 1e-6))
                | (top <= NEG_HALF) | (n_pops >= CAPP - P))

        # ---- write the round back; a gated-off round keeps every value
        for buf, new in ((self.res_score, res_score),
                         (self.res_arena, res_arena),
                         (self.res_seqh, res_seqh), (self.n_pops, n_pops),
                         (self.active, act & ~done),
                         (self.env_cnt, env_cnt), (self.env_seen, env_seen),
                         *zip(self.stack, stack)):
            buf.copy_(torch.where(go, new, buf))
        self.round_i.add_(go.to(i64))
        self.more.copy_(self._cond())


def pops_per_round(M: int) -> int:
    """Hypotheses an utterance pops a round over a trellis of M word
    ends a frame."""
    return WIDE_POPS if M >= WIDE_M else POPS


def _setup(lattices: List[Optional[TrellisLattice]],
           tabs: DeviceChainTables, wid2lm: np.ndarray,
           cprob: Optional[np.ndarray], out_ext: torch.Tensor, strategy,
           cfg: SearchConfig, best_in: Optional[np.ndarray], trellis=None
           ) -> Optional[Tuple[_Dims, _Inputs]]:
    """The host half of run_batch: `prepare`, the sizes and the inputs
    on the device; None when no utterance has a start.  `trellis` is the
    batch's pass-1 trellis on out_ext's device, for `prepare`'s suffix
    DP."""
    B, T, R = out_ext.shape
    dev = out_ext.device
    out_ext = out_ext.to(torch.float32).contiguous()
    # the device stack holds (hypothesis, boundary-anchor) VARIANTS, so
    # -s is scaled x4 to hold comparable hypothesis diversity
    S = max(64, 4 * int(cfg.stack_size))
    M = max((lat.M for lat in lattices if lat is not None), default=0)
    P = pops_per_round(M)
    # the round budget: the -m pop budget at POPS a round, capped so
    # that the g/beg stores at POPS a round stay within MEM_MB.  The
    # arena holds P rows a round, so every P gets the same rounds and
    # the stores grow by P / POPS
    rounds_mem = max(32, (MEM_MB << 20) // max(1, B * T * 8 * POPS))
    max_rounds = min(max(32, 2 * int(cfg.max_hypo_pop) // POPS),
                     rounds_mem)
    CAPP = max_rounds * P
    # per-frame best outprob: the admissible charge for entry-frame
    # slack in the candidate entry bound (cfm)
    fmax = out_ext.amax(dim=2)
    fmax_np = fmax.cpu().numpy()
    if best_in is None:
        best_in = _best_lm_in(strategy, tabs.loc.shape[0])
    with trace.span("astar.prepare"):
        prep = prepare(lattices, T, strategy, cfg, S, cprob, best_in,
                       fmax=fmax, trellis=trellis)
    if not (prep.last >= 0).any():
        return None
    NA = prep.ab.shape[1]
    lr = max(0, int(cfg.lookup_range))
    CA = min((2 * lr + 1) * Q_PER_FRAME, NA)
    Vp1 = tabs.loc.shape[0]
    cprobv = (np.zeros(Vp1, np.float32) if cprob is None
              else np.append(cprob.astype(np.float32), 0.0))
    if cprob is not None and len(cprobv) < Vp1:
        cprobv = np.pad(cprobv, (0, Vp1 - len(cprobv)))
    wid2lm_v = np.append(wid2lm.astype(np.int32), -1)
    if len(wid2lm_v) < Vp1:
        wid2lm_v = np.pad(wid2lm_v, (0, Vp1 - len(wid2lm_v)),
                          constant_values=-1)

    def on_dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    i64, f32 = torch.int64, torch.float32
    stack0 = tuple(on_dev(a, f32) if a.dtype == np.float32
                   else on_dev(a.astype(np.int64), i64) for a in prep.stack0)
    cfm = np.concatenate([np.zeros((B, 1), np.float32),
                          np.cumsum(fmax_np, axis=1, dtype=np.float32)],
                         axis=1)
    d = _Dims(B=B, T=T, R=R, NA=NA, P=P, S=S, CA=CA, CK=min(CHILD_KEEP, CA),
              CAPP=CAPP, max_rounds=max_rounds, lr=lr,
              tail=int(strategy.tail_word),
              nbest=int(min(cfg.nbest, NB_SLOTS)),
              lw2=float(cfg.lm_weight2), pen2=float(cfg.lm_penalty2),
              wb=(int(cfg.word_envelope) if cfg.enveloped else 1 << 30))
    x = _Inputs(out_ext, on_dev(wid2lm_v[:Vp1], i64),
                on_dev(cprobv[:Vp1], f32), on_dev(prep.ab, i64),
                on_dev(prep.packed, f32), on_dev(prep.rest, f32),
                on_dev(cfm, f32), on_dev(prep.last, i64), stack0)
    return d, x


@contextlib.contextmanager
def _eager(tabs, ng, iwcd2, d: _Dims, x: _Inputs):
    """run_batch's rounds as a Python loop: one step a round while the
    stop flag holds, read once a round.  Yields (the rounds, the run's
    statistics)."""
    with trace.span("astar.rounds"):
        rounds = _Rounds(tabs, ng, iwcd2, d, x)
        rounds.load(x)
        ran = 0
        while True:
            with trace.span("astar.wait"):
                more = bool(rounds.more)
            if not more:
                break
            rounds.step()
            ran += 1
    yield rounds, dict(replayed=ran, waits=ran + 1, captured=0,
                       capture_s=0.0, stop_every=1)


def _host_flag(flag: torch.Tensor) -> bool:
    """A [1] bool of the card on the host: a non-blocking copy into
    pinned memory and one event wait."""
    pinned = torch.empty(1, dtype=torch.bool, pin_memory=True)
    pinned.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(pinned)


class _RoundGraph(NamedTuple):
    """A captured A* round: the graph, the fixed tensors it reads and
    writes, the kernel launches one replay makes, and the N-gram and
    strict head tables it reads (their ids are part of the key)."""

    graph: torch.cuda.CUDAGraph
    rounds: _Rounds
    launches: int
    ng: DeviceNgram
    iwcd2: object


@contextlib.contextmanager
def _graphed(tabs, ng, iwcd2, d: _Dims, x: _Inputs):
    """run_batch's rounds on a CUDA card: replays of a captured round.
    The first batch of a key runs round 1 eagerly and captures the
    round (`_capture`), dropping the oldest entry past GRAPHS_KEPT.  The
    host replays STOP_EVERY rounds between two reads of the stop flag,
    so it waits at most ceil(rounds / STOP_EVERY) + 1 times and runs at
    most STOP_EVERY - 1 gated rounds past the end; nothing falls back to
    the eager loop.  Yields (the rounds, the run's statistics) with the
    cache's lock held, so that the caller reads the results out before
    another batch reuses the tensors."""
    device = x.out_ext.device
    key = (device, d, id(ng), id(iwcd2))
    cache = tabs.graphs
    every = STOP_EVERY
    with cache.lock, torch.cuda.device(device):
        with trace.span("astar.rounds"):
            entry = cache.entries.pop(key, None)
            captured = entry is None
            capture_s = 0.0
            if captured:
                while len(cache.entries) >= GRAPHS_KEPT:
                    del cache.entries[next(iter(cache.entries))]
                with trace.span("astar.capture"):
                    t0 = time.perf_counter()
                    rounds = _Rounds(tabs, ng, iwcd2, d, x)
                    rounds.load(x)
                    before = sk.CAPTURED
                    graph, = _capture(cache, device, rounds.step)
                    entry = _RoundGraph(graph, rounds, sk.CAPTURED - before,
                                        ng, iwcd2)
                    capture_s = time.perf_counter() - t0
                cache.captures += 1
                cache.capture_s += capture_s
            else:
                entry.rounds.load(x)
            cache.entries[key] = entry
            ran = int(captured)         # the capture's eager round 1
            replays = waits = 0
            while True:
                if ran:
                    waits += 1
                    with trace.span("astar.wait"):
                        more = _host_flag(entry.rounds.more)
                    if not more:
                        break
                for _ in range(every):
                    entry.graph.replay()
                ran += every
                replays += every
            sk.LAUNCHES += entry.launches * replays
        yield entry.rounds, dict(replayed=ran, waits=waits,
                                 captured=int(captured), capture_s=capture_s,
                                 stop_every=every)


def _collect(r: _Rounds, res_score: np.ndarray,
             lattices: List[Optional[TrellisLattice]], cfg: SearchConfig
             ) -> List[List[NBestResult]]:
    """The N-best lists of finished rounds (`res_score` read from them):
    word sequences from the arena, bounds from the winners' beg rows."""
    B, T, CAPP = r.d.B, r.d.T, r.d.CAPP
    res_arena = r.res_arena.cpu().numpy()
    arena_w = r.arena_w.cpu().numpy()
    arena_parent = r.arena_parent.cpu().numpy()
    arena_lm_sum = r.arena_lm_sum.cpu().numpy()

    # reconstruct word sequences; fetch beg rows for the winners only
    chains: List[List[Tuple[int, List[int]]]] = []
    for b in range(B):
        per = []
        for k in range(NB_SLOTS):
            if res_score[b, k] <= NEG_HALF:
                continue
            ai = int(res_arena[b, k])
            idxs = []
            while ai >= 0:
                idxs.append(ai)
                ai = int(arena_parent[b, ai])
            idxs.reverse()
            per.append((k, idxs))
        chains.append(per)
    rows_flat: List[int] = []
    for b, per in enumerate(chains):
        for _, idxs in per:
            rows_flat.extend(b * CAPP + ai for ai in idxs)
    begs = (r.beg_store[torch.as_tensor(rows_flat, dtype=torch.int64,
                                        device=r.beg_store.device)]
            .cpu().numpy() if rows_flat else np.zeros((0, T), np.int32))
    pos = 0
    results: List[List[NBestResult]] = []
    for b in range(B):
        per_out: List[NBestResult] = []
        seen_seqs = set()
        lat = lattices[b]
        for k, idxs in chains[b]:
            n = len(idxs)
            rows = begs[pos:pos + n]
            pos += n
            words = [int(arena_w[b, ai]) for ai in idxs]
            seq = tuple(words)
            if seq in seen_seqs or any(w < 0 for w in words):
                continue
            seen_seqs.add(seq)
            Tb = lat.T
            bounds: List[Tuple[int, int]] = []
            e = Tb - 1
            for wi in range(n - 1, -1, -1):
                b0 = int(rows[wi][e]) if e >= 0 else 0
                b0 = max(0, min(b0, e))
                bounds.append((b0, e))
                e = b0 - 1
            bounds.reverse()
            exact = float(res_score[b, k])
            lm_sum = float(arena_lm_sum[b, idxs[-1]])
            per_out.append(NBestResult(
                word_ids=words, score=exact,
                am_score=exact - lm_sum, lm_score=lm_sum,
                bounds=bounds))
        per_out.sort(key=lambda r: -r.score)
        results.append(per_out[:cfg.nbest])
    return results


def run_batch(lattices: List[Optional[TrellisLattice]],
              tabs: DeviceChainTables, ng: DeviceNgram,
              wid2lm: np.ndarray, cprob: Optional[np.ndarray],
              out_ext: torch.Tensor, strategy, cfg: SearchConfig,
              best_in: Optional[np.ndarray] = None,
              iwcd2=None, eager: bool = False, trellis=None,
              ) -> List[List[NBestResult]]:
    """Device A* over a whole utterance batch; returns per-utterance
    N-best lists (empty list = pass-1 fallback, like the host path).
    out_ext [B, T, R] is the unshifted outprob cache on the tables'
    device.  With `iwcd2` tables that resolve at least one head
    triphone, each scan's word-head columns follow the popped entry's
    previous word (strict inter-word CD).

    On a CUDA card the rounds are replays of a captured round
    (`_graphed`); eager=True runs the same round once a round from
    Python instead, the graph's oracle.  The CPU always runs that loop.

    `best_in` is LM-dependent, not batch-dependent: pass the cached
    array (engine._p2d_best_in) to avoid re-walking the whole N-gram
    dict per decode batch.  `trellis`, the batch's [B, T, M] pass-1
    trellis on out_ext's device (`pass1_batch`'s), saves `prepare`'s
    suffix DP an upload of the lattices.  LAST_STATS' `strict_classes`
    is the left-context classes of the strict head table the rounds
    substitute (class 0 included; 0 without strict heads)."""
    with trace.span("astar.setup"):
        setup = _setup(lattices, tabs, wid2lm, cprob, out_ext, strategy,
                       cfg, best_in, trellis=trellis)
    if setup is None:
        return [[] for _ in range(len(lattices))]
    d, x = setup
    if iwcd2 is not None and iwcd2.n_resolved == 0:
        iwcd2 = None
    classes = 0 if iwcd2 is None else int(iwcd2.head_sidx.shape[1])
    run = _eager if x.out_ext.device.type == "cpu" or eager else _graphed
    with run(tabs, ng, iwcd2, d, x) as (rounds, info), \
            trace.span("astar.collect"):
        res_score = rounds.res_score.cpu().numpy()
        n_rounds = int(rounds.round_i)
        n_pops = rounds.n_pops.cpu().numpy().tolist()
        results = _collect(rounds, res_score, lattices, cfg)
    # search statistics of the LAST run_batch call (profiling)
    LAST_STATS.update(
        rounds=n_rounds, **info, max_rounds=d.max_rounds, CAPP=d.CAPP,
        P=d.P, S=d.S, CA=d.CA, CK=d.CK, B=d.B, T=d.T, NA=d.NA,
        graphed=run is _graphed, n_pops=n_pops, strict_classes=classes)
    return results
