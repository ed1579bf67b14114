"""Pass 2 with acoustic re-scan: A* stack decoding where every word
extension re-runs the word's Viterbi against the cached outprobs.

This is the parity path for the reference's second pass
(`search_bestfirst_main.c:787` wchmm_fbs loop + `search_bestfirst_v1.c:589`
scan_word): a hypothesis carries its whole g[t] score vector, attaching a
word re-derives the exact acoustic score and the refined word boundary
under the hypothesis's own history, the word envelope bounds pops per
hypothesis length (`search_bestfirst_main.c:847` wb_ok), and `-sb`
(scan_beam) masks entry frames outside the score envelope.

Port of `julius_tpu/search/pass2_rescan.py`: the host code is a copy;
`ScanDispatcher` keeps its device state in torch tensors on the
engine's device.  One A* round pops the best few hypotheses of EVERY
utterance in the batch, gathers all their word extensions into windowed
scans (K chains x W frames, one launch of the scan kernel per chunk),
then pushes the rescored hypotheses back on the per-utterance stacks.
The stack logic stays on the host (it is tiny); everything sized O(T)
stays on the device: chain tables for the whole vocabulary
(scan.DeviceChainTables), and the per-hypothesis g/beg vectors in a
row store seeded from their parents' rows; only the [K, A] anchor-frame
scores come back each round.

Three design rules keep the serial-round count and per-round cost down:

* the A* completion estimate is the pass-1 trellis suffix score WITH its
  LM portion (`pass2.suffix_estimate`), mirroring the reference's use of
  backtrellis scores as the forward estimate (`search.h` NODE score =
  g[] + backtrellis score).  An AM-only estimate is so optimistic under
  lm_weight ~8 that the search degenerates to breadth-first over the
  whole word-envelope budget;
* each round pops a batch of hypotheses per utterance (POPS_PER_ROUND),
  so rounds ~ sentence length, not pops;
* each word extension scans only a bucketed window of frames around its
  trellis span (`scan.scan_words_store_win`) - words span ~30 frames
  while utterances span hundreds (reference scan_word walks only the
  word's frames for the same reason).

The pass-1 trellis supplies next-word candidates (atoms whose begin
frame falls within +-lookup_range of the boundary, reference
`ngram_decode.c:566` ngram_nextwords); candidate sets are cached per
boundary frame since they are hypothesis-independent.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.search.pass2 import (AtomTable, NBestResult,
                                          TrellisLattice, atom_table,
                                          suffix_estimate)
from julius_tpu_torch.search.scan import (DeviceChainTables, bucket_w,
                                          scan_words_store_win)
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2

#: hypotheses popped per utterance per round (device-dispatch batching
#: knob: larger = fewer, bigger rounds; the A* is stale-pop tolerant)
POPS_PER_ROUND = 16
#: cap on distinct next words considered per expansion
MAX_NEXT_WORDS = 32
#: cap on boundary-anchor variants pushed per rescored hypothesis (the
#: best few by priority; bounds stack flooding so distinct alternative
#: sequences survive the stack trim)
MAX_ANCHORS = 8
#: anchor-frame slots per scan request (candidate word-end frames whose
#: g values return to the host; union across sibling expansions —
#: overflow opens a chained request, no anchors are dropped)
A_CAND = 16
#: failsafe on total scans per utterance
MAX_SCANS = 20000
#: K buckets for one store dispatch (pads up; keeps jit cache small)
K_BUCKETS = (256, 2048)
#: extra frames of entry slack before the earliest trellis begin of a
#: word (boundary refinement may move a begin earlier than any pass-1
#: atom recorded; the trap test shifts one by 3)
WIN_PAD = 12

#: optional debug hook (tests/diagnostics): callable fed skip events
_DBG = None
#: scan chunks dispatched by every ScanDispatcher of this process (one
#: scan-kernel launch each)
CHUNKS = 0


def _bucket_k(k: int) -> int:
    for b in K_BUCKETS:
        if k <= b:
            return b
    return -(-k // K_BUCKETS[-1]) * K_BUCKETS[-1]


class _RowPool:
    """Host-side free-list over the device row store (row 0 = scratch
    for padded requests; rows are reclaimed by RowHandle GC)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.free = list(range(cap - 1, 0, -1))

    def alloc(self) -> int:
        return self.free.pop()

    def release(self, row: int) -> None:
        self.free.append(row)


class RowHandle:
    """One allocated g/beg row; sibling hypotheses share a handle, GC
    returns the row to the pool when the last reference dies."""

    __slots__ = ("row", "pool")

    def __init__(self, row: int, pool: _RowPool):
        self.row = row
        self.pool = pool

    def __del__(self):
        try:
            self.pool.release(self.row)
        except Exception:
            pass


class _Hyp:
    """A sentence prefix (one per (parent, word) expansion; its stack
    entries — one per candidate boundary anchor — share this record)."""

    __slots__ = ("words", "rows", "lm_sum", "state")

    def __init__(self, words, rows, lm_sum, state):
        self.words = words          # Tuple[int, ...]
        self.rows = rows            # Tuple[RowHandle, ...]
        self.lm_sum = lm_sum
        self.state = state          # DFA reverse-NFA state set (grammar)


class NgramStrategy:
    """Forward N-gram LM scoring + acceptance (host-side probes, so a
    user LM plugs in unchanged)."""

    def __init__(self, lm, wid2lm, cfg: SearchConfig, tail_word: int,
                 transparent=None, cprob=None):
        self.lm, self.wid2lm = lm, wid2lm
        self.lw2, self.pen2 = cfg.lm_weight2, cfg.lm_penalty2
        self.tail_word = tail_word
        self.transparent = transparent
        self.cprob = cprob
        self._probe_cache: Dict = {}

    def _pen(self, w: int) -> float:
        return self.pen2 + (float(self.cprob[w])
                            if self.cprob is not None else 0.0)

    def _ctx(self, words: Tuple[int, ...]) -> Tuple[int, ...]:
        need = (self.lm.order - 1) if self.lm is not None else 1
        out = []
        for w in reversed(words):
            if self.transparent is not None and self.transparent[w]:
                continue
            out.append(w)
            if len(out) >= need:
                break
        return tuple(reversed(out))

    def lm_add(self, words: Tuple[int, ...], w: int) -> float:
        if self.lm is None or self.wid2lm is None:
            return self._pen(w)
        key = (self._ctx(words), w)
        v = self._probe_cache.get(key)
        if v is None:
            wl = int(self.wid2lm[w])
            if wl < 0:
                v = self.lw2 * -99.0
            else:
                ctx = tuple(int(self.wid2lm[c]) for c in key[0]
                            if self.wid2lm[c] >= 0)
                v = self.lw2 * self.lm.logprob(ctx, wl)
            self._probe_cache[key] = v
        return v + self._pen(w)

    def ctx_key(self, words: Tuple[int, ...]):
        return self._ctx(words)

    def init_state(self):
        return ()

    def step_state(self, state, w: int):
        return state          # always viable (never None)

    def is_final(self, w: int, state) -> bool:
        return w == self.tail_word

    def may_final(self, w: int) -> bool:
        """State-independent over-approximation of is_final (used for
        cacheable anchor selection; exact is_final still gates
        completion at pop time)."""
        return w == self.tail_word


class DfaStrategy:
    """DFA grammar acceptance via the reverse-NFA state set
    (reference dfa_decode.c; .dfa follows the reversed-grammar
    convention, io/dfa.py)."""

    def __init__(self, dfa, word_cat: np.ndarray, cfg: SearchConfig):
        self.dfa, self.word_cat = dfa, word_cat
        self.pen2 = cfg.lm_penalty2
        self._cache: Dict[Tuple[frozenset, int], frozenset] = {}

    def lm_add(self, words, w: int) -> float:
        return self.pen2

    def ctx_key(self, words):
        return ()

    def init_state(self):
        return self.dfa.accept_start_set()

    def step_state(self, state, w: int):
        key = (state, int(self.word_cat[w]))
        out = self._cache.get(key)
        if out is None:
            out = self.dfa.reverse_nfa_step(*key)
            self._cache[key] = out
        return out if out else None       # None = dead

    def is_final(self, w: int, state) -> bool:
        return any(self.dfa.initial[s] for s in state)

    def may_final(self, w: int) -> bool:
        # grammar vocabularies are small; the cost of one extra
        # final-frame anchor per word is negligible
        return True


class _Req:
    """One word-extension scan request (shared by sibling anchors;
    overflow past A_CAND chains a new request — see _ReqPool.add)."""

    __slots__ = ("b", "w", "parent", "lm", "anchors", "slots",
                 "elo", "hi", "lcc")

    def __init__(self, b, w, parent, lm, elo, lcc=0):
        self.b = b
        self.w = w
        self.parent = parent            # Optional[RowHandle]
        self.lm = lm
        self.anchors: List[int] = []
        self.slots: Dict[int, int] = {}
        self.elo = elo                  # earliest entry frame needed
        self.hi = 0                     # latest anchor frame
        self.lcc = lcc                  # left-context class (iwcd2)


class _ReqPool:
    """Merges word-extension requests by (utterance, parent row, word)
    and chains a fresh request when the anchor union overflows A_CAND
    (ADVICE r3: silent anchor drops lose boundary variants)."""

    def __init__(self):
        self.reqs: List[_Req] = []
        self._by_key: Dict[Tuple, List[int]] = {}

    def add(self, b: int, row: int, w: int, parent, lm: float,
            ts: List[int], elo: int, lcc: int = 0) -> List[Tuple[int, int]]:
        """Register anchors ts; returns [(req_index, slot)] per t."""
        key = (b, row, w)
        ris = self._by_key.get(key)
        if ris is None:
            # fast path: fresh key (the overwhelmingly common case) —
            # bulk-assign slots without the per-anchor search
            ris = []
            self._by_key[key] = ris
            out = []
            r = None
            ri = -1
            for t in ts:
                if r is None or len(r.anchors) >= A_CAND:
                    r = _Req(b, w, parent, lm, elo, lcc)
                    r.elo = elo
                    ri = len(self.reqs)
                    self.reqs.append(r)
                    ris.append(ri)
                s = len(r.anchors)
                r.anchors.append(t)
                r.slots[t] = s
                if t > r.hi:
                    r.hi = t
                out.append((ri, s))
            return out
        out = []
        for t in ts:
            placed = None
            for ri in ris:
                r = self.reqs[ri]
                s = r.slots.get(t)
                if s is not None:
                    placed = (ri, s)
                    break
                if len(r.anchors) < A_CAND:
                    s = len(r.anchors)
                    r.anchors.append(t)
                    r.slots[t] = s
                    r.elo = min(r.elo, elo)
                    r.hi = max(r.hi, t)
                    placed = (ri, s)
                    break
            if placed is None:
                r = _Req(b, w, parent, lm, elo, lcc)
                ri = len(self.reqs)
                self.reqs.append(r)
                ris.append(ri)
                r.anchors.append(t)
                r.slots[t] = 0
                r.hi = t
                placed = (ri, 0)
            out.append(placed)
        return out


class ScanDispatcher:
    """Device-resident dispatch of A* rounds: chain tables and per-
    hypothesis g/beg rows stay on the device; per round the host uploads
    K (word, parent-row, lm, window, anchor-frames) tuples and downloads
    [K, A] anchor scores.

    Requests are grouped by window bucket and chunked by K bucket; every
    chunk of a round is enqueued before the first download, so the
    downloads wait on the card once per round, not once per chunk.  The
    row store is preallocated, plus one sink row for the pad chains'
    writes (scan.scan_words_store_win)."""

    def __init__(self, tabs: DeviceChainTables, out_ext: torch.Tensor,
                 scan_beam: float = 0.0, cap: int = 8192, iwcd2=None):
        self.tabs = tabs
        self.iwcd2 = iwcd2            # search.iwcd2.StrictIWCDTables
        B, T, R = out_ext.shape
        self.out_ext = out_ext.to(torch.float32).contiguous()
        self.T = int(T)
        self.R = int(R)
        dev = out_ext.device
        # per-frame best outprob: the admissible charge for boundary
        # slack in the suffix estimate (pass2.suffix_estimate)
        self.fmax = self.out_ext.amax(dim=2).cpu().numpy()
        self.n_scans = 0
        self.scan_beam = float(scan_beam)
        self.pool = _RowPool(cap)
        self.g_store = torch.full((cap + 1, self.T), LOG_ZERO,
                                  dtype=torch.float32, device=dev)
        self.beg_store = torch.zeros((cap + 1, self.T), dtype=torch.int32,
                                     device=dev)

    def _grow(self) -> None:
        # fallback only (preallocation should cover normal runs); the
        # sink row stays last
        cap = self.pool.cap
        g = torch.full((2 * cap + 1, self.T), LOG_ZERO,
                       dtype=torch.float32, device=self.g_store.device)
        beg = torch.zeros((2 * cap + 1, self.T), dtype=torch.int32,
                          device=self.g_store.device)
        g[:cap] = self.g_store[:cap]
        beg[:cap] = self.beg_store[:cap]
        self.g_store, self.beg_store = g, beg
        self.pool.free.extend(range(2 * cap - 1, cap - 1, -1))
        self.pool.cap = 2 * cap

    def run(self, reqs: List[_Req]):
        """Returns (handles, ganch, banch, sanch), the latter three
        [len(reqs), A_CAND]: g / refined-begin / seed-at-entry values at
        each request's anchor frames."""
        global CHUNKS
        n = len(reqs)
        handles: List[Optional[RowHandle]] = [None] * n
        T = self.T
        dev = self.g_store.device
        # window bucket per request
        wb = np.empty(n, np.int32)
        t0s = np.empty(n, np.int32)
        for i, r in enumerate(reqs):
            elo = 0 if r.parent is None else max(0, r.elo)
            span = r.hi - elo + 1
            W = bucket_w(span, T)
            wb[i] = W
            t0s[i] = min(elo, T - W)
        ganch = np.full((n, A_CAND), LOG_ZERO, np.float32)
        banch = np.zeros((n, A_CAND), np.int32)
        sanch = np.full((n, A_CAND), LOG_ZERO, np.float32)
        pending = []                    # (indices, K, ganch/banch/sanch)
        dead_w = self.tabs.n_words      # pad chain scores LOG_ZERO
        kw = {}
        if self.iwcd2 is not None:
            kw = dict(head_sidx=self.iwcd2.head_sidx,
                      head_ns=self.iwcd2.head_ns)
        for W in sorted(set(wb.tolist())):
            idxs = np.nonzero(wb == W)[0]
            for ofs in range(0, len(idxs), K_BUCKETS[-1]):
                chunk = idxs[ofs:ofs + K_BUCKETS[-1]]
                K = len(chunk)
                Kb = _bucket_k(K)
                # one packed int upload per chunk: columns (wid, parent,
                # bidx, row, t0, lcc, anchors[A]); pad rows point at the
                # store's sink row
                ints = np.zeros((Kb, 6 + A_CAND), np.int32)
                ints[:, 0] = dead_w
                ints[:, 1] = -1
                ints[:, 3] = self.pool.cap
                lm = np.zeros(Kb, np.float32)
                for j, ri in enumerate(chunk):
                    r = reqs[ri]
                    row_j = ints[j]
                    row_j[0] = r.w
                    if r.parent is not None:
                        row_j[1] = r.parent.row
                    row_j[2] = r.b
                    lm[j] = r.lm
                    row_j[4] = t0s[ri]
                    row_j[5] = r.lcc
                    if not self.pool.free:
                        self._grow()
                    h = RowHandle(self.pool.alloc(), self.pool)
                    handles[ri] = h
                    row_j[3] = h.row
                    if r.anchors:
                        row_j[6:6 + len(r.anchors)] = r.anchors
                # a growth above may have moved the sink: pads follow it
                ints[K:, 3] = self.pool.cap
                ga, ba, sa = scan_words_store_win(
                    self.g_store, self.beg_store, self.tabs,
                    torch.from_numpy(ints).to(dev),
                    torch.from_numpy(lm).to(dev), self.out_ext, W,
                    self.scan_beam, **kw)
                pending.append((chunk, K, ga, ba, sa))
                self.n_scans += K
                CHUNKS += 1
        # download only after every chunk is enqueued: the first copy
        # waits on the card, the rest are ready by then
        for chunk, K, ga, ba, sa in pending:
            ganch[chunk] = ga[:K].cpu().numpy()
            banch[chunk] = ba[:K].cpu().numpy()
            sanch[chunk] = sa[:K].cpu().numpy()
        return handles, ganch, banch, sanch

    def fetch_beg(self, row_ids: List[int]) -> np.ndarray:
        """[n, T] beg rows for final backtrace (one gather)."""
        if not row_ids:
            return np.zeros((0, self.T), np.int32)
        idx = torch.as_tensor(row_ids, dtype=torch.int64,
                              device=self.beg_store.device)
        return self.beg_store[idx].cpu().numpy()


class _Cands:
    """Hypothesis-independent candidate extensions at one boundary
    frame: per word, its anchor end-frames (best trellis atom per
    frame), earliest trellis begin (window lo), and the anchor->slot-m
    map for stack bookkeeping."""

    __slots__ = ("words", "anchor_ts", "t2m", "lo")

    def __init__(self, words, anchor_ts, t2m, lo):
        self.words = words          # List[int]
        self.anchor_ts = anchor_ts  # List[List[int]] per word
        self.t2m = t2m              # List[Dict[int, int]]
        self.lo = lo                # List[int] earliest begin per word


@dataclass
class _UttState:
    lattice: TrellisLattice
    stack: List[tuple] = field(default_factory=list)
    results: List[Tuple[_Hyp, float]] = field(default_factory=list)
    seen: Dict = field(default_factory=dict)
    # pass-2 word graph accumulator: (word, begin, end) -> (cum, am, lm)
    # with dynamic merge keeping the best cumulative score (reference
    # wordgraph_assign graphout.c:1901 + merge :2020)
    gwords: Dict = field(default_factory=dict)
    # word envelope: distinct word sequences admitted per length
    # (reference wb_ok, search_bestfirst_main.c:847; counting sequences
    # rather than pops so sibling boundary anchors don't burn the budget)
    len_seen: Dict[int, set] = field(default_factory=dict)
    n_pop: int = 0
    # A* completion estimate: rest[t] = best trellis continuation
    # (AM + pass-1 LM) covering frames t+1..T-1 (pass2.suffix_estimate)
    rest: Optional[np.ndarray] = None
    cands: Dict[int, Optional[_Cands]] = field(default_factory=dict)
    # the lattice's atoms sorted by begin frame (candidate lookup)
    atoms: Optional[AtomTable] = None
    active: bool = True


def _cand_for(st: _UttState, tau: int, lr: int, strategy) -> \
        Optional[_Cands]:
    """Candidate word extensions whose begin frame falls within +-lr of
    tau (reference ngram_nextwords backtrellis window; lr=0 for the
    sentence-initial lookup).  Hypothesis-independent => cached per tau."""
    cs = st.cands.get((tau, lr))
    if cs is not None or (tau, lr) in st.cands:
        return cs
    lat, a = st.lattice, st.atoms
    i0 = np.searchsorted(a.ab, tau - lr)
    i1 = np.searchsorted(a.ab, tau + lr, side="right")
    cs = None
    if i1 > i0:
        e = a.ae[i0:i1]
        ok = e >= tau              # word must end after the boundary
        if ok.any():
            w = a.aw[i0:i1][ok]
            e = e[ok]
            m = a.am[i0:i1][ok]
            b = a.ab[i0:i1][ok]
            # rank words and anchor end-frames by the FULL-PATH estimate
            # through the atom (cumulative + suffix), not the raw
            # cumulative score: cumulative alone decreases with t, so it
            # systematically crowds later (longer-span) end frames out
            # of the A_CAND cap — exactly the boundaries the re-scan
            # exists to recover (e.g. an iwsp word absorbing an
            # inter-word pause ends ~15 frames later than the short
            # variants).  Mirrors the reference ranking by trellis score
            # + backward estimate (ngram_decode.c:192).
            s = a.asc[i0:i1][ok] + st.rest[e]
            # group atoms by word, best-estimate first within each group
            order = np.lexsort((-s, w))
            w, e, m, b, s = (w[order], e[order], m[order], b[order],
                             s[order])
            Tl = lat.T
            # per-word earliest begin (window lo) over ALL atoms, before
            # end-frame dedup
            starts0 = np.r_[0, 1 + np.nonzero(np.diff(w))[0]]
            min_b = np.minimum.reduceat(b, starts0)
            lo_of = dict(zip(w[starts0].astype(int).tolist(),
                             min_b.astype(int).tolist()))
            # dedup (word, end) keeping the best-estimate atom: the
            # array is sorted by (w, -s), so np.unique's first
            # occurrence per key IS the best atom for that pair (one
            # global unique instead of one per word — the per-word
            # version was a measured host hotspot at ~150k calls/decode)
            key = w * (Tl + 1) + e
            _, first = np.unique(key, return_index=True)
            w, e, m, s = w[first], e[first], m[first], s[first]
            order = np.lexsort((-s, w))
            w, e, m, s = w[order], e[order], m[order], s[order]
            starts = np.r_[0, 1 + np.nonzero(np.diff(w))[0]]
            ends = np.r_[starts[1:], len(w)]
            head_s = s[starts]                 # per-word best estimate
            top = np.argsort(-head_s, kind="stable")[:MAX_NEXT_WORDS]
            words, anchor_ts, t2m, lo = [], [], [], []
            for gi in top.tolist():
                if not np.isfinite(head_s[gi]):
                    continue                   # no continuation anywhere
                g0, g1 = int(starts[gi]), int(ends[gi])
                wi = int(w[g0])
                g1 = min(g1, g0 + A_CAND)      # best A_CAND ends
                ts = e[g0:g1].astype(int).tolist()
                m_of = dict(zip(ts, m[g0:g1].astype(int).tolist()))
                if strategy.may_final(wi) and Tl - 1 not in m_of:
                    if len(ts) >= A_CAND:
                        ts = ts[:-1]
                    ts.append(Tl - 1)
                    m_of[Tl - 1] = 0
                words.append(wi)
                anchor_ts.append(ts)
                t2m.append(m_of)
                lo.append(min(lo_of[wi], tau - lr) - WIN_PAD)
            if words:
                cs = _Cands(words, anchor_ts, t2m, lo)
    st.cands[(tau, lr)] = cs
    return cs


def rescan_nbest_batch(
    lattices: List[Optional[TrellisLattice]],
    dispatcher: ScanDispatcher,
    strategy,
    cfg: SearchConfig,
    graphs: Optional[List] = None,
) -> List[List[NBestResult]]:
    """Run the rescanned A* for a whole utterance batch in lockstep.

    lattices[b] = None skips utterance b.  Returns per-utterance N-best
    lists (possibly empty = fall back to pass 1).  When `graphs` is a
    list, it receives one {(word, begin, end): (cum, am, lm)} dict per
    utterance — the pass-2 word graph accumulated during search
    (reference wordgraph_assign/merge, graphout.c:1901,2020)."""
    lr = max(0, int(cfg.lookup_range))
    lcmap = (dispatcher.iwcd2.lc_of_word
             if dispatcher.iwcd2 is not None else None)
    seqc = itertools.count()
    utts: List[Optional[_UttState]] = []
    pool = _ReqPool()
    metas = []     # (b, parent_hyp|None, w, ts, t2m, lm, state, slots)
    for b, lat in enumerate(lattices):
        if lat is None or lat.T == 0:
            utts.append(None)
            continue
        if not np.isfinite(
                np.max(np.where(lat.word >= 0, lat.score, -np.inf))):
            utts.append(None)
            continue
        a = atom_table(lat)
        # each atom's FULL pass-1 increment (its pass-1 LM included, not
        # re-weighted)
        st = _UttState(lattice=lat, atoms=a,
                       rest=suffix_estimate(a.ab, a.ae, a.asc - a.pscore,
                                            lat.T, lr,
                                            dispatcher.fmax[b, :lat.T]))
        utts.append(st)
        cs = _cand_for(st, 0, 0, strategy)
        if cs is None:
            continue
        for ci, w in enumerate(cs.words):
            state = strategy.step_state(strategy.init_state(), w)
            if state is None:
                continue
            lm = strategy.lm_add((), w)
            ts = cs.anchor_ts[ci]
            slots = pool.add(b, -1, w, None, lm, ts, 0)
            metas.append((b, None, w, ts, cs.t2m[ci], lm, state, slots))

    collect = graphs is not None
    while True:
        reqs = pool.reqs
        if reqs:
            handles, ganch, banch, sanch = dispatcher.run(reqs)
            for (b, parent, w, ts, t2m, lm, state, slots) in metas:
                st = utts[b]
                h0 = handles[slots[0][0]]
                hyp = _Hyp(
                    words=(parent.words + (w,)) if parent else (w,),
                    rows=(parent.rows + (h0,)) if parent
                    else (h0,),
                    lm_sum=(parent.lm_sum + lm) if parent else lm,
                    state=state)
                _push_scored(st, hyp, ts, t2m,
                             [float(ganch[ri][s]) for ri, s in slots],
                             cfg, seqc)
            if collect:
                for ri, req in enumerate(reqs):
                    gw = utts[req.b].gwords
                    for ai, t in enumerate(req.anchors):
                        gv = float(ganch[ri][ai])
                        if gv <= NEG_HALF:
                            continue
                        key = (req.w, int(banch[ri][ai]), t)
                        am = gv - float(sanch[ri][ai])
                        cur = gw.get(key)
                        if cur is None or gv > cur[0]:
                            gw[key] = (gv, am, req.lm)
        pool = _ReqPool()
        meta_of: Dict[Tuple, list] = {}
        for b, st in enumerate(utts):
            if st is None or not st.active:
                continue
            lat = st.lattice
            M, T = lat.M, lat.T
            # A*-correct termination for batched pops: a completion is
            # only FINAL once nothing on the stack estimates above the
            # nbest-th completed score (the serial reference pops
            # strictly best-first so acceptance order IS score order,
            # search_bestfirst_main.c:1645; a batched round pops below
            # the frontier, so a worse hypothesis can complete while a
            # better one still waits on its scan)
            if len(st.results) >= cfg.nbest:
                kth = sorted((s for (_, s) in st.results),
                             reverse=True)[cfg.nbest - 1]
                if not st.stack or -st.stack[0][0] <= kth + 1e-6:
                    st.active = False
                    continue
            n_popped = 0
            while (st.stack and n_popped < POPS_PER_ROUND and st.active):
                negp, _, hyp, t, m, gval = heapq.heappop(st.stack)
                prio = -negp
                # -m counts EXPANDED hypotheses (reference hypo
                # expansion overflow); anchor-duplicate and final pops
                # are bookkeeping, not expansions
                if (st.n_pop >= cfg.max_hypo_pop
                        or dispatcher.n_scans >= MAX_SCANS * len(lattices)):
                    st.active = False
                    break
                if (t == T - 1
                        and strategy.is_final(hyp.words[-1], hyp.state)
                        and gval > NEG_HALF):
                    # completion: popped at its own final-frame anchor
                    # with prio == exact score (rest[T-1] = 0); record
                    # it and stop popping BELOW it this round — pending
                    # higher-prio expansions may still beat it, so the
                    # stack-top check above decides when it is final
                    if not any(r.words == hyp.words
                               for (r, _) in st.results):
                        st.results.append((hyp, gval))
                        if len(st.results) >= cfg.nbest:
                            break
                    continue
                # SCORE-aware dedup, not first-come: a batched round
                # pops below the frontier, so a weaker hypothesis can
                # reach this (boundary atom, LM context) class a round
                # before a stronger one is even on the stack — the
                # serial reference pops strictly best-first so arrival
                # order IS score order.  Admission is therefore by g
                # value: a later pop that beats the weakest admitted g
                # still expands (the earlier weaker expansion is merely
                # wasted work, not a search error).
                key = (t * M + m, strategy.ctx_key(hyp.words))
                ent = st.seen.get(key)
                if ent is not None and len(ent) >= cfg.nbest \
                        and gval <= ent[0] + 1e-6:
                    if _DBG:
                        _DBG(("seen-skip", hyp.words, t, m, gval))
                    continue
                if _DBG:
                    _DBG(("admit", hyp.words, t, m, gval))
                if ent is None:
                    st.seen[key] = [gval]
                elif len(ent) < cfg.nbest:
                    heapq.heappush(ent, gval)
                else:
                    heapq.heapreplace(ent, gval)
                if cfg.enveloped:
                    # word envelope (reference wb_ok): admit the best
                    # `word_envelope` distinct sequences per length by
                    # PRIORITY, order-independently (same staleness
                    # argument as above)
                    L = len(hyp.words)
                    adm = st.len_seen.setdefault(L, {})
                    cur = adm.get(hyp.words)
                    if cur is None:
                        if len(adm) >= cfg.word_envelope:
                            wkey = min(adm, key=adm.get)
                            if prio <= adm[wkey]:
                                continue
                            del adm[wkey]
                        adm[hyp.words] = prio
                    elif prio > cur:
                        adm[hyp.words] = prio
                n_popped += 1
                st.n_pop += 1
                cs = _cand_for(st, t + 1, lr, strategy)
                if cs is None:
                    continue
                row = hyp.rows[-1].row
                lcc = int(lcmap[hyp.words[-1]]) if lcmap is not None \
                    else 0
                for ci, w in enumerate(cs.words):
                    mkey = (b, row, w)
                    meta = meta_of.get(mkey)
                    if meta is not None:
                        # same (parent, word) popped at a sibling
                        # anchor: merge the new anchor frames instead of
                        # duplicating the scan and its stack pushes
                        ts_new = [t_ for t_ in cs.anchor_ts[ci]
                                  if t_ not in meta[4]]
                        if ts_new:
                            meta[7].extend(pool.add(
                                b, row, w, hyp.rows[-1], meta[5],
                                ts_new, cs.lo[ci], lcc))
                            meta[3].extend(ts_new)
                            for t_ in ts_new:
                                meta[4][t_] = cs.t2m[ci][t_]
                        continue
                    state = strategy.step_state(hyp.state, w)
                    if state is None:
                        continue
                    lm = strategy.lm_add(hyp.words, w)
                    ts = list(cs.anchor_ts[ci])
                    # sibling anchors share the parent's g row; one
                    # scan serves them all (anchor frames are merged)
                    slots = pool.add(b, row, w, hyp.rows[-1], lm, ts,
                                     cs.lo[ci], lcc)
                    meta_of[mkey] = [b, hyp, w, ts, dict(cs.t2m[ci]),
                                     lm, state, slots]
        metas = list(meta_of.values())
        if not pool.reqs:
            # no expansions this round; stop only when nothing is left
            # to pop (a round can be all-final or all-dead-end pops)
            if not any(st is not None and st.active and st.stack
                       for st in utts):
                break

    if graphs is not None:
        for st in utts:
            graphs.append(st.gwords if st is not None else {})
    return _finalize_all(utts, dispatcher, cfg)


def _push_scored(st: _UttState, hyp: _Hyp, anchor_ts: List[int],
                 t2m: Dict[int, int], gvals: List[float],
                 cfg: SearchConfig, seqc) -> None:
    """Push one stack entry per viable anchor frame (the reference keeps
    a NEXTWORD.tre trellis atom per expansion, ngram_decode.c:566): the
    anchor sets the pass-1 completion estimate AND centres the next
    lookup window, so collapsing anchors would lose continuations whose
    boundary differs from the best-scoring one.  All anchors share the
    same device g/beg row (one scan)."""
    lat = st.lattice
    rest = st.rest
    scored = []
    for t, gt in zip(anchor_ts, gvals):
        if gt <= NEG_HALF:
            continue
        r = rest[t]
        if not np.isfinite(r):
            continue
        scored.append((gt + r, t, gt))
    scored.sort(reverse=True)
    keep = scored[:MAX_ANCHORS]
    fin = [s for s in scored if s[1] == lat.T - 1]
    if fin and fin[0] not in keep:
        keep = keep[:-1] + fin[:1]      # completion anchor always kept
    stack = st.stack
    M = lat.M
    for prio, t, gt in keep:
        if len(stack) >= cfg.stack_size * 4:
            stack.sort()
            del stack[cfg.stack_size:]
            heapq.heapify(stack)
        heapq.heappush(stack, (-prio, next(seqc), hyp, t, t2m[t], gt))


def _finalize_all(utts: List[Optional[_UttState]],
                  dispatcher: ScanDispatcher,
                  cfg: SearchConfig) -> List[List[NBestResult]]:
    """Backtrack refined word boundaries through the device beg rows —
    one batched fetch for every completed hypothesis of every
    utterance."""
    want: List[int] = []
    for st in utts:
        if st is None:
            continue
        for (h, _) in st.results:
            want.extend(hd.row for hd in h.rows)
    begs = dispatcher.fetch_beg(want)
    pos = 0
    out: List[List[NBestResult]] = []
    for st in utts:
        if st is None:
            out.append([])
            continue
        results = []
        for (h, exact) in st.results:
            n = len(h.rows)
            rows = begs[pos:pos + n]
            pos += n
            T = st.lattice.T
            bounds: List[Tuple[int, int]] = []
            e = T - 1
            for wi in range(n - 1, -1, -1):
                b0 = int(rows[wi][e]) if e >= 0 else 0
                b0 = max(0, min(b0, e))
                bounds.append((b0, e))
                e = b0 - 1
            bounds.reverse()
            results.append(NBestResult(
                word_ids=list(h.words),
                score=exact,
                am_score=exact - h.lm_sum,
                lm_score=h.lm_sum,
                bounds=bounds,
            ))
        results.sort(key=lambda r: -r.score)
        out.append(results[:cfg.nbest])
    return out
