"""Pass-2 acoustic re-scan: batched per-word seeded Viterbi (scan_word).

Port of `julius_tpu/search/scan.py`.  The reference's second pass
re-runs a per-word Viterbi for every hypothesis expansion against the
whole-utterance outprob cache (`libjulius/src/search_bestfirst_v1.c:589`
scan_word): a hypothesis carries g[t], its best score for every possible
boundary frame t, and attaching word w computes
g'[t] = max_tau ( g[tau-1] + Viterbi(w, frames tau..t) ), which
re-derives the word's acoustic score and its boundary exactly instead of
freezing both at the pass-1 approximation.

Word chains are slices of the flat decode network (search/network.py),
so in-word arcs have local span (dst - src <= KL) and the per-frame
update is KL+1 shifted adds.  Whole-vocabulary chain tables live on the
engine's device (`DeviceChainTables`); one scan advances K chains over a
W-frame window each, in one launch of the hand-written kernel
(ops/scan_kernel.py, csrc/scan_win.cu).  The full-utterance forms
(`scan_words`, `scan_words_store`, over host `ChainCache` rows) are the
same launch with every window at frame 0 and W = T.

Indexing rules: JAX clamps out-of-range gather indices, drops
out-of-range scatter writes and fills out-of-range `take_along_axis`
reads (NaN, or the integer minimum), and wraps negative indices once,
where torch raises on the CPU and faults on the card.  Every index here
is clamped, redirected or masked explicitly to give JAX's result (see
`scan_words_store_win`, `scan_words_store`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.ops.scan_kernel import scan_core_win
from julius_tpu_torch.search.network import DecodeNetwork
from julius_tpu_torch.search.pass1 import GraphCache
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2

#: K buckets for one scan dispatch (pads up)
K_BUCKETS = (16, 64, 256, 1024)

#: frame-window buckets for windowed dispatches (scan_words_store_win);
#: spans past the last bucket scan the full utterance
W_BUCKETS = (64, 256)


def bucket_k(k: int) -> int:
    for b in K_BUCKETS:
        if k <= b:
            return b
    return -(-k // K_BUCKETS[-1]) * K_BUCKETS[-1]


def bucket_w(span: int, T: int) -> int:
    """Window bucket covering `span` frames (capped at the utterance)."""
    for b in W_BUCKETS:
        if span <= b:
            return min(b, T)
    return T


class ChainCache:
    """Per-word chain tables sliced from the flat decode network, on the
    host.

    Lazy per word: large vocabularies only pay for words that actually
    appear in a trellis.  All tables are padded to the vocabulary's
    longest word (`nmax` nodes) so one scan covers any mix; a word's
    rows equal its `DeviceChainTables` rows."""

    def __init__(self, net: DecodeNetwork):
        self.net = net
        ofs = net.word_node_ofs
        self.nmax = int(np.max(np.diff(ofs))) if len(ofs) > 1 else 1
        # in-word arc span bound (the flat network has no cross-word
        # arcs, so this is exactly pass 1's local_k)
        N, Din = net.in_src.shape
        valid = net.in_lp > NEG_HALF
        span = (np.arange(N, dtype=np.int64)[:, None]
                - net.in_src.astype(np.int64))
        if valid.any():
            smax, smin = int(span[valid].max()), int(span[valid].min())
        else:
            smax = smin = 0
        if smin < 0:
            raise ValueError("decode network has backward in-word arcs; "
                             "scan_word requires a left-to-right lexicon")
        self.kl = smax
        self._rows: Dict[int, Tuple[np.ndarray, ...]] = {}

    def _build(self, w: int):
        net = self.net
        n0 = int(net.word_node_ofs[w])
        n1 = int(net.word_node_ofs[w + 1])
        nw = n1 - n0
        nm, kl = self.nmax, self.kl
        loc = np.full((kl + 1, nm), LOG_ZERO, dtype=np.float32)
        src = net.in_src[n0:n1].astype(np.int64) - n0
        lp = net.in_lp[n0:n1]
        dst = np.arange(nw, dtype=np.int64)[:, None]
        ok = lp > NEG_HALF
        ii, dd = np.nonzero(ok)
        np.maximum.at(loc, ((dst - src)[ii, dd], ii), lp[ii, dd])
        ent = np.full(nm, LOG_ZERO, dtype=np.float32)
        ent[:nw] = net.entry_lp[n0:n1]
        ext = np.full(nm, LOG_ZERO, dtype=np.float32)
        ext[:nw] = net.exit_lp[n0:n1]
        sidx = np.zeros(nm, dtype=np.int32)
        sidx[:nw] = net.score_idx[n0:n1]
        return loc, ent, ext, sidx

    def rows(self, word_ids) -> Tuple[np.ndarray, ...]:
        """Stack chain tables for a list of word ids (pad id -1 = dead
        chain that scores LOG_ZERO everywhere): (loc [K, KL+1, nmax],
        ent, ext [K, nmax] f32, sidx [K, nmax] i32)."""
        locs, ents, exts, sidxs = [], [], [], []
        dead = None
        for w in word_ids:
            if w < 0:
                if dead is None:
                    dead = (np.full((self.kl + 1, self.nmax), LOG_ZERO,
                                    np.float32),
                            np.full(self.nmax, LOG_ZERO, np.float32),
                            np.full(self.nmax, LOG_ZERO, np.float32),
                            np.zeros(self.nmax, np.int32))
                r = dead
            else:
                r = self._rows.get(w)
                if r is None:
                    r = self._build(w)
                    self._rows[w] = r
            locs.append(r[0])
            ents.append(r[1])
            exts.append(r[2])
            sidxs.append(r[3])
        return (np.stack(locs), np.stack(ents), np.stack(exts),
                np.stack(sidxs))


#: DeviceChainTables tensor fields, with their dtypes (convert.py reads
#: the reference's tables by these names)
CHAIN_FIELDS = {"loc": torch.float32, "ent": torch.float32,
                "ext": torch.float32, "sidx": torch.int32}


class DeviceChainTables:
    """Whole-vocabulary chain tables on one device (word id V = a dead
    pad chain that scores LOG_ZERO everywhere).  One build, then every
    scan gathers its K chains on the device from word ids.

    loc [V+1, KL+1, nmax] shifted in-word arc ln p; ent / ext
    [V+1, nmax] word entry / exit ln p; sidx [V+1, nmax] outprob
    columns; every chain padded to the longest word's `nmax` nodes."""

    def __init__(self, net: DecodeNetwork, device):
        ofs = np.asarray(net.word_node_ofs, dtype=np.int64)
        V = len(ofs) - 1
        nw = np.diff(ofs)
        nmax = int(nw.max()) if V else 1
        N, Din = net.in_src.shape
        valid = net.in_lp > NEG_HALF
        span = (np.arange(N, dtype=np.int64)[:, None]
                - net.in_src.astype(np.int64))
        if valid.any():
            if int(span[valid].min()) < 0:
                raise ValueError("decode network has backward in-word "
                                 "arcs; scan_word needs left-to-right")
            kl = int(span[valid].max())
        else:
            kl = 0
        node_word = np.repeat(np.arange(V, dtype=np.int64), nw)
        local = np.arange(N, dtype=np.int64) - ofs[node_word]
        loc = np.full((V + 1, kl + 1, nmax), LOG_ZERO, dtype=np.float32)
        ii, dd = np.nonzero(valid)
        np.maximum.at(
            loc, (node_word[ii], span[ii, dd], local[ii]),
            net.in_lp[ii, dd])
        ent = np.full((V + 1, nmax), LOG_ZERO, dtype=np.float32)
        ext = np.full((V + 1, nmax), LOG_ZERO, dtype=np.float32)
        sidx = np.zeros((V + 1, nmax), dtype=np.int32)
        ent[node_word, local] = net.entry_lp
        ext[node_word, local] = net.exit_lp
        sidx[node_word, local] = net.score_idx
        self._install(dict(loc=loc, ent=ent, ext=ext, sidx=sidx), kl, nmax,
                      V, device)

    def _install(self, arrays, kl: int, nmax: int, n_words: int, device):
        for name, dt in CHAIN_FIELDS.items():
            setattr(self, name, torch.as_tensor(
                np.array(arrays[name]), dtype=dt, device=device))
        self.kl, self.nmax, self.n_words = int(kl), int(nmax), int(n_words)
        # the device A*'s captured rounds on these tables (a CUDA card)
        self.graphs = GraphCache()

    @classmethod
    def from_numpy(cls, arrays, kl: int, nmax: int, n_words: int,
                   device) -> "DeviceChainTables":
        """Tables from host arrays keyed by CHAIN_FIELDS names."""
        self = cls.__new__(cls)
        self._install(arrays, kl, nmax, n_words, device)
        return self


def head_substituted_sidx(sidx: torch.Tensor, wids: torch.Tensor,
                          lcc: torch.Tensor, head_sidx: torch.Tensor,
                          head_ns: torch.Tensor) -> torch.Tensor:
    """Strict inter-word CD (v2, search/iwcd2.py): each chain's senone
    map [K, N] with its head phone's columns replaced by those of word
    wids[k] after left-context class lcc[k] (class 0 keeps the v1
    pseudo columns).  Left unchanged: nodes past the word's head phone."""
    H = head_sidx.shape[-1]
    lcc = lcc.clamp(0, head_sidx.shape[1] - 1)
    over = head_sidx[wids, lcc]                                   # [K, H]
    jj = torch.arange(H, device=sidx.device)[None, :]
    over = torch.where(jj < head_ns[wids][:, None], over, sidx[:, :H])
    return torch.cat([over, sidx[:, H:]], dim=1).contiguous()


def _full_scan(loc, ent, ext, sidx, seed, bidx, out_ext):
    """One launch of the windowed scan with every window the whole
    utterance (t0 = 0, W = T): (g, beg, sv) [K, T]."""
    K = seed.shape[0]
    t0 = torch.zeros(K, dtype=torch.int32, device=seed.device)
    return scan_core_win(
        loc.to(torch.float32).contiguous(), ent.to(torch.float32).contiguous(),
        ext.to(torch.float32).contiguous(), sidx.to(torch.int32).contiguous(),
        seed.to(torch.float32).contiguous(),
        out_ext.to(torch.float32).contiguous(),
        bidx.to(torch.int32).contiguous(), t0)


def scan_words(loc: torch.Tensor, ent: torch.Tensor, ext: torch.Tensor,
               sidx: torch.Tensor, seed: torch.Tensor, bidx: torch.Tensor,
               out_ext: torch.Tensor):
    """Advance K word chains over the whole utterance in one scan.

    loc   [K, KL+1, N]  shifted in-word arc scores (ln)
    ent   [K, N]        word-entry ln p (LOG_ZERO on non-entry nodes)
    ext   [K, N]        word-exit ln p
    sidx  [K, N]        columns of the extended outprob table
    seed  [K, T]        score available for *entering* at frame t
                        (prev hypothesis score at t-1, LM already added)
    bidx  [K]           utterance index of each chain into out_ext
    out_ext [B, T, R]   whole-batch outprob cache

    Returns (g [K, T], beg [K, T] int32): g[k, t] = best score with the
    word ending exactly at frame t; beg[k, t] = the entry frame of that
    best path (the refined word-begin boundary).  One launch of the
    scan kernel on the card (ops/scan_kernel.py), its plain version on
    the CPU."""
    g, beg, _ = _full_scan(loc, ent, ext, sidx, seed, bidx, out_ext)
    return g, beg


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] as a JAX gather reads it: a negative index wraps once, then
    every index is clamped into range."""
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x[idx]


def _take_along_fill(x: torch.Tensor, idx: torch.Tensor, fill):
    """jnp.take_along_axis(x, idx, axis=1): a negative index wraps once;
    an index still out of range reads `fill`."""
    n = x.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, x.gather(1, idx.clamp(0, n - 1)),
                       torch.full_like(x[:, :1], fill))


def scan_words_store(g_store: torch.Tensor, beg_store: torch.Tensor,
                     loc_all: torch.Tensor, ent_all: torch.Tensor,
                     ext_all: torch.Tensor, sidx_all: torch.Tensor,
                     wids: torch.Tensor, parents: torch.Tensor,
                     lm_adds: torch.Tensor, bidx: torch.Tensor,
                     out_rows: torch.Tensor, anchors: torch.Tensor,
                     out_ext: torch.Tensor, scan_beam: float = 0.0):
    """Device-resident A* round over the whole utterance: seeds come from
    stored parent g rows, results go back into the store, and only the
    anchor-frame scores come back.

    g_store / beg_store [CAP, T]; loc_all ... sidx_all whole-vocabulary
    chain tables (`DeviceChainTables` fields); wids / parents / lm_adds /
    bidx / out_rows [K]; anchors [K, A] frame indices; out_ext [B, T, R].
    parents < 0 = the word starts the sentence (seed = lm_add at frame
    0).  Returns (g_store', beg_store', ganch, banch, sanch), the stores
    written in place and returned, the last three [K, A] at the anchor
    frames: g values, refined word-begin frames, and the seed carried
    from the winning entry (ganch - sanch = the word's local AM + LM
    score, for pass-2 graph words).

    Out-of-range indices behave as in JAX: an out_row outside the store
    (after one negative wrap) drops its write, an anchor outside [0, T)
    reads NaN (banch: the int32 minimum), a word id or parent past the
    table reads the last row."""
    T = g_store.shape[1]
    wids = wids.long()
    loc = _take_rows(loc_all, wids)                   # [K, KL+1, N]
    ent = _take_rows(ent_all, wids)
    ext = _take_rows(ext_all, wids)
    sidx = _take_rows(sidx_all, wids)
    parents = parents.long()
    pg = _take_rows(g_store, parents.clamp(min=0))    # [K, T]
    K = wids.shape[0]
    ext_seed = torch.cat(
        [pg.new_full((K, 1), LOG_ZERO), pg[:, :-1]], dim=1) \
        + lm_adds[:, None]
    if scan_beam > 0.0:
        m = ext_seed.amax(dim=1, keepdim=True)
        ext_seed = torch.where(
            (m > NEG_HALF) & (ext_seed < m - scan_beam),
            LOG_ZERO, ext_seed)
    init_seed = torch.full_like(ext_seed, LOG_ZERO)
    init_seed[:, 0] = lm_adds
    seed = torch.where(parents[:, None] >= 0, ext_seed, init_seed)
    g, beg, sv = _full_scan(loc, ent, ext, sidx, seed, bidx, out_ext)
    cap = g_store.shape[0]
    rows = out_rows.long()
    rows = torch.where(rows < 0, rows + cap, rows)
    keep = (rows >= 0) & (rows < cap)
    g_store[rows[keep]] = g[keep]
    beg_store[rows[keep]] = beg[keep]
    anchors = anchors.long()
    ganch = _take_along_fill(g, anchors, float("nan"))
    banch = _take_along_fill(beg, anchors, torch.iinfo(torch.int32).min)
    sanch = _take_along_fill(sv, anchors, float("nan"))
    return g_store, beg_store, ganch, banch, sanch


def scan_words_store_win(g_store: torch.Tensor, beg_store: torch.Tensor,
                         tabs: DeviceChainTables, ints: torch.Tensor,
                         lm_adds: torch.Tensor, out_ext: torch.Tensor,
                         W: int, scan_beam: float = 0.0,
                         head_sidx: Optional[torch.Tensor] = None,
                         head_ns: Optional[torch.Tensor] = None):
    """Windowed device-resident A* round: seeds come from stored parent g
    rows, results go back into the store, and only the anchor-frame
    scores come back.

    Each chain k scans only frames [t0[k], t0[k] + W); callers guarantee
    t0 + W <= T.  `ints` [K, 6 + A] holds the per-chain integer columns
    (wid, parent_row, bidx, out_row, t0, lcc, anchors[A]); anchors are
    ABSOLUTE frames, and anchors outside the window return LOG_ZERO.
    parent_row < 0 = the word starts the sentence (seed = lm_add at
    frame 0).  lm_adds [K]; out_ext [B, T, R].

    g_store / beg_store [CAP + 1, T] are updated IN PLACE, inside the
    window only.  Their last row is a write sink: a chain whose out_row
    is not a row below it (the pad chains, out_row = CAP) writes there,
    which nothing reads, where JAX drops the write (`mode="drop"`).
    Returns (ganch, banch, sanch) [K, A]: g values, refined word-begin
    frames, and the seed carried from the winning entry.

    With head_sidx [V+1, C, H] / head_ns [V+1] (strict inter-word CD),
    each chain's head columns follow its left-context class lcc."""
    ints = ints.long()
    wids, parents, bidx = ints[:, 0], ints[:, 1], ints[:, 2]
    out_rows, t0, anchors = ints[:, 3], ints[:, 4], ints[:, 6:]
    sidx = tabs.sidx[wids]
    if head_sidx is not None:
        sidx = head_substituted_sidx(sidx, wids, ints[:, 5], head_sidx,
                                     head_ns)
    cap1, T = g_store.shape
    idx_t = t0[:, None] + torch.arange(W, device=ints.device)   # [K, W]
    # the parent's g one frame before each window frame (JAX clamps the
    # row and frame indices into range: so do these)
    prow = parents.clamp(0, cap1 - 1)
    pgw = g_store[prow[:, None], (idx_t - 1).clamp(0, T - 1)]
    pgw = torch.where(idx_t >= 1, pgw, LOG_ZERO)
    ext_seed = pgw + lm_adds[:, None]
    if scan_beam > 0.0:
        m = ext_seed.amax(dim=1, keepdim=True)
        ext_seed = torch.where(
            (m > NEG_HALF) & (ext_seed < m - scan_beam),
            LOG_ZERO, ext_seed)
    init_seed = torch.where(idx_t == 0, lm_adds[:, None], LOG_ZERO)
    seed = torch.where(parents[:, None] >= 0, ext_seed, init_seed)
    g, beg, sv = scan_core_win(
        tabs.loc[wids], tabs.ent[wids], tabs.ext[wids], sidx,
        seed.contiguous(), out_ext, bidx.to(torch.int32),
        t0.to(torch.int32))
    sink = cap1 - 1
    rows = torch.where((out_rows >= 0) & (out_rows < sink), out_rows, sink)
    g_store[rows[:, None], idx_t] = g
    beg_store[rows[:, None], idx_t] = beg
    rel = (anchors - t0[:, None]).clamp(0, W - 1)
    ok = (anchors >= t0[:, None]) & (anchors < t0[:, None] + W)
    ganch = torch.where(ok, g.gather(1, rel), LOG_ZERO)
    banch = torch.where(ok, beg.gather(1, rel), 0)
    sanch = torch.where(ok, sv.gather(1, rel), LOG_ZERO)
    return ganch, banch, sanch


def scan_words_ref(loc: np.ndarray, ent: np.ndarray, ext: np.ndarray,
                   sidx: np.ndarray, seed: np.ndarray,
                   out_rows: np.ndarray):
    """Brute-force numpy reference of the word scan for ONE chain over
    the whole utterance (tests): out_rows [T, R] for the chain's
    utterance, seed [T]."""
    KLp1, N = loc.shape
    T = out_rows.shape[0]
    g = np.full(T, LOG_ZERO, np.float32)
    beg = np.zeros(T, np.int32)
    sc = np.full(N, LOG_ZERO, np.float32)
    efr = np.zeros(N, np.int32)
    for t in range(T):
        mx = np.full(N, LOG_ZERO, np.float32)
        src_k = np.zeros(N, np.int64)
        for k in range(KLp1):
            shifted = np.full(N, LOG_ZERO, np.float32)
            if k == 0:
                shifted = sc.copy()
            else:
                shifted[k:] = sc[:-k]
            cand = shifted + loc[k]
            better = cand > mx
            mx = np.where(better, cand, mx)
            src_k = np.where(better, k, src_k)
        nefr = np.zeros(N, np.int32)
        for i in range(N):
            j = i - src_k[i]
            nefr[i] = efr[j] if 0 <= j < N else 0
        ent_t = seed[t] + ent
        enter = ent_t > mx
        base = np.maximum(ent_t, mx)
        outg = out_rows[t][sidx]
        sc = np.where(base > NEG_HALF, base + outg, LOG_ZERO)
        efr = np.where(enter, t, nefr)
        endv = np.where(sc > NEG_HALF, sc + ext, LOG_ZERO)
        an = int(np.argmax(endv))
        g[t] = endv[an]
        beg[t] = efr[an]
    return g, beg
