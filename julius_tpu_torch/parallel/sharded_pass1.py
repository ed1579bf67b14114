"""Sharded pass 1: the decode network partitioned across devices (torch).

Port of `julius_tpu/parallel/sharded_pass1.py`.  The node axis splits
into **word-aligned** contiguous shards (words never span shards, so the
shift-structured in-word update needs no halo exchange), one a device of
a mesh row.  Each frame:

  A. every shard corrects ALL its word-end exits with the exact 2-gram
     and keeps its own top M (`_local_candidates`), packed into one
     int32 block (`_pack`: score, word, ctx, prev, lm; the floats' bits);
  B. one all-gather brings every shard's block to every card, shard-major
     as `lax.all_gather` orders it (the frame's only collective);
  C. every shard re-ranks the gathered candidates into the frame's M
     trellis atoms, picks the cross-word winner and advances its own
     nodes (`_local_step`); the re-rank is replicated, so every shard
     derives the same atoms and entry.

Unlike the single-device step, which corrects only the best 2M exits
by their raw scores, step A corrects every exit before the cut, as the
reference's sharded step does; where more than 2M words end in a frame
the two may keep different atoms.  Ties go to the lowest index at each
top-k (stable sorts), as `lax.top_k` gives them, so the shards' order
in the gather is the exits' global order.

The frame runs over fixed tensors (`_Loop`): each shard's state, and on
each card (a distinct device of the row) the scan position, the state's
frame, the frame count, the outprob rows and the gather buffer, with
no host value inside the step.  The reference compiles its frame loop
into one device program (a `shard_map`'d `lax.scan`); on CUDA cards
the step is captured as CUDA graphs and replayed once a frame
(`_graphed`).  Where the whole row is one card, as on a mesh that
repeats it, A, the gather (a write into the card's own buffer) and C
are one graph, one replay a frame; across cards each card has two
graphs, A and C, and the gather is one copy of each run of a card's
blocks into every other card's buffer between the replays.  The CPU,
and `eager=True` on a card, run the same step once a frame from Python.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.parallel.mesh import Mesh, replicate
from julius_tpu_torch.search.network import DecodeNetwork
from julius_tpu_torch.search.ngram_device import DeviceNgram, bigram_score
from julius_tpu_torch.search.pass1 import (MIN_T_BUCKET, NEG_HALF,
                                           TRELLIS_DTYPES, DeviceNetwork,
                                           GraphCache, Pass1Config, Trellis,
                                           _capture, count_frames,
                                           topk_stable)
from julius_tpu_torch.utils.logadd import LOG_ZERO

#: captured frame steps (and shard placements) kept a network, the
#: oldest dropped past it
GRAPHS_KEPT = 4


@dataclass
class ShardedNetwork:
    """Stacked per-shard tables ([S, ...] leading shard axis) and the
    replicated per-word ones, on one device until `sharded_pass1` places
    each shard on its own.  `caches` (not a field: a copy by
    dataclasses.replace starts its own) keeps what `sharded_pass1`
    builds for it: the shards placed on a mesh row's devices and the
    captured frame steps."""

    score_idx: torch.Tensor     # [S, Ns] i64
    loc_lp: torch.Tensor        # [S, K+1, Ns]
    entry_word: torch.Tensor    # [S, Ns] global word ids (-1 pad)
    entry_lp: torch.Tensor      # [S, Ns]
    exit_nodes: torch.Tensor    # [S, Ex] i64 local node ids (pad 0)
    exit_w: torch.Tensor        # [S, Ex] global word ids (-1 pad)
    exit_nlp: torch.Tensor      # [S, Ex] (LOG_ZERO pad)
    word_entry_lm: torch.Tensor  # [V] replicated
    wid2lm: torch.Tensor        # [V]
    transparent: torch.Tensor   # [V]
    head_word: int
    tail_word: int
    n_shards: int
    local_k: int

    def __post_init__(self):
        self.caches = _Caches()


class _Caches:
    """A sharded network's shards placed per (mesh row, N-gram), at most
    GRAPHS_KEPT, and a `GraphCache` a card for its captured frame steps
    (a pool and a side stream are a card's); `lock` guards both dicts."""

    def __init__(self):
        self.lock = threading.Lock()
        self.placed = {}
        self.graphs: Dict[torch.device, GraphCache] = {}


def partition_network(net: DecodeNetwork, dev: DeviceNetwork,
                      n_shards: int) -> ShardedNetwork:
    """Split the flat network into word-aligned contiguous shards of
    nearly equal node count.

    `dev` is the single-device DeviceNetwork (for word_entry_lm etc.).
    Requires the local fast path (dev.local_k >= 0)."""
    if dev.local_k < 0:
        raise ValueError("sharded pass-1 needs the local fast path")
    ofs = np.asarray(net.word_node_ofs)
    N = net.n_nodes
    # contiguous word ranges with ~equal node counts
    targets = [round(N * (i + 1) / n_shards) for i in range(n_shards)]
    cuts = [0]
    for tgt in targets[:-1]:
        w = int(np.searchsorted(ofs, tgt))
        w = min(w, len(ofs) - 1)
        cuts.append(max(int(ofs[w]), cuts[-1]))    # monotonic, word-aligned
    cuts.append(N)
    sizes = [cuts[i + 1] - cuts[i] for i in range(n_shards)]
    Ns = max(max(sizes), 1)
    K = dev.local_k
    loc_full = dev.loc_lp.cpu().numpy()

    s_idx = np.zeros((n_shards, Ns), dtype=np.int64)
    s_loc = np.full((n_shards, K + 1, Ns), LOG_ZERO, dtype=np.float32)
    s_ew = np.full((n_shards, Ns), -1, dtype=np.int32)
    s_el = np.full((n_shards, Ns), LOG_ZERO, dtype=np.float32)
    exit_lists: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for i in range(n_shards):
        a, b = cuts[i], cuts[i + 1]
        n = b - a
        s_idx[i, :n] = net.score_idx[a:b]
        s_loc[i, :, :n] = loc_full[:, a:b]
        # arcs are word-internal, so none may enter a shard's first k
        # nodes from the previous shard's tail
        for k in range(1, K + 1):
            if n >= k and np.any(s_loc[i, k, :k] > NEG_HALF):
                raise AssertionError("arc crosses word-aligned shard cut")
        s_ew[i, :n] = net.entry_word[a:b]
        s_el[i, :n] = net.entry_lp[a:b]
        ex = np.flatnonzero(net.exit_word[a:b] >= 0)
        exit_lists.append((ex, net.exit_word[a:b][ex],
                           net.exit_lp[a:b][ex]))
    Ex = max(max(len(e[0]) for e in exit_lists), 1)
    s_xn = np.zeros((n_shards, Ex), dtype=np.int64)
    s_xw = np.full((n_shards, Ex), -1, dtype=np.int32)
    s_xl = np.full((n_shards, Ex), LOG_ZERO, dtype=np.float32)
    for i, (en, ew, el) in enumerate(exit_lists):
        s_xn[i, :len(en)] = en
        s_xw[i, :len(en)] = ew
        s_xl[i, :len(en)] = el
    d = dev.word_entry_lm.device
    t = lambda a: torch.as_tensor(a, device=d)  # noqa: E731
    return ShardedNetwork(
        score_idx=t(s_idx), loc_lp=t(s_loc), entry_word=t(s_ew),
        entry_lp=t(s_el), exit_nodes=t(s_xn), exit_w=t(s_xw),
        exit_nlp=t(s_xl), word_entry_lm=dev.word_entry_lm,
        wid2lm=dev.wid2lm, transparent=dev.transparent,
        head_word=dev.head_word, tail_word=dev.tail_word,
        n_shards=n_shards, local_k=dev.local_k)


class _Shard:
    """One shard's tables and the replicated ones, on its device."""

    def __init__(self, snet: ShardedNetwork, s: int, device: torch.device,
                 ngram: Optional[DeviceNgram]):
        self.device = device
        for name in ("score_idx", "loc_lp", "entry_word", "entry_lp",
                     "exit_nodes", "exit_w", "exit_nlp"):
            setattr(self, name, getattr(snet, name)[s].to(device))
        for name in ("word_entry_lm", "wid2lm", "transparent"):
            setattr(self, name, getattr(snet, name).to(device))
        self.ngram = replicate(ngram, device)
        self.local_k = snet.local_k


def _placed(snet: ShardedNetwork, row: Tuple[torch.device, ...],
            ngram: Optional[DeviceNgram]) -> List[_Shard]:
    """The shards on the row's devices, placed once per (row, N-gram);
    the entry holds the N-gram, whose id is in the key."""
    key, kept = (row, id(ngram)), snet.caches
    with kept.lock:
        hit = kept.placed.pop(key, None)
        if hit is None:
            while len(kept.placed) >= GRAPHS_KEPT:
                del kept.placed[next(iter(kept.placed))]
            hit = (ngram, [_Shard(snet, s, d, ngram)
                           for s, d in enumerate(row)])
        kept.placed[key] = hit
    return hit[1]


def _local_candidates(sh: _Shard, cfg: Pass1Config, score, ctx, prev):
    """The shard's word-end candidates: every exit corrected with the
    exact 2-gram (matching pass1.py `_word_end_candidates`), then its
    own top M.  (score, word, ctx, prev, lm) [k] each."""
    M = cfg.n_atoms
    cand = score[sh.exit_nodes] + sh.exit_nlp                   # [Ex]
    w_all = sh.exit_w
    ctx_all = ctx[sh.exit_nodes]
    prev_all = prev[sh.exit_nodes]
    wq_all = w_all.clamp(min=0).long()
    if cfg.use_lm and sh.ngram is not None:
        w_lm = torch.where(w_all >= 0, sh.wid2lm[wq_all], -1)
        v_lm = torch.where(ctx_all >= 0,
                           sh.wid2lm[ctx_all.clamp(min=0).long()], -1)
        wq_lm = w_lm.clamp(min=0)
        bi = bigram_score(sh.ngram, v_lm, wq_lm)
        uni = sh.ngram.uni[wq_lm]
        delta = torch.where(w_lm >= 0, cfg.lm_weight * (bi - uni), 0.0)
        lm_all = torch.where(w_lm >= 0, cfg.lm_weight * bi + cfg.lm_penalty,
                             cfg.lm_penalty)
    else:
        delta = torch.zeros_like(cand)
        lm_all = torch.full_like(cand, cfg.lm_penalty)
    corr = torch.where(cand > NEG_HALF, cand + delta, LOG_ZERO)
    corr = torch.where(w_all >= 0, corr, LOG_ZERO)            # pad lanes
    sc_l, ei_l = topk_stable(corr, min(M, corr.shape[0]))
    return (sc_l, w_all[ei_l], ctx_all[ei_l], prev_all[ei_l],
            lm_all[ei_l].to(torch.float32))


def _pack(cands) -> torch.Tensor:
    """A shard's candidates as one [5, k] int32 block, the float fields
    (score, lm) by their bits, so that the gather is one copy a run of
    shards and gives the floats back exactly."""
    sc, w, ctx, prev, lm = cands
    return torch.stack([sc.view(torch.int32), w, ctx, prev,
                        lm.view(torch.int32)])


def _unpack(blocks: torch.Tensor):
    """[S, 5, k] gathered blocks -> (score, word, ctx, prev, lm) [S * k]
    each, shard-major as `lax.all_gather(...).reshape(-1)` gives them."""
    f = [blocks[:, i].reshape(-1) for i in range(5)]
    return (f[0].view(torch.float32), f[1], f[2], f[3],
            f[4].view(torch.float32))


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    if k == 0:
        return x
    return torch.cat([x.new_full((k,), fill), x[:-k]])


def _local_step(sh: _Shard, cfg: Pass1Config, score, ctx, prev, t,
                gathered, out_row, frame_valid):
    """One frame on one shard after the all-gather: the replicated
    re-rank of the gathered candidates into the frame's atoms, the
    shard-local in-word propagation, the cross-word entry (the same
    winner on every shard) and the emission.  `t` is the state's frame
    and `frame_valid` whether this frame advances it ([1] int32 and
    bool on the shard's device; no host value, so a CUDA graph holds
    it).  Returns the new (score, ctx, prev), the old one where the
    frame is not valid (the reference's `keep`), and the [M] atoms."""
    M = cfg.n_atoms
    sc_g, w_g, ctx_g, prev_g, lm_g = gathered
    m_eff = min(M, sc_g.shape[0])
    csc, order = topk_stable(sc_g, m_eff)
    prev_sel = prev_g[order]
    w_sel = w_g[order]
    ctx_sel = ctx_g[order]
    lm_sc = lm_g[order]
    ectx = torch.where(sh.transparent[w_sel.clamp(min=0).long()], ctx_sel,
                       w_sel)
    pad = M - m_eff
    fields = Trellis(
        word=(torch.where(csc > NEG_HALF, w_sel, -1), -1),
        score=(csc, LOG_ZERO), lm=(lm_sc, 0.0), prev=(prev_sel, -1),
        begin=(torch.where(prev_sel >= 0,
                           torch.div(prev_sel, M, rounding_mode="floor") + 1,
                           0).to(torch.int32), 0),
        ectx=(ectx, -1))
    atoms = Trellis(*[torch.nn.functional.pad(a, (0, pad), value=f)
                      for a, f in fields])

    # in-word propagation (shard-local shifts); ties keep the smallest k
    cands = [_shift(score, k, LOG_ZERO) + sh.loc_lp[k]
             for k in range(sh.local_k + 1)]
    inw = cands[0]
    for c in cands[1:]:
        inw = torch.maximum(inw, c)
    nctx, nprev = ctx, prev
    taken = cands[0] >= inw
    for k in range(1, sh.local_k + 1):
        hit = (cands[k] >= inw) & ~taken
        taken = taken | hit
        nctx = torch.where(hit, _shift(ctx, k, -1), nctx)
        nprev = torch.where(hit, _shift(prev, k, -1), nprev)

    # cross-word entry: the first best valid atom, the same on every
    # shard; read by index_select with a [1] index (indexing by a 0-dim
    # tensor reads it on the host, which a capture cannot hold)
    valid = atoms.word >= 0
    vs = torch.where(valid, atoms.score, LOG_ZERO)
    slots = torch.arange(M, device=vs.device)
    best = torch.where(vs == vs.max(), slots, M).min().reshape(1)
    ok = valid.index_select(0, best)
    ent = torch.where(ok, atoms.score.index_select(0, best), LOG_ZERO)
    ectx_new = torch.where(ok, atoms.ectx.index_select(0, best), -1)
    prev_new = (t * M + best).to(torch.int32)
    ew = sh.entry_word
    cand_e = torch.where(
        ew >= 0, ent + sh.entry_lp + sh.word_entry_lm[ew.clamp(min=0).long()],
        LOG_ZERO)
    use_e = cand_e > inw
    merged = torch.where(use_e, cand_e, inw)
    nctx = torch.where(use_e, ectx_new, nctx)
    nprev = torch.where(use_e, prev_new, nprev)

    new_score = torch.where(merged > NEG_HALF, merged + out_row[sh.score_idx],
                            LOG_ZERO)
    new = (new_score, nctx.to(torch.int32), nprev.to(torch.int32))
    return tuple(torch.where(frame_valid, a, b)
                 for a, b in zip(new, (score, ctx, prev))), atoms


class _Card:
    """One card's fixed tensors: the scan position tt, the state's frame
    t and the frame count ([1] int32 each), the outprob rows of up to
    `cap` frames and a zero row after them, and the [S, 5, k] gather
    buffer (shard s's block at s)."""

    def __init__(self, device, shards: List[int], S: int, k: int, R: int,
                 cap: int):
        self.device = device
        self.shards = shards
        self.tt = torch.empty(1, dtype=torch.int32, device=device)
        self.t = torch.empty_like(self.tt)
        self.n_frames = torch.empty_like(self.tt)
        self.rows = torch.empty((cap + 1, R), dtype=torch.float32,
                                device=device)
        self.gather = torch.empty((S, 5, k), dtype=torch.int32,
                                  device=device)


def _runs(idx: List[int]) -> List[Tuple[int, int]]:
    """Sorted shard indices -> [a, b) runs of consecutive ones."""
    runs = []
    for s in idx:
        if runs and runs[-1][1] == s:
            runs[-1] = (runs[-1][0], s + 1)
        else:
            runs.append((s, s + 1))
    return runs


class _Loop:
    """sharded_pass1's frame loop over fixed tensors: each shard's [Ns]
    state on its device, a `_Card` for each distinct device of the row,
    and the [cap, M] trellis on the row's first.  A frame is `phase_a`
    on every card, `exchange`, then `phase_c` on every card (`step`);
    each writes everything back in place, so CUDA graphs of them replay
    the loop."""

    def __init__(self, snet: ShardedNetwork, shards: List[_Shard],
                 cfg: Pass1Config, R: int, cap: int):
        self.snet, self.shards, self.cfg = snet, shards, cfg
        S, M = len(shards), cfg.n_atoms
        Ns = shards[0].score_idx.shape[0]
        k = min(M, shards[0].exit_nodes.shape[0])
        devs = [sh.device for sh in shards]
        self.cards = [_Card(d, [s for s in range(S) if devs[s] == d], S, k,
                            R, cap) for d in dict.fromkeys(devs)]
        self.state = [(torch.empty(Ns, dtype=torch.float32, device=d),
                       torch.empty(Ns, dtype=torch.int32, device=d),
                       torch.empty(Ns, dtype=torch.int32, device=d))
                      for d in devs]
        self.trellis = Trellis(*[torch.empty((cap, M), dtype=dt,
                                             device=devs[0])
                                 for dt in TRELLIS_DTYPES])
        # the gather: each run of a card's blocks into every other card
        self.copies = [(dst, src, a, b) for dst in self.cards
                       for src in self.cards if src is not dst
                       for a, b in _runs(src.shards)]

    def load(self, out_ext: torch.Tensor, n_frames: int) -> None:
        """Start an utterance: the [T, R] outprob rows with a zero row
        after them, tt = 1, t = 0, and each shard's state after frame 0
        (the head word entered on the nodes it owns, empty payloads)."""
        T = out_ext.shape[0]
        for c in self.cards:
            c.rows[:T].copy_(out_ext)
            c.rows[T].zero_()
            c.tt.fill_(1)
            c.t.zero_()
            c.n_frames.fill_(n_frames)
            for s in c.shards:
                sh, (score, ctx, prev) = self.shards[s], self.state[s]
                ew = sh.entry_word
                enter = ew == self.snet.head_word if self.cfg.crossword \
                    else ew >= 0
                w0 = ew.clamp(min=0).long()
                score.copy_(torch.where(
                    enter, sh.entry_lp + sh.word_entry_lm[w0]
                    + c.rows[0][sh.score_idx], LOG_ZERO))
                ctx.fill_(-1)
                prev.fill_(-1)

    def phase_a(self, c: _Card) -> None:
        """Card c's shards' candidates, each into its block of c's
        gather buffer."""
        for s in c.shards:
            c.gather[s].copy_(_pack(_local_candidates(
                self.shards[s], self.cfg, *self.state[s])))

    def exchange(self) -> None:
        """The all-gather between cards.  A copy from one card to
        another runs on the source's current stream after a two-way
        barrier with the destination's (ATen's device-to-device copy):
        it waits for the source's phase A and the destination's earlier
        work, the destination's phase C waits for it, and the source's
        next phase A follows it on its stream."""
        for dst, src, a, b in self.copies:
            dst.gather[a:b].copy_(src.gather[a:b], non_blocking=True)

    def phase_c(self, c: _Card) -> None:
        """Card c's shards after the gather: frame tt on outprob row tt
        (the zero row after the last frame), the state frozen from frame
        n_frames on, t included; shard 0 writes the atoms into trellis
        row tt - 1, word masked from row n_frames on."""
        gathered = _unpack(c.gather)
        row = c.rows.index_select(0, c.tt)[0]
        valid = c.tt < c.n_frames
        for s in c.shards:
            new, atoms = _local_step(self.shards[s], self.cfg,
                                     *self.state[s], c.t, gathered, row,
                                     valid)
            for buf, x in zip(self.state[s], new):
                buf.copy_(x)
            if s == 0:
                at = (c.tt - 1).long()
                atoms = atoms._replace(word=torch.where(
                    at < c.n_frames, atoms.word, -1))
                for buf, a in zip(self.trellis, atoms):
                    buf.index_copy_(0, at, a[None])
        c.t.copy_(torch.where(valid, c.t + 1, c.t))
        c.tt.add_(1)

    def step(self) -> None:
        for c in self.cards:
            self.phase_a(c)
        self.exchange()
        for c in self.cards:
            self.phase_c(c)

    def result(self, T: int) -> Trellis:
        return Trellis(*[a[:T].clone() for a in self.trellis])


def _eager(snet: ShardedNetwork, shards: List[_Shard],
           ngram: Optional[DeviceNgram], cfg: Pass1Config,
           out_ext: torch.Tensor, n_frames: int) -> Trellis:
    """sharded_pass1 as a Python loop of T frame steps."""
    T, R = out_ext.shape
    loop = _Loop(snet, shards, cfg, R, T)
    loop.load(out_ext, n_frames)
    for _ in range(T):
        loop.step()
    count_frames(T, True)
    return loop.result(T)


class _Graphs:
    """A key's captured frame step: the loop's fixed tensors, one graph
    (the whole step) on a row that is one card, else phase A's and phase
    C's graph a card, and the N-gram, whose id is part of the key."""

    def __init__(self, loop: _Loop, graphs: list, ngram):
        self.loop, self.graphs, self.ngram = loop, graphs, ngram

    def frame(self) -> None:
        """One frame: the replays, with the gather between them."""
        if len(self.graphs) == 1:
            self.graphs[0].replay()
            return
        n = len(self.loop.cards)
        for g in self.graphs[:n]:
            g.replay()
        self.loop.exchange()
        for g in self.graphs[n:]:
            g.replay()


def _graphed(snet: ShardedNetwork, shards: List[_Shard],
             ngram: Optional[DeviceNgram], cfg: Pass1Config,
             out_ext: torch.Tensor, n_frames: int) -> Trellis:
    """sharded_pass1 on CUDA cards: T frames of replays.  The graphs of a
    key (the row, S, Ns, Ex, M, R, the config, the N-gram and a
    power-of-two frame capacity) live in the caches of the row's cards
    (`snet.caches.graphs`), the same entry in each; the first card's
    counts each key's capture once, with its host seconds.  The first
    utterance of a key runs frame 1 while it captures (`_capture`: the
    whole step on a one-card row; else phase A on each card, the
    gather, phase C on each card), then replays T - 1 frames; a later
    one loads and replays T.  Every card's lock is held from the load to
    the trellis copied out.  Past GRAPHS_KEPT entries on a card, the
    oldest is dropped.  A failed capture raises; nothing falls back to
    the eager loop."""
    T, R = out_ext.shape
    row = tuple(sh.device for sh in shards)
    cap = max(MIN_T_BUCKET, 1 << (T - 1).bit_length())
    key = (row, len(shards), shards[0].score_idx.shape[0],
           shards[0].exit_nodes.shape[0], cfg.n_atoms, R, cfg, id(ngram),
           cap)
    cards = list(dict.fromkeys(row))
    kept = snet.caches
    with kept.lock:
        caches = [kept.graphs.setdefault(d, GraphCache()) for d in cards]
    with contextlib.ExitStack() as held:
        for cache in sorted(caches, key=id):
            held.enter_context(cache.lock)
        entry = caches[0].entries.get(key)
        if entry is None:
            for cache in caches:
                while len(cache.entries) >= GRAPHS_KEPT:
                    old = next(iter(cache.entries))
                    for d in set(old[0]):
                        kept.graphs[d].entries.pop(old, None)
            t0 = time.perf_counter()
            loop = _Loop(snet, shards, cfg, R, cap)
            loop.load(out_ext, n_frames)
            pairs = list(zip(caches, loop.cards))

            def capture(cache, c, step):
                with torch.cuda.device(c.device):
                    graph, = _capture(cache, c.device, step)
                    return graph

            if len(cards) == 1:
                graphs = [capture(*pairs[0], loop.step)]
            else:
                graphs = [capture(cache, c, lambda c=c: loop.phase_a(c))
                          for cache, c in pairs]
                loop.exchange()
                graphs += [capture(cache, c, lambda c=c: loop.phase_c(c))
                           for cache, c in pairs]
            entry = _Graphs(loop, graphs, ngram)
            for cache in caches:
                cache.entries[key] = entry
            caches[0].captures += 1
            caches[0].capture_s += time.perf_counter() - t0
            frames = T - 1
        else:
            entry.loop.load(out_ext, n_frames)
            frames = T
        for _ in range(frames):
            entry.frame()
        count_frames(T, True)
        return entry.loop.result(T)


def sharded_pass1(mesh: Mesh, snet: ShardedNetwork,
                  ngram: Optional[DeviceNgram], cfg: Pass1Config,
                  out_ext: torch.Tensor, n_frames: int,
                  eager: bool = False) -> Trellis:
    """Decode one utterance with the network's shards on the devices of
    the mesh's first row (one a shard; the row must have n_shards
    devices).  out_ext: [T, R] score rows; frames from n_frames on
    leave the state as it was, and their atoms hold no word.  Returns
    the [T, M] Trellis on the row's first device.

    On CUDA cards the frames are replays of captured graphs
    (`_graphed`); eager=True runs the same step once a frame from
    Python instead, the graphs' oracle.  The CPU always runs that
    loop."""
    row = mesh.devices[0]
    if len(row) != snet.n_shards:
        raise ValueError(f"{snet.n_shards} shards on a mesh row of "
                         f"{len(row)} devices")
    shards = _placed(snet, row, ngram)
    run = _eager if row[0].type == "cpu" or eager else _graphed
    return run(snet, shards, ngram, cfg, out_ext.to(torch.float32),
               int(n_frames))
