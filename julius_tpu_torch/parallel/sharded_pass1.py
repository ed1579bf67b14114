"""Sharded pass 1: the decode network partitioned across devices (torch).

Port of `julius_tpu/parallel/sharded_pass1.py`.  The node axis splits
into **word-aligned** contiguous shards (words never span shards, so the
shift-structured in-word update needs no halo exchange), one a device of
a mesh row.  Each frame:

  1. every shard corrects ALL its word-end exits with the exact 2-gram
     and keeps its own top M (`_local_candidates`);
  2. one all-gather brings every shard's candidates to every shard (a
     concatenation on each shard's device, the frame's only collective);
  3. every shard re-ranks the gathered candidates into the frame's M
     trellis atoms, picks the cross-word winner and advances its own
     nodes (`_local_step`); the re-rank is replicated, so every shard
     derives the same atoms and entry.

Unlike the single-device step, which corrects only the best 2M exits
by their raw scores, step 1 corrects every exit before the cut, as the
reference's sharded step does; where more than 2M words end in a frame
the two may keep different atoms.  Ties go to the lowest index at each
top-k (stable sorts), as `lax.top_k` gives them, so the shards' order
in the gather is the exits' global order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.parallel.mesh import Mesh, all_gather, replicate
from julius_tpu_torch.search.network import DecodeNetwork
from julius_tpu_torch.search.ngram_device import DeviceNgram, bigram_score
from julius_tpu_torch.search.pass1 import (NEG_HALF, DeviceNetwork,
                                           Pass1Config, Trellis, topk_stable)
from julius_tpu_torch.utils.logadd import LOG_ZERO


@dataclass
class ShardedNetwork:
    """Stacked per-shard tables ([S, ...] leading shard axis) and the
    replicated per-word ones, on one device until `sharded_pass1` places
    each shard on its own."""

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


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    if k == 0:
        return x
    return torch.cat([x.new_full((k,), fill), x[:-k]])


def _local_step(sh: _Shard, cfg: Pass1Config, state, gathered, out_row,
                frame_valid: bool):
    """One frame on one shard after the all-gather: the replicated
    re-rank of the gathered candidates into the frame's atoms, the
    shard-local in-word propagation, the cross-word entry (the same
    winner on every shard) and the emission.  Returns the new state and
    the [M] atoms."""
    score, ctx, prev, t0 = state
    t = t0 + 1
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

    # cross-word entry: the first best valid atom, the same on every shard
    valid = atoms.word >= 0
    vs = torch.where(valid, atoms.score, LOG_ZERO)
    slots = torch.arange(M, device=vs.device)
    best = torch.where(vs == vs.max(), slots, M).min()
    ok = valid[best]
    ent = torch.where(ok, atoms.score[best], LOG_ZERO)
    ectx_new = torch.where(ok, atoms.ectx[best], -1)
    prev_new = ((t - 1) * M + best).to(torch.int32)
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
    if not frame_valid:
        return state, atoms
    return (new_score, nctx.to(torch.int32), nprev.to(torch.int32), t), atoms


def sharded_pass1(mesh: Mesh, snet: ShardedNetwork,
                  ngram: Optional[DeviceNgram], cfg: Pass1Config,
                  out_ext: torch.Tensor, n_frames: int) -> Trellis:
    """Decode one utterance with the network's shards on the devices of
    the mesh's first row (one a shard; the row must have n_shards
    devices).  out_ext: [T, R] score rows.  Returns the [T, M] Trellis
    on the row's first device."""
    devices = mesh.devices[0]
    if len(devices) != snet.n_shards:
        raise ValueError(f"{snet.n_shards} shards on a mesh row of "
                         f"{len(devices)} devices")
    shards = [_Shard(snet, s, d, ngram) for s, d in enumerate(devices)]
    n_frames = int(n_frames)
    T = out_ext.shape[0]
    rows = [out_ext.to(torch.float32).to(d) for d in devices]
    states = []
    for sh, r in zip(shards, rows):
        # enter the head word on the nodes this shard owns
        ew = sh.entry_word
        enter = ew == snet.head_word if cfg.crossword else ew >= 0
        w0 = ew.clamp(min=0).long()
        score0 = torch.where(enter, sh.entry_lp + sh.word_entry_lm[w0]
                             + r[0][sh.score_idx], LOG_ZERO)
        neg = torch.full(score0.shape, -1, dtype=torch.int32,
                         device=sh.device)
        states.append((score0, neg, neg.clone(), 0))
    out = []
    for tt in range(1, T + 1):
        local = [_local_candidates(sh, cfg, *st[:3])
                 for sh, st in zip(shards, states)]
        frame_valid = tt < n_frames
        new = []
        for s, (sh, st) in enumerate(zip(shards, states)):
            gathered = [all_gather([c[i] for c in local], sh.device)
                        for i in range(5)]
            row = (rows[s][tt] if tt < T
                   else torch.zeros_like(rows[s][0]))
            nst, atoms = _local_step(sh, cfg, st, gathered, row, frame_valid)
            new.append(nst)
            if s == 0:
                out.append(atoms)
        states = new
    trellis = Trellis(*[torch.stack(f) for f in zip(*out)])
    atom_ok = (torch.arange(T, device=devices[0]) < n_frames)[:, None] \
        & (trellis.word >= 0)
    return trellis._replace(word=torch.where(atom_ok, trellis.word, -1))
