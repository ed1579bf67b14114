"""Pass 1: frame-synchronous Viterbi over the flat decode network (torch).

Port of `julius_tpu/search/pass1.py`.  Every node carries one score +
payload (LM context word, trellis backpointer); each frame

  * emits up to M corrected word-end records ("atoms") for frame t-1:
    the top 2M exits get the exact 2-gram swap for their entry unigram
    (hash probes), then the best M are kept in the [T, M] trellis;
  * advances every node: in-word arcs, the cross-word entry from the
    atoms, the emission, frozen past each utterance's end.

Each frame's word-end stage (the top 2M exits, their 2-gram probes,
the re-rank to M and the cross-word winner) is one call of
ops/word_end_kernel.py `word_end`, a hand-written kernel on a CUDA card
(`word_end_plain` on the CPU).  One frame is `_frame`, over a batch
written out as a leading [B] axis, with the frame index a device tensor
and no host synchronisation inside it.  On the CPU `pass1_batch` calls
it once a frame.  On a CUDA card it runs it as the reference's jitted
`lax.scan` runs its step:
the step is captured as CUDA graphs (`GraphCache`, kept on the
network) and replayed once a frame, advancing its own frame index, so
the host makes one graph launch a frame.  The batch's state lives in
two fixed sets: a frame reads one and writes the other, so no frame
copies the [B, N] state, and the two steps (one a set) are two graphs
replayed in turn.  A stream's chunk
(`pass1_stream_chunk`) runs its own frame body, `_StreamLoop.step`, the
same way: one replay a chunk row.  Where the reference
takes its fused Pallas kernel (`_fused_ok`: a shift-structured network,
cross-word N-gram decoding with unigram factoring or no LM, no DFA, no
score envelope, no per-context head emission rows) each frame picks the
single best atom per utterance as the cross-word winner and launches the
beam-update kernel (ops/pass1_kernel.py).  Every other configuration
runs `pass1_step`, the reference's XLA step in PyTorch: the arc gather
of a general topology, the per-category winners of a DFA grammar, the
per-word 2-gram winners of factoring 2, isolated words (no cross-word
entry), the per-context head emission rows of `head_rc_dynamic` and the
score envelope.  Each reduction the reference makes inside `jax.vmap` is
per utterance here (over a row's own axis, never the batch).

Tie order is part of the result (trellis slot order fixes `prev` ids):
every top-k here and in the word-end stage is a stable descending sort
and every winner a first maximum, so ties go to the lowest index as
`lax.top_k` and `argmax` give them, and payloads are selected by index
gathers, not by one-hot products.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from julius_tpu_torch.ops import pass1_kernel as pk
from julius_tpu_torch.ops import word_end_kernel as we
from julius_tpu_torch.ops.word_end_kernel import (TRELLIS_DTYPES, Trellis,
                                                  topk_stable)
from julius_tpu_torch.search.network import DecodeNetwork
from julius_tpu_torch.search.ngram_device import DeviceNgram, bigram_score
from julius_tpu_torch.utils import trace
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
MAX_LOCAL_K = 8     # max arc span for the shift-structured network
MIN_T_BUCKET = 16   # the shortest frame capacity a captured step holds


class GraphCache:
    """Captured CUDA graphs of one loop body: `pass1_batch`'s frame step
    and a stream's chunk row on one network (here), the device A*'s
    round on one set of chain tables (search/pass2_device.py), the
    alignment Viterbi's frame on one engine (search/align.py), and the
    sharded pass 1's frame step on one card of a sharded network
    (parallel/sharded_pass1.py).

    An entry of pass 1 (`_Graph`: the two frame steps of `_Loop`, or a
    stream's chunk row) is keyed by what fixes its addresses and shapes
    (card, B, the node axis, M, R, the branch, the config, the N-gram,
    and a power-of-two capacity of frames).  Every graph of a cache
    shares one memory pool and one capture stream; `lock` keeps one
    batch at a time on them, since a batch fills the fixed tensors,
    replays and copies its results out.  `captures` and `capture_s`
    count the entries captured and their host seconds (each graph's
    eager first step and capture)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries = {}
        self.pool = None
        self.stream = None
        self.captures = 0
        self.capture_s = 0.0


@dataclass
class DeviceNetwork:
    """Decode network tables on one device.

    A network whose arcs all span dst - src in [0, K], K <= MAX_LOCAL_K,
    has `local_k` = K and `loc_lp[k, i]` = ln p of the arc i-k -> i
    (LOG_ZERO if none), so the incoming-arc max is K+1 shifted adds;
    any other topology has `local_k` = -1, no `loc_lp`, and takes the
    [N, Din] incoming-arc gather."""

    score_idx: torch.Tensor   # [N] i32 node -> outprob row column
    in_src: torch.Tensor      # [N, Din] i64 source node of each in-arc
    in_lp: torch.Tensor       # [N, Din] f32 its ln p (pad: LOG_ZERO)
    loc_lp: Optional[torch.Tensor]  # [K+1, N] f32 shifted-arc scores
    entry_word: torch.Tensor  # [N] i32 vocab word entered here, -1 none
    entry_lp: torch.Tensor    # [N] f32
    # compressed exit-node view: word ends only occur at these nodes
    exit_nodes: torch.Tensor  # [Ex] i64 node ids
    exit_w: torch.Tensor      # [Ex] i32 vocab word id
    exit_nlp: torch.Tensor    # [Ex] f32 exit ln p
    exit_wlm: torch.Tensor    # [Ex] i32 LM word id of exit_w (-1 none)
    exit_uni: torch.Tensor    # [Ex] f32 log10 unigram of exit_w (0 none)
    exit_transp: torch.Tensor  # [Ex] bool: exit word is transparent
    # per-vocab-word LM context row: (LM id as f32, unigram back-off)
    ctx_info: Optional[torch.Tensor]  # [V, 2] f32
    word_entry_lm: torch.Tensor  # [V] f32 lm_weight*log10 uni + penalty
    wid2lm: torch.Tensor      # [V] i64 vocab word -> LM word id, -1 none
    transparent: torch.Tensor  # [V] bool: word passes LM context through
    word_cat: torch.Tensor    # [V] i64 DFA category (grammar mode) or 0
    cpair: Optional[torch.Tensor]     # [C, C] bool: category j may follow i
    cat_init: Optional[torch.Tensor]  # [C] bool: category may start
    cat_final: Optional[torch.Tensor]  # [C] bool: category may end
    # per-context head emission rows (reference outprob_style.c:354
    # AS_RSET dynamic assignment): a word-head node reads the column of
    # its token's LM-context word class; None = the pseudo-set columns
    rc_head: Optional[torch.Tensor]   # [N] i64 row into rc_sidx, -1 fixed
    rc_sidx: Optional[torch.Tensor]   # [NH * C] i64 override columns
    lc_class: Optional[torch.Tensor]  # [V] i64 word -> left-context class
    head_word: int
    tail_word: int
    local_k: int
    rc_C: int = 0             # classes per rc_sidx row
    # pass 1's captured frame steps on a CUDA card (not a table: a copy
    # of the network by dataclasses.replace starts its own)
    graphs: GraphCache = field(default_factory=GraphCache, init=False,
                               repr=False, compare=False)


#: DeviceNetwork tensor fields, with their dtypes (convert.py reads the
#: reference's tables by these names; a field may be None)
NETWORK_FIELDS = {
    "score_idx": torch.int32, "in_src": torch.int64,
    "in_lp": torch.float32, "loc_lp": torch.float32,
    "entry_word": torch.int32, "entry_lp": torch.float32,
    "exit_nodes": torch.int64, "exit_w": torch.int32,
    "exit_nlp": torch.float32, "exit_wlm": torch.int32,
    "exit_uni": torch.float32, "exit_transp": torch.bool,
    "ctx_info": torch.float32, "word_entry_lm": torch.float32,
    "wid2lm": torch.int64, "transparent": torch.bool,
    "word_cat": torch.int64, "cpair": torch.bool, "cat_init": torch.bool,
    "cat_final": torch.bool, "rc_head": torch.int64,
    "rc_sidx": torch.int64, "lc_class": torch.int64,
}


def device_network_from_numpy(arrays, head_word: int, tail_word: int,
                              local_k: int, rc_C: int,
                              device) -> DeviceNetwork:
    """DeviceNetwork from host arrays keyed by NETWORK_FIELDS names."""
    t = {}
    for name, dt in NETWORK_FIELDS.items():
        a = arrays[name]
        t[name] = None if a is None else torch.as_tensor(
            np.array(a), dtype=dt, device=device)
    return DeviceNetwork(**t, head_word=int(head_word),
                         tail_word=int(tail_word), local_k=int(local_k),
                         rc_C=int(rc_C))


def build_device_network(
    net: DecodeNetwork,
    device,
    ngram: Optional[DeviceNgram] = None,
    wid2lm: Optional[np.ndarray] = None,
    lm_weight: float = 8.0,
    lm_penalty: float = 0.0,
    word_cat: Optional[np.ndarray] = None,
    cpair: Optional[np.ndarray] = None,
    cat_init: Optional[np.ndarray] = None,
    cat_final: Optional[np.ndarray] = None,
    transparent: Optional[np.ndarray] = None,
    transparent_penalty: float = 0.0,
    cprob: Optional[np.ndarray] = None,
    rc_tables=None,
) -> DeviceNetwork:
    """Host decode network -> device tables (the reference's
    build_device_network).  `rc_tables` is `iwcd2.build_rc_tables`'
    (rc_head, rc_sidx, lc_class) for per-context head emission rows."""
    V = net.n_words
    if transparent is None:
        transparent = np.zeros(V, dtype=bool)
    pen = np.where(transparent, transparent_penalty, lm_penalty)
    if cprob is not None:
        # class N-gram in-class log10 prob, added unweighted
        pen = pen + np.asarray(cprob, dtype=np.float32)
    uni = bo = None
    if ngram is not None:
        uni = ngram.uni.cpu().numpy()
        bo = ngram.bo_uni.cpu().numpy()
    if ngram is not None and wid2lm is not None:
        w_lm = np.where(wid2lm >= 0, wid2lm, 0)
        entry = lm_weight * np.where(
            wid2lm >= 0, uni[w_lm], LOG_ZERO) + pen
    else:
        wid2lm = np.full(V, -1, dtype=np.int32)
        entry = pen.astype(np.float32)
    exit_nodes = np.flatnonzero(net.exit_word >= 0)
    exit_w = net.exit_word[exit_nodes]
    exit_wlm = np.asarray(wid2lm, dtype=np.int32)[exit_w]
    if ngram is not None:
        exit_uni = np.where(exit_wlm >= 0, uni[np.maximum(exit_wlm, 0)],
                            0.0).astype(np.float32)
    else:
        exit_uni = np.zeros(len(exit_nodes), dtype=np.float32)

    # shift-structured transition tables: valid when every arc has
    # 0 <= dst - src <= MAX_LOCAL_K
    N, Din = net.in_src.shape
    dst = np.tile(np.arange(N, dtype=np.int64)[:, None], (1, Din))
    valid = net.in_lp > (LOG_ZERO / 2)
    span = dst - net.in_src.astype(np.int64)
    local_k = -1
    loc = None
    if valid.any() and np.all(span[valid] >= 0) \
            and np.all(span[valid] <= MAX_LOCAL_K):
        local_k = int(span[valid].max())
        loc = np.full((local_k + 1, N), LOG_ZERO, dtype=np.float32)
        ii, dd = np.nonzero(valid)
        np.maximum.at(loc, (span[ii, dd], ii), net.in_lp[ii, dd])
    ctx_info = None
    if ngram is not None:
        ctx_info = np.stack([
            np.asarray(wid2lm, np.float32),
            np.where(wid2lm >= 0, bo[np.maximum(wid2lm, 0)], 0.0)],
            axis=1).astype(np.float32)
    rc_head = rc_sidx = lc_class = None
    rc_C = 0
    if rc_tables is not None:
        rc_head, rc_sidx, lc_class = rc_tables
        rc_C = int(rc_sidx.shape[1])
        rc_sidx = rc_sidx.reshape(-1)
    arrays = dict(
        score_idx=net.score_idx, in_src=net.in_src, in_lp=net.in_lp,
        loc_lp=loc, entry_word=net.entry_word, entry_lp=net.entry_lp,
        exit_nodes=exit_nodes, exit_w=exit_w,
        exit_nlp=net.exit_lp[exit_nodes], exit_wlm=exit_wlm,
        exit_uni=exit_uni,
        exit_transp=np.asarray(transparent, dtype=bool)[exit_w],
        ctx_info=ctx_info, word_entry_lm=entry, wid2lm=wid2lm,
        transparent=transparent,
        word_cat=(word_cat if word_cat is not None
                  else np.zeros(V, np.int32)),
        cpair=cpair, cat_init=cat_init, cat_final=cat_final,
        rc_head=rc_head, rc_sidx=rc_sidx, lc_class=lc_class)
    return device_network_from_numpy(arrays, net.head_word, net.tail_word,
                                      local_k, rc_C, device)


@dataclass(frozen=True)
class Pass1Config:
    """Static search parameters (reference JCONF_SEARCH pass-1 block)."""

    n_atoms: int = 32           # trellis word-ends kept per frame (M)
    lm_weight: float = 8.0
    lm_penalty: float = 0.0
    beam_width: float = 0.0     # score envelope; 0 = exact dense Viterbi
    use_lm: bool = True         # ngram mode vs grammar/isolated-word
    use_dfa: bool = False       # category-pair constrained cross-word
    crossword: bool = True      # False = isolated word recognition
    # LM factoring at word entry: 1 = unigram at entry + exact 2-gram
    # swap at word end; 2 = exact 2-gram at entry for the top expand_k
    # contexts (context-dependent entry winners)
    factoring: int = 1
    expand_k: int = 8


def fused_ok(dev: DeviceNetwork, cfg: Pass1Config) -> bool:
    """True for the configurations the beam-update kernel serves (the
    reference's `_fused_ok` `supported` expression, pass1.py:581-583)."""
    return (dev.local_k >= 0 and cfg.crossword and not cfg.use_dfa
            and not (cfg.use_lm and cfg.factoring >= 2)
            and cfg.beam_width == 0.0 and dev.rc_head is None)


def entry_total(dev: DeviceNetwork) -> torch.Tensor:
    """[N] entry score of each word-head node (entry ln p + the word's
    weighted unigram and penalty), LOG_ZERO where no word starts."""
    ew = dev.entry_word
    wq = ew.clamp(min=0).long()
    return torch.where(ew >= 0, dev.entry_lp + dev.word_entry_lm[wq],
                       LOG_ZERO)


def kernel_tables(dev: DeviceNetwork):
    """The beam-update kernel's (loc_lp, entry_total, score_idx), the
    node axis padded to a multiple of 4 with LOG_ZERO arcs and entries
    and senone 0, as the reference pads its fused path's to a tile
    multiple: every row of the [B, N] state then starts on a 16-byte
    boundary.  Pad nodes stay LOG_ZERO, and no exit reads them."""
    pad = -dev.loc_lp.shape[1] % 4

    def padded(x, fill):
        return torch.nn.functional.pad(x, (0, pad), value=fill).contiguous()
    return (padded(dev.loc_lp, LOG_ZERO), padded(entry_total(dev), LOG_ZERO),
            padded(dev.score_idx, 0))


def _scalar_winner(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                   cfg: Pass1Config) -> bool:
    """True where the cross-word winner is the single best word end
    (`_entry_scores`' last branch: N-gram mode under unigram factoring,
    or no LM, without a DFA), which the word-end stage then gives."""
    return (cfg.crossword and not (cfg.use_dfa and dev.cpair is not None)
            and not (cfg.use_lm and cfg.factoring >= 2 and ngram is not None))


def _entry_scores(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                  cfg: Pass1Config, atoms: Trellis, t, entry=None):
    """Cross-word expansion: each word-head node's entry score, LM
    context and trellis pointer ([B, N] each, or [B, 1] when the winner
    is the same for every word).  `entry` is the word-end stage's [B]
    winner where it gave one (`_scalar_winner`).

    N-gram mode under unigram factoring (or no LM): the single best
    corrected word end wins every entry.  DFA mode: one winner per
    category through the category-pair table (reference dfa/cpair.c as
    the pass-1 inter-word constraint).  Factoring 2: one winner per word
    over the top expand_k contexts, each scored with its exact 2-gram."""
    B, M = atoms.word.shape
    valid = atoms.word >= 0
    wq = dev.entry_word.clamp(min=0).long()                      # [N]
    if cfg.use_dfa and dev.cpair is not None:
        kcat = dev.word_cat[atoms.word.clamp(min=0).long()]       # [B, M]
        allowed = dev.cpair[kcat] & valid[..., None]              # [B, M, C]
        sc = torch.where(allowed, atoms.score[..., None], LOG_ZERO)
        best_k = sc.argmax(dim=1)                    # [B, C], first max
        ncat = dev.word_cat[wq]                                   # [N]
        k = best_k[:, ncat]                                       # [B, N]
        return (sc.amax(dim=1)[:, ncat],
                atoms.word.gather(1, k).clamp(min=0),
                ((t - 1) * M + k).to(torch.int32))
    if cfg.use_lm and cfg.factoring >= 2 and ngram is not None:
        K = min(cfg.expand_k, M)
        aw = atoms.ectx[:, :K]                                    # [B, K]
        asc = torch.where(valid[:, :K], atoms.score[:, :K], LOG_ZERO)
        v_lm = torch.where(aw >= 0, dev.wid2lm[aw.clamp(min=0).long()], -1)
        w_lm = dev.wid2lm                                         # [V]
        w0 = w_lm.clamp(min=0)
        bi = bigram_score(ngram, v_lm[..., None], w0)             # [B, K, V]
        # the merge adds word_entry_lm = lw*uni + pen, so the increment
        # here is lw*(bigram - uni); words outside the LM keep the raw
        # score
        sc = asc[..., None] + cfg.lm_weight * (bi - ngram.uni[w0])
        sc = torch.where(w_lm >= 0, sc, asc[..., None])
        k_best = sc.argmax(dim=1)[:, wq]                          # [B, N]
        return (sc.amax(dim=1)[:, wq],
                aw.gather(1, k_best).clamp(min=-1),
                ((t - 1) * M + k_best).to(torch.int32))
    if entry is None:
        entry = we.scalar_entry_batched(atoms, t, M)
    ent, ectx, eprev = entry
    return ent[:, None], ectx[:, None], eprev[:, None]


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[:, n-k] along the node axis, `fill` where n-k < 0."""
    if k == 0:
        return x
    return torch.cat([x.new_full((x.shape[0], k), fill), x[:, :-k]], dim=1)


def pass1_init(dev: DeviceNetwork, cfg: Pass1Config,
               out_row0: torch.Tensor) -> torch.Tensor:
    """[B, N] initial scores from the first frame's [B, R] outprob rows.
    N-gram mode enters the head silence word only (reference
    init_nodescore beam.c:1552); DFA mode every word of a category that
    may start the sentence; isolated-word mode every word."""
    ew = dev.entry_word
    w = ew.clamp(min=0).long()
    if cfg.use_dfa and dev.cat_init is not None:
        enter = (ew >= 0) & dev.cat_init[dev.word_cat[w]]
    elif cfg.crossword:
        enter = ew == dev.head_word
    else:
        enter = ew >= 0
    return torch.where(
        enter, dev.entry_lp + dev.word_entry_lm[w]
        + out_row0[:, dev.score_idx.long()], LOG_ZERO)


def pass1_step(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
               cfg: Pass1Config, score: torch.Tensor, ctx: torch.Tensor,
               prev: torch.Tensor, atoms: Trellis, out_row: torch.Tensor,
               frame_valid: torch.Tensor, t, entry=None, out=None):
    """One frame of the reference's unfused `pass1_step` (pass1.py:458)
    over the batch: [B, N] state, the [B, M] atoms of frame t-1, the
    [B, R] outprob rows of frame t, [B] frame_valid -> the new state,
    frozen where frame_valid is False, written into `out` where given
    (three tensors like the state, apart from it).  t is an int or a [1]
    int32 tensor; `entry` the atoms' [B] winner where the word-end stage
    gave it."""
    if dev.local_k >= 0:
        # K+1 shifted adds; ties keep the smallest span k
        cands = [_shift(score, k, LOG_ZERO) + dev.loc_lp[k]
                 for k in range(dev.local_k + 1)]
        inw = cands[0]
        for c in cands[1:]:
            inw = torch.maximum(inw, c)
        nctx, nprev = ctx, prev
        taken = cands[0] >= inw
        for k in range(1, dev.local_k + 1):
            hit = (cands[k] >= inw) & ~taken
            taken = taken | hit
            nctx = torch.where(hit, _shift(ctx, k, -1), nctx)
            nprev = torch.where(hit, _shift(prev, k, -1), nprev)
    else:
        # general topology: gather + first max over the incoming arcs
        cand = score[:, dev.in_src] + dev.in_lp                   # [B, N, D]
        best_d = cand.argmax(dim=2, keepdim=True)
        inw = cand.gather(2, best_d)[..., 0]
        src = dev.in_src.expand(score.shape[0], -1, -1).gather(
            2, best_d)[..., 0]
        nctx, nprev = ctx.gather(1, src), prev.gather(1, src)

    if cfg.crossword:
        ent, ectx, eprev = _entry_scores(dev, ngram, cfg, atoms, t, entry)
        wq = dev.entry_word.clamp(min=0).long()
        cand_e = torch.where(dev.entry_word >= 0,
                             ent + dev.entry_lp + dev.word_entry_lm[wq],
                             LOG_ZERO)
        use_e = cand_e > inw
        merged = torch.where(use_e, cand_e, inw)
        nctx = torch.where(use_e, ectx, nctx)
        nprev = torch.where(use_e, eprev, nprev)
    else:
        merged = inw

    sidx = dev.score_idx.long()
    if dev.rc_head is not None:
        # per-context head emission rows: the class comes from the
        # token's LM context after the entry merge (a transparent
        # predecessor contributes its inherited context)
        cls = torch.where(nctx >= 0, dev.lc_class[nctx.clamp(min=0).long()],
                          0)
        ov = dev.rc_sidx[dev.rc_head.clamp(min=0) * dev.rc_C + cls]
        emit = out_row.gather(1, torch.where(dev.rc_head >= 0, ov, sidx))
    else:
        emit = out_row[:, sidx]
    new_score = torch.where(merged > NEG_HALF, merged + emit, LOG_ZERO)
    if cfg.beam_width > 0:
        # the envelope is per utterance: each row's own best
        thr = new_score.amax(dim=1, keepdim=True) - cfg.beam_width
        new_score = torch.where(new_score >= thr, new_score, LOG_ZERO)
    return pk.freeze(frame_valid, (new_score, nctx, nprev),
                     (score, ctx, prev), out)


def _frame(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
           cfg: Pass1Config, tabs, score: torch.Tensor, ctx: torch.Tensor,
           prev: torch.Tensor, t: torch.Tensor, n_frames: torch.Tensor,
           rows: torch.Tensor, trellis: Trellis, out) -> None:
    """Step t of pass 1 (t a [1] int32 tensor on the state's device,
    1..T): frame t-1's word ends from the [B, N] state go into row t-1
    of the [B, >= T, M] `trellis` tensors, and the state advances
    through frame t, whose [B, R] outprob rows are rows[:, t] (`rows`
    holds the T frames and a zero frame after them), into `out`, the
    other state set.  `tabs` are the kernel's `kernel_tables`, or None
    for the unfused step."""
    row = rows.index_select(1, t)[:, 0]                           # [B, R]
    frame_valid = t < n_frames                                     # [B]
    winner = tabs is not None or _scalar_winner(dev, ngram, cfg)
    atoms, entry = we.word_end(dev, ngram, cfg, score, ctx, prev,
                               t if winner else None)
    if tabs is not None:
        loc, etot, sidx = tabs
        pk.fused_step(score, ctx, prev, loc, etot, row, sidx, *entry,
                      frame_valid, out)
    else:
        pass1_step(dev, ngram, cfg, score, ctx, prev, atoms, row,
                   frame_valid, t, entry, out)
    # atoms describe frame t-1, valid while t-1 < n_frames
    atom_ok = ((t - 1) < n_frames)[:, None] & (atoms.word >= 0)
    atoms = atoms._replace(
        word=torch.where(atom_ok, atoms.word, -1),
        score=torch.where(atom_ok, atoms.score, LOG_ZERO))
    at = (t - 1).long()
    for buf, a in zip(trellis, atoms):
        buf.index_copy_(1, at, a[:, None])


def count_frames(n: int, copied: bool) -> None:
    """Count n frames stepped on the tracer (`pass1.frames`), and as
    `pass1.state_copies` where each copied its state back into the
    fixed tensors it read (a stream chunk's and the sharded loop's)."""
    trace.count("pass1.frames", n)
    trace.count("pass1.state_copies", n if copied else 0)


class _Loop:
    """pass1_batch's frame loop over fixed tensors: two sets of the
    [B, N] state (score, ctx, prev), the step t, the [B] frame counts,
    the outprob rows of up to T frames and a zero frame, and the
    [B, T, M] trellis.  `step(..., p)` is one frame from state set p
    into set 1 - p, and writes everything else in place, so frames
    alternate p = 0, 1, 0, ... from a load, no frame copies the state,
    and CUDA graphs of the two steps, replayed in turn, replay the
    loop."""

    def __init__(self, B: int, N: int, R: int, T: int, M: int, device):
        self.states = tuple(
            (torch.empty((B, N), dtype=torch.float32, device=device),
             torch.empty((B, N), dtype=torch.int32, device=device),
             torch.empty((B, N), dtype=torch.int32, device=device))
            for _ in range(2))
        self.t = torch.empty(1, dtype=torch.int32, device=device)
        self.n_frames = torch.empty(B, dtype=torch.int32, device=device)
        # zeros: a capture of a one-frame batch steps a masked frame 2
        self.rows = torch.zeros((B, T + 1, R), dtype=torch.float32,
                                device=device)
        self.trellis = Trellis(*[torch.empty((B, T, M), dtype=dt,
                                             device=device)
                                 for dt in TRELLIS_DTYPES])

    def load(self, score0: torch.Tensor, out_ext: torch.Tensor,
             n_frames: torch.Tensor) -> None:
        """Start a batch: pass 1's initial scores and empty payloads in
        state set 0, t = 1, the [B, T, R] outprob rows with a zero frame
        after them."""
        T = out_ext.shape[1]
        score, ctx, prev = self.states[0]
        score.copy_(score0)
        ctx.fill_(-1)
        prev.fill_(-1)
        self.t.fill_(1)
        self.n_frames.copy_(n_frames)
        self.rows[:, :T].copy_(out_ext)
        self.rows[:, T].zero_()

    def step(self, dev: DeviceNetwork, ngram: Optional[DeviceNgram],
             cfg: Pass1Config, tabs, p: int) -> None:
        _frame(dev, ngram, cfg, tabs, *self.states[p], self.t,
               self.n_frames, self.rows, self.trellis, self.states[1 - p])
        self.t.add_(1)


def _eager(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
           cfg: Pass1Config, tabs, score0: torch.Tensor,
           out_ext: torch.Tensor, n_frames: torch.Tensor) -> Trellis:
    """pass1_batch as a Python loop of T frame steps."""
    B, T, R = out_ext.shape
    loop = _Loop(B, score0.shape[1], R, T, cfg.n_atoms, out_ext.device)
    loop.load(score0, out_ext, n_frames)
    for i in range(T):
        loop.step(dev, ngram, cfg, tabs, i % 2)
    count_frames(T, False)
    return loop.trellis


def _capture(cache: GraphCache, device, *steps) -> list:
    """Run each step once on the cache's side stream, then capture it
    into a CUDA graph there, in turn, all into the cache's pool (the
    eager run plans and loads the kernel, whose occupancy query and
    library load a capture cannot hold) -> the graphs.  Raises if a
    capture fails, and then drops the cache's pool and stream.

    The capture's error mode is "thread_local": a server builds engines
    on its command thread while another thread decodes, and in the
    "global" mode that thread's allocations would fail during a capture
    and break it; this thread's own host synchronisations still fail
    it.  The capture begins and ends directly, not through
    `torch.cuda.graph`, which would first synchronise the card and empty
    the allocator's device and pinned-host caches, so that later
    allocations go back to cudaMalloc (chip_smoke.py's capture_cost line
    times both ways)."""
    if cache.stream is None:
        cache.stream = torch.cuda.Stream(device)
    if cache.pool is None or not cache.entries:
        # a pool none of whose graphs is alive cannot take a capture
        cache.pool = torch.cuda.graph_pool_handle()
    side = cache.stream
    side.wait_stream(torch.cuda.current_stream(device))
    graphs = []
    try:
        with torch.cuda.stream(side):
            for step in steps:
                step()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(cache.pool,
                                    capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
                graphs.append(graph)
    except BaseException:
        cache.pool = cache.stream = None
        raise
    torch.cuda.current_stream(device).wait_stream(side)
    return graphs


#: the kernels' wrappers a captured step calls, whose launches a replay
#: counts
KERNELS = (pk, we)


class _Graph(NamedTuple):
    """A captured loop body: its graphs, replayed in turn from the first
    (the two steps of `_Loop`, one a state set; a stream's one chunk
    row), the fixed tensors they read and write, the launches a replay
    makes of each of `KERNELS` (the same for every graph of the body),
    and the tables they read that the network does not hold (the
    kernel's padded tables and the N-gram, whose id is part of the
    key)."""

    graphs: tuple
    loop: object
    launches: tuple
    tabs: Optional[tuple]
    ngram: Optional[DeviceNgram]

    def replay(self, n: int) -> None:
        """n replays, the graphs in turn from the first, and count their
        launches."""
        for i in range(n):
            self.graphs[i % len(self.graphs)].replay()
        for m, k in zip(KERNELS, self.launches):
            m.LAUNCHES += k * n


def _capture_graph(cache: GraphCache, device, loop, steps, tabs,
                   ngram) -> _Graph:
    """`_capture` of `steps` over `loop`'s fixed tensors, with the
    launches a captured step holds."""
    before = [m.CAPTURED for m in KERNELS]
    graphs = _capture(cache, device, *steps)
    return _Graph(tuple(graphs), loop,
                  tuple((m.CAPTURED - b) // len(steps)
                        for m, b in zip(KERNELS, before)),
                  tabs, ngram)


def _graphed(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
             cfg: Pass1Config, tabs, score0: torch.Tensor,
             out_ext: torch.Tensor, n_frames: torch.Tensor) -> Trellis:
    """pass1_batch on a CUDA card: the captured frame steps, from state
    set 0 to 1 and back in turn, once a frame.  The first batch of a key
    captures the two steps (`_capture`, which runs each once first:
    frames 1 and 2, the second masked where T = 1, writing no trellis
    row below T and taken back out of the kernels' LAUNCHES), which
    leaves the state in set 0, then replays the other T - 2 frames; a
    later batch loads and replays T.  Nothing falls back to the eager
    loop."""
    B, T, R = out_ext.shape
    Np, M = score0.shape[1], cfg.n_atoms
    device = out_ext.device
    cap = max(MIN_T_BUCKET, 1 << (T - 1).bit_length())
    key = (device, B, Np, M, R, tabs is not None, cfg, id(ngram), cap)
    cache = dev.graphs
    with cache.lock, torch.cuda.device(device):
        entry = cache.entries.get(key)
        if entry is None:
            t0 = time.perf_counter()
            loop = _Loop(B, Np, R, cap, M, device)
            loop.load(score0, out_ext, n_frames)
            entry = cache.entries[key] = _capture_graph(
                cache, device, loop,
                [lambda p=p: loop.step(dev, ngram, cfg, tabs, p)
                 for p in (0, 1)], tabs, ngram)
            cache.captures += 1
            cache.capture_s += time.perf_counter() - t0
            assert MIN_T_BUCKET >= 2, "frame 2 needs a row and a slot"
            done = 2
            # a one-frame batch's masked frame 2 is capture work, as the
            # captured launches are: LAUNCHES counts the batch's frames
            for m, k in zip(KERNELS, entry.launches):
                m.LAUNCHES -= k * max(done - T, 0)
        else:
            entry.loop.load(score0, out_ext, n_frames)
            done = 0
        entry.replay(max(T - done, 0))
        count_frames(T, False)
        return Trellis(*[a[:, :T].clone() for a in entry.loop.trellis])


def pass1_batch(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                cfg: Pass1Config, out_ext: torch.Tensor,
                n_frames: torch.Tensor, use_kernel: bool = True,
                eager: bool = False) -> Trellis:
    """[B, T, R] extended outprob rows + [B] valid frame counts ->
    Trellis of [B, T, M] tensors (atom row t holds word-ends at frame
    t).  Reference: get_back_trellis pass1.c:616.  Each frame launches
    the beam-update kernel where `fused_ok` holds, else runs
    `pass1_step`; use_kernel=False runs `pass1_step` everywhere (the
    reference's `use_pallas=False`, which its mesh decode sets).

    On a CUDA card the frames are replays of a captured step
    (`_graphed`); eager=True runs the same step once a frame from
    Python instead, the graph's oracle.  The CPU always runs that loop,
    the kernel's plain version in it."""
    device = out_ext.device
    n_frames = n_frames.to(device=device, dtype=torch.int32)
    out_ext = out_ext.to(torch.float32)
    tabs = kernel_tables(dev) if use_kernel and fused_ok(dev, cfg) else None
    score = pass1_init(dev, cfg, out_ext[:, 0])
    if tabs is not None:
        score = torch.nn.functional.pad(
            score, (0, tabs[0].shape[1] - score.shape[1]), value=LOG_ZERO)
    run = _eager if device.type == "cpu" or eager else _graphed
    return run(dev, ngram, cfg, tabs, score, out_ext, n_frames)


class Pass1State(NamedTuple):
    """An in-progress stream's pass-1 state: [B, N] node scores, LM
    contexts and trellis pointers, and t, the absolute frame of the
    segment those scores have reached, a [1] int32 tensor on their
    device (the reference's is a device scalar)."""

    score: torch.Tensor
    ctx: torch.Tensor
    prev: torch.Tensor
    t: torch.Tensor


def pass1_stream_start(dev: DeviceNetwork, cfg: Pass1Config,
                       out_row0: torch.Tensor) -> Pass1State:
    """A stream's state after its first frame ([B, R] outprob rows),
    `pass1_init` with empty payloads at t = 0."""
    score = pass1_init(dev, cfg, out_row0)
    ctx = torch.full(score.shape, -1, dtype=torch.int32, device=score.device)
    return Pass1State(score=score, ctx=ctx, prev=ctx.clone(),
                      t=torch.zeros(1, dtype=torch.int32, device=score.device))


class _StreamLoop:
    """pass1_stream_chunk's frame loop over fixed tensors: the [1, N]
    state and its frame t, the chunk row i and the chunk's valid row
    count n_valid ([1] int32 each), the outprob rows of up to `cap`
    frames and the [cap, M] atoms.  `step` is one chunk row and writes
    everything back in place, so a CUDA graph of it replays the chunk."""

    def __init__(self, N: int, R: int, M: int, cap: int, device):
        self.score = torch.empty((1, N), dtype=torch.float32, device=device)
        self.ctx = torch.empty((1, N), dtype=torch.int32, device=device)
        self.prev = torch.empty_like(self.ctx)
        self.t = torch.empty(1, dtype=torch.int32, device=device)
        self.i = torch.empty_like(self.t)
        self.n_valid = torch.empty_like(self.t)
        self.rows = torch.empty((cap, R), dtype=torch.float32, device=device)
        self.atoms = Trellis(*[torch.empty((cap, M), dtype=dt, device=device)
                               for dt in TRELLIS_DTYPES])

    def load(self, state: Pass1State, out_chunk: torch.Tensor,
             n_valid: int) -> None:
        """Start a chunk: the session's state, chunk row 0, n_valid and
        the chunk's outprob rows."""
        for buf, x in zip((self.score, self.ctx, self.prev, self.t), state):
            buf.copy_(x)
        self.i.zero_()
        self.n_valid.fill_(n_valid)
        self.rows[:out_chunk.shape[0]].copy_(out_chunk)

    def step(self, dev: DeviceNetwork, ngram: Optional[DeviceNgram],
             cfg: Pass1Config) -> None:
        """Chunk row i, the reference's scan step (pass1.py:697-709):
        the atoms of the state before the step go into atom row i, not
        masked by the row's validity (as there), and the state steps
        through frame t + 1 on outprob row i, frozen from row n_valid
        on, t included."""
        valid = self.i < self.n_valid                               # [1]
        t = self.t + 1
        atoms, entry = we.word_end(
            dev, ngram, cfg, self.score, self.ctx, self.prev,
            t if _scalar_winner(dev, ngram, cfg) else None)
        row = self.rows.index_select(0, self.i)                     # [1, R]
        new = pass1_step(dev, ngram, cfg, self.score, self.ctx, self.prev,
                         atoms, row, valid, t, entry)
        at = self.i.long()
        for buf, a in zip(self.atoms, atoms):
            buf.index_copy_(0, at, a)
        for buf, x in zip((self.score, self.ctx, self.prev), new):
            buf.copy_(x)
        self.t.copy_(torch.where(valid, t, self.t))
        self.i.add_(1)

    def result(self, C: int):
        """Copies of the state and the chunk's [C, M] atoms."""
        state = Pass1State(self.score.clone(), self.ctx.clone(),
                           self.prev.clone(), self.t.clone())
        return state, Trellis(*[a[:C].clone() for a in self.atoms])


def _stream_eager(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                  cfg: Pass1Config, state: Pass1State,
                  out_chunk: torch.Tensor, n_valid: int):
    """pass1_stream_chunk as a Python loop of C chunk rows."""
    C, R = out_chunk.shape
    loop = _StreamLoop(state.score.shape[1], R, cfg.n_atoms, C,
                       out_chunk.device)
    loop.load(state, out_chunk, n_valid)
    for _ in range(C):
        loop.step(dev, ngram, cfg)
    count_frames(C, True)
    return loop.result(C)


def _stream_graphed(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                    cfg: Pass1Config, state: Pass1State,
                    out_chunk: torch.Tensor, n_valid: int):
    """pass1_stream_chunk on a CUDA card: C replays of a captured chunk
    row, keyed by the card, N, R, M, the config, the N-gram and a
    power-of-two capacity of rows, and no chunk length, so that a
    stream's first chunk (a row short) and the others share the graph.
    The first chunk of a key captures the step (`_capture`) and loads
    its inputs again; nothing falls back to the eager loop.  The cache's
    lock is held from the copy in to the copies out, so sessions on
    other threads share the graph."""
    C, R = out_chunk.shape
    N, M = state.score.shape[1], cfg.n_atoms
    device = out_chunk.device
    cap = 1 << (C - 1).bit_length()
    key = ("stream", device, N, R, M, cfg, id(ngram), cap)
    cache = dev.graphs
    with cache.lock, torch.cuda.device(device):
        entry = cache.entries.get(key)
        if entry is None:
            t0 = time.perf_counter()
            loop = _StreamLoop(N, R, M, cap, device)
            loop.load(state, out_chunk, n_valid)
            entry = cache.entries[key] = _capture_graph(
                cache, device, loop, [lambda: loop.step(dev, ngram, cfg)],
                None, ngram)
            cache.captures += 1
            cache.capture_s += time.perf_counter() - t0
        entry.loop.load(state, out_chunk, n_valid)
        entry.replay(C)
        count_frames(C, True)
        return entry.loop.result(C)


def pass1_stream_chunk(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                       cfg: Pass1Config, state: Pass1State,
                       out_chunk: torch.Tensor, n_valid: int,
                       eager: bool = False):
    """Advance an in-progress pass 1 of one utterance (B = 1) by a chunk
    of frames (the on-the-fly pipeline of the reference,
    realtime-1stpass.c proceed_one_frame; `julius_tpu`'s
    pass1_stream_chunk): state carries across chunks; returns the new
    state and the chunk's [C, M] trellis atoms, row i the word ends at
    absolute frame state.t + i.  Rows from n_valid on are padding: the
    state stays frozen there, t included, and their atoms are the frozen
    state's.

    Each frame takes the unfused step (`pass1_step`), as the reference's
    stream does; a stream starts with `pass1_stream_start` on the first
    row and passes the rest of its first chunk.  On a CUDA card the rows
    are replays of a captured step (`_stream_graphed`); eager=True runs
    the same step once a row from Python instead, the graph's oracle.
    The CPU always runs that loop."""
    run = _stream_eager if out_chunk.device.type == "cpu" or eager \
        else _stream_graphed
    return run(dev, ngram, cfg, state, out_chunk.to(torch.float32), n_valid)


def pass1_stream_finalize(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                          cfg: Pass1Config, state: Pass1State) -> Trellis:
    """The [M] word ends at the final frame of a finished stream segment
    (the decode_end flush, pass1.c:457)."""
    atoms, _ = we.word_end(dev, ngram, cfg, state.score, state.ctx,
                           state.prev)
    return Trellis(*[a[0] for a in atoms])


def backtrace(trellis, n_frames: int, tail_word: int = -1,
              final_mask: Optional[np.ndarray] = None):
    """Host-side pass-1 result backtrace (reference find_1pass_result
    beam.c:372): best word-end at the final frame, preferring acceptable
    final words (the tail silence word for N-gram, sentence-final
    categories for DFA and any word for isolated words via final_mask),
    then follow backpointers.  `trellis` holds one utterance's [T, M]
    arrays."""
    word = np.asarray(trellis.word)
    score = np.asarray(trellis.score)
    prev = np.asarray(trellis.prev)
    begin = np.asarray(trellis.begin)
    lm = np.asarray(trellis.lm)
    T, M = word.shape
    t_last = n_frames - 1
    row_w = word[t_last]
    row_s = score[t_last]
    if final_mask is not None:
        ok = (row_w >= 0) & final_mask[np.maximum(row_w, 0)]
    else:
        ok = row_w == tail_word
    cand = np.where(ok, row_s, -np.inf)
    if np.isfinite(cand).any():
        m = int(np.argmax(cand))
    else:
        valid = np.where(row_w >= 0, row_s, -np.inf)
        if not np.isfinite(valid).any():
            return None
        m = int(np.argmax(valid))
    out = []
    a = t_last * M + m
    total = float(score[t_last, m])
    while a >= 0:
        t, mm = divmod(a, M)
        out.append({
            "word": int(word[t, mm]),
            "begin": int(begin[t, mm]),
            "end": t,
            "score": float(score[t, mm]),
            "lm": float(lm[t, mm]),
        })
        a = int(prev[t, mm])
    out.reverse()
    return {"words": [o["word"] for o in out], "segments": out,
            "score": total}
