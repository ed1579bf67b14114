"""Pass 1: frame-synchronous Viterbi over the flat decode network (torch).

Port of `julius_tpu/search/pass1.py` for the configuration its fused
kernel serves: a shift-structured network (every arc spans dst - src in
[0, K], K <= MAX_LOCAL_K), cross-word N-gram decoding with unigram
factoring at word entry (factoring 1) or no LM, no DFA, no score
envelope, no per-context head emission rows.  Every node carries one
score + payload (LM context word, trellis backpointer); each frame

  * emits up to M corrected word-end records ("atoms") for frame t-1:
    the top 2M exits get the exact 2-gram swap for their entry unigram
    (hash probes), then the best M are kept in the [T, M] trellis;
  * picks the single best atom per utterance as the cross-word winner
    (under unigram factoring the winner is the same for every word);
  * advances every node with one launch of the beam-update kernel
    (ops/pass1_kernel.py).

The frame loop is Python over a batch written out as a leading [B]
axis, with no host synchronisation inside it.  Tie order is part of the
result (trellis slot order fixes `prev` ids): every top-k here is a
stable descending sort, so ties go to the lowest index as `lax.top_k`
and `argmax` give them, and payloads are selected by index gathers, not
by one-hot products.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from julius_tpu_torch.ops import pass1_kernel as pk
from julius_tpu_torch.search.network import DecodeNetwork
from julius_tpu_torch.search.ngram_device import DeviceNgram, bigram_score_fast
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
MAX_LOCAL_K = 8     # max arc span for the shift-structured network


@dataclass
class DeviceNetwork:
    """Decode network tables on one device.

    `loc_lp[k, i]` = ln p of the arc i-k -> i (LOG_ZERO if none), so the
    incoming-arc max is K+1 shifted adds."""

    score_idx: torch.Tensor   # [N] i32 node -> outprob row column
    loc_lp: torch.Tensor      # [K+1, N] f32 shifted-arc scores
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
    head_word: int
    tail_word: int
    local_k: int


#: DeviceNetwork tensor fields, with their dtypes (convert.py reads the
#: reference's tables by these names)
NETWORK_FIELDS = {
    "score_idx": torch.int32, "loc_lp": torch.float32,
    "entry_word": torch.int32, "entry_lp": torch.float32,
    "exit_nodes": torch.int64, "exit_w": torch.int32,
    "exit_nlp": torch.float32, "exit_wlm": torch.int32,
    "exit_uni": torch.float32, "exit_transp": torch.bool,
    "ctx_info": torch.float32, "word_entry_lm": torch.float32,
}


def device_network_from_numpy(arrays, head_word: int, tail_word: int,
                              local_k: int, device) -> DeviceNetwork:
    """DeviceNetwork from host arrays keyed by NETWORK_FIELDS names."""
    if local_k < 0:
        raise _unfused("a network with arcs outside the [0, MAX_LOCAL_K] "
                       "shift window")
    t = {}
    for name, dt in NETWORK_FIELDS.items():
        a = arrays[name]
        t[name] = None if a is None else torch.as_tensor(
            np.array(a), dtype=dt, device=device)
    return DeviceNetwork(**t, head_word=int(head_word),
                         tail_word=int(tail_word), local_k=int(local_k))


def build_device_network(
    net: DecodeNetwork,
    device,
    ngram: Optional[DeviceNgram] = None,
    wid2lm: Optional[np.ndarray] = None,
    lm_weight: float = 8.0,
    lm_penalty: float = 0.0,
    transparent: Optional[np.ndarray] = None,
    transparent_penalty: float = 0.0,
    cprob: Optional[np.ndarray] = None,
) -> DeviceNetwork:
    """Host decode network -> device tables (the reference's
    build_device_network for the shift-structured case)."""
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
    arrays = dict(
        score_idx=net.score_idx, loc_lp=loc,
        entry_word=net.entry_word, entry_lp=net.entry_lp,
        exit_nodes=exit_nodes, exit_w=exit_w,
        exit_nlp=net.exit_lp[exit_nodes], exit_wlm=exit_wlm,
        exit_uni=exit_uni,
        exit_transp=np.asarray(transparent, dtype=bool)[exit_w],
        ctx_info=ctx_info, word_entry_lm=entry)
    return device_network_from_numpy(arrays, net.head_word, net.tail_word,
                                      local_k, device)


@dataclass(frozen=True)
class Pass1Config:
    """Static search parameters (reference JCONF_SEARCH pass-1 block)."""

    n_atoms: int = 32           # trellis word-ends kept per frame (M)
    lm_weight: float = 8.0
    lm_penalty: float = 0.0
    beam_width: float = 0.0     # score envelope; only 0 (exact) here
    use_lm: bool = True         # ngram mode vs no LM
    use_dfa: bool = False       # category-pair constrained cross-word
    crossword: bool = True      # False = isolated word recognition
    factoring: int = 1          # 1 = unigram at entry + 2-gram at end


class Trellis(NamedTuple):
    """Word-end records (reference TRELLIS_ATOM, trellis.h:28-41);
    [B, T, M] from `pass1_batch`, [T, M] per utterance."""

    word: torch.Tensor    # int32 vocab word id (-1 invalid)
    score: torch.Tensor   # f32 accumulated Viterbi score at word end
    lm: torch.Tensor      # f32 LM score of this word (weighted, + penalty)
    prev: torch.Tensor    # int32 flattened atom id of predecessor word end
    begin: torch.Tensor   # int32 first frame of the word
    ectx: torch.Tensor    # int32 effective LM context for what follows


def _unfused(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the torch port yet: ROADMAP.md queue 1, "
        "unfused pass1_step paths")


def check_supported(dev: DeviceNetwork, cfg: Pass1Config) -> None:
    """Raise NotImplementedError for configurations outside this port's
    pass 1 (the reference's `_fused_ok` gate; no silent fallback)."""
    why = ("a gather-topology network" if dev.local_k < 0
           else "isolated-word pass 1" if not cfg.crossword
           else "DFA category pairs" if cfg.use_dfa
           else "factoring=2" if cfg.use_lm and cfg.factoring >= 2
           else "a score-envelope beam" if cfg.beam_width > 0
           else None)
    if why is not None:
        raise _unfused(why)


def entry_total(dev: DeviceNetwork) -> torch.Tensor:
    """[N] entry score of each word-head node (entry ln p + the word's
    weighted unigram and penalty), LOG_ZERO where no word starts."""
    ew = dev.entry_word
    wq = ew.clamp(min=0).long()
    return torch.where(ew >= 0, dev.entry_lp + dev.word_entry_lm[wq],
                       LOG_ZERO)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (lax.top_k's
    order; torch.topk promises none on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _word_end_candidates(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                         cfg: Pass1Config, score: torch.Tensor,
                         ctx: torch.Tensor, prev: torch.Tensor) -> Trellis:
    """Corrected word-end records [B, M] from the current [B, N] node
    state: the top 2M exits get the exact 2-gram swap for their entry
    unigram (reference beam.c beam_inter_word), then the best M stay."""
    M = cfg.n_atoms
    sc_all = score[:, dev.exit_nodes] + dev.exit_nlp           # [B, Ex]
    Ex = sc_all.shape[-1]
    k = min(2 * M, Ex)
    sc, sel = _topk_stable(sc_all, k)                          # [B, k]
    ctx_all = ctx[:, dev.exit_nodes]
    prev_k = prev[:, dev.exit_nodes].gather(1, sel)
    ctx_k = ctx_all.gather(1, sel)
    # transparent words pass their inherited LM context onward
    ectx_k = torch.where(dev.exit_transp, ctx_all, dev.exit_w).gather(1, sel)
    w_k = dev.exit_w[sel]
    wlm_k = dev.exit_wlm[sel]
    uni_k = dev.exit_uni[sel]
    if cfg.use_lm and ngram is not None:
        vrow = dev.ctx_info[ctx_k.clamp(min=0).long()]          # [B, k, 2]
        v_lm = torch.where(ctx_k >= 0, vrow[..., 0].to(torch.int32), -1)
        bi = bigram_score_fast(ngram, v_lm, vrow[..., 1], wlm_k, uni_k)
        delta = torch.where(wlm_k >= 0, cfg.lm_weight * (bi - uni_k), 0.0)
        lm_sc = torch.where(wlm_k >= 0, cfg.lm_weight * bi + cfg.lm_penalty,
                            cfg.lm_penalty)
    else:
        delta = torch.zeros_like(sc)
        lm_sc = torch.full_like(sc, cfg.lm_penalty)
    corrected = torch.where(sc > NEG_HALF, sc + delta, LOG_ZERO)
    m_eff = min(M, k)
    csc, order = _topk_stable(corrected, m_eff)                # [B, m]
    prev_sel = prev_k.gather(1, order)
    atoms = Trellis(
        word=torch.where(csc > NEG_HALF, w_k.gather(1, order), -1),
        score=csc,
        lm=lm_sc.gather(1, order),
        prev=prev_sel,
        begin=torch.where(prev_sel >= 0,
                          torch.div(prev_sel, M, rounding_mode="floor") + 1,
                          0).to(torch.int32),
        ectx=ectx_k.gather(1, order),
    )
    if m_eff < M:
        pad = M - m_eff
        fills = Trellis(word=-1, score=LOG_ZERO, lm=0.0, prev=-1, begin=0,
                        ectx=-1)
        atoms = Trellis(*[
            torch.nn.functional.pad(a, (0, pad), value=f)
            for a, f in zip(atoms, fills)])
    return atoms


def _scalar_entry_batched(atoms: Trellis, t: int, M: int):
    """Batched single-best corrected word-end (the factoring-1
    cross-word winner): [B] score, LM context, trellis pointer.  Ties
    go to the lowest slot, as argmax gives them."""
    valid = atoms.word >= 0
    sc = torch.where(valid, atoms.score, LOG_ZERO)
    slots = torch.arange(sc.shape[-1], device=sc.device)
    best = torch.where(sc == sc.max(dim=-1, keepdim=True).values,
                       slots, sc.shape[-1]).min(dim=-1).values     # [B]
    bidx = best[:, None]
    bvalid = valid.gather(1, bidx)[:, 0]
    ent = torch.where(bvalid, sc.gather(1, bidx)[:, 0], LOG_ZERO)
    ectx = torch.where(bvalid, atoms.ectx.gather(1, bidx)[:, 0], -1)
    eprev = ((t - 1) * M + best).to(torch.int32)
    return ent, ectx.to(torch.int32), eprev


def pass1_batch(dev: DeviceNetwork, ngram: Optional[DeviceNgram],
                cfg: Pass1Config, out_ext: torch.Tensor,
                n_frames: torch.Tensor) -> Trellis:
    """[B, T, R] extended outprob rows + [B] valid frame counts ->
    Trellis of [B, T, M] tensors (atom row t holds word-ends at frame
    t).  Reference: get_back_trellis pass1.c:616."""
    check_supported(dev, cfg)
    B, T, _ = out_ext.shape
    M = cfg.n_atoms
    device = out_ext.device
    n_frames = n_frames.to(device=device, dtype=torch.int32)
    out_ext = out_ext.to(torch.float32).contiguous()

    etot = entry_total(dev)
    loc = dev.loc_lp.contiguous()
    sidx = dev.score_idx

    # initial state: enter the head silence word only (reference
    # init_nodescore beam.c:1552)
    N = etot.shape[0]
    enter = dev.entry_word == dev.head_word
    score = torch.where(enter, etot + out_ext[:, 0][:, sidx.long()],
                        LOG_ZERO)
    ctx = torch.full((B, N), -1, dtype=torch.int32, device=device)
    prev = torch.full((B, N), -1, dtype=torch.int32, device=device)

    rows_out = []
    # steps t = 1..T advance through frame t; step T runs on a dummy row
    # with every frame invalid, so word-ends at the last frame are still
    # emitted
    zero_row = torch.zeros_like(out_ext[:, 0])
    for t in range(1, T + 1):
        row = out_ext[:, t] if t < T else zero_row
        frame_valid = t < n_frames                                  # [B]
        atoms = _word_end_candidates(dev, ngram, cfg, score, ctx, prev)
        ent_s, ectx_s, eprev_s = _scalar_entry_batched(atoms, t, M)
        score, ctx, prev = pk.fused_step(
            score, ctx, prev, loc, etot, row, sidx,
            ent_s, ectx_s, eprev_s, frame_valid)
        # atoms describe frame t-1, valid while t-1 < n_frames
        atom_ok = ((t - 1) < n_frames)[:, None] & (atoms.word >= 0)
        atoms = atoms._replace(
            word=torch.where(atom_ok, atoms.word, -1),
            score=torch.where(atom_ok, atoms.score, LOG_ZERO))
        rows_out.append(atoms)
    return Trellis(*[torch.stack(f, dim=1) for f in zip(*rows_out)])


def backtrace(trellis, n_frames: int, tail_word: int = -1,
              final_mask: Optional[np.ndarray] = None):
    """Host-side pass-1 result backtrace (reference find_1pass_result
    beam.c:372): best word-end at the final frame, preferring acceptable
    final words (the tail silence word for N-gram), then follow
    backpointers.  `trellis` holds one utterance's [T, M] arrays."""
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
