"""Forced alignment: Viterbi segmentation of a known transcript (torch).

Port of `julius_tpu/search/align.py` (reference
`libjulius/src/word_align.c`: word_align:370, phoneme_align:431,
state_align:492, composing a sentence HMM via `new_make_word_hmm`,
libsent/src/phmm/mkwhmm.c, and running `viterbi_segment`,
libsent/src/phmm/vsegment.c:53).

The sentence HMM is a linear chain compiled to the same dense
incoming-arc tables as the decode network (host code, copied).  The
Viterbi is a frame loop on the engine's device carrying [N] scores:
each frame gathers the incoming arcs, keeps the first maximum (as
`argmax` gives it) and writes the winning predecessor into a [T, N]
backpointer table that stays on the device; the table comes to the host
once per utterance, where the backtrace maps the state path to state,
phone and word segments.  On a CUDA card the frame is captured once as a
CUDA graph per bucket of chain sizes (nodes and frames rounded up to
powers of two, the chain padded) and replayed once a frame, where the
reference's jitted `lax.scan` compiles once per chain size.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import HMMSet, PseudoPhoneSets
from julius_tpu_torch.search.network import (_phone_entry_pairs,
                                             _resolve_phone,
                                             word_phone_names)
from julius_tpu_torch.search.pass1 import (MIN_T_BUCKET, GraphCache,
                                           _capture)
from julius_tpu_torch.utils.logadd import LOG_ZERO

_NEG_HALF = LOG_ZERO / 2
MIN_N_BUCKET = 64   # the fewest nodes a captured Viterbi holds
#: captured Viterbis kept per cache, the oldest dropped past it
GRAPHS_KEPT = 8


@dataclass
class SentenceChain:
    """Composed sentence HMM with node -> (word, phone, state) metadata."""

    score_idx: np.ndarray     # [N] rows into the extended outprob table
    in_src: np.ndarray        # [N, Din]
    in_lp: np.ndarray         # [N, Din]
    entry_lp: np.ndarray      # [N] LOG_ZERO if not an entry node
    exit_lp: np.ndarray       # [N] LOG_ZERO if not an exit node
    node_word: np.ndarray     # [N] index into the word sequence
    node_phone: np.ndarray    # [N] index into the phone sequence
    node_state: np.ndarray    # [N] emitting state index within the phone
    phone_names: List[str]
    phone_word: np.ndarray    # [n_phones] word index of each phone


def build_chain(hmm: HMMSet, voca: Vocabulary, word_ids: Sequence[int],
                use_triphone: Optional[bool] = None,
                pseudo: Optional[PseudoPhoneSets] = None) -> SentenceChain:
    """Concatenate the words' phone HMMs into one sentence chain
    (reference mkwhmm.c new_make_word_hmm; cross-word contexts use the
    same word-boundary approximation as the decode network)."""
    if use_triphone is None:
        use_triphone = hmm.names_are_triphone
    S = hmm.n_states

    score_idx: List[int] = []
    node_word: List[int] = []
    node_phone: List[int] = []
    node_state: List[int] = []
    arcs: List[Tuple[int, int, float]] = []
    entry_lp_l: List[Tuple[int, float]] = []
    phone_names: List[str] = []
    phone_word: List[int] = []

    frontier: List[Tuple[int, float]] = [(-1, 0.0)]
    for wi, w in enumerate(word_ids):
        names = word_phone_names(voca.phones[w], use_triphone)
        for name in names:
            kind, pid = _resolve_phone(hmm, pseudo, name)
            if kind == "phys":
                ns = int(hmm.phone_ns[pid])
                trans = hmm.phone_trans[pid]
                sidx_of = lambda j, _p=pid: int(hmm.phone_states[_p, j])
            else:
                ns = int(pseudo.set_ns[pid])
                trans = hmm.phone_trans[int(pseudo.set_trans_phone[pid])]
                base = int(pseudo.set_state_ofs[pid])
                sidx_of = lambda j, _b=base: S + _b + j
            pidx = len(phone_names)
            phone_names.append(name)
            phone_word.append(wi)
            base_node = len(score_idx)
            for j in range(ns):
                score_idx.append(sidx_of(j))
                node_word.append(wi)
                node_phone.append(pidx)
                node_state.append(j)
            nodes = list(range(base_node, base_node + ns))
            epairs, tee = _phone_entry_pairs(trans, ns)
            for src, acc in frontier:
                for j, elp in epairs:
                    lp = acc + elp
                    if lp <= _NEG_HALF:
                        continue
                    if src < 0:
                        entry_lp_l.append((nodes[j], lp))
                    else:
                        arcs.append((src, nodes[j], lp))
            for i in range(ns):
                for j in range(ns):
                    lp = float(trans[i + 1, j + 1])
                    if lp > _NEG_HALF:
                        arcs.append((nodes[i], nodes[j], lp))
            nxt = [(nodes[i], float(trans[i + 1, ns + 1]))
                   for i in range(ns) if trans[i + 1, ns + 1] > _NEG_HALF]
            if tee > _NEG_HALF:
                nxt.extend((src, acc + tee) for src, acc in frontier)
            frontier = nxt

    N = len(score_idx)
    entry = np.full(N, LOG_ZERO, dtype=np.float32)
    for n, lp in entry_lp_l:
        entry[n] = max(entry[n], lp)
    exit_lp = np.full(N, LOG_ZERO, dtype=np.float32)
    for src, acc in frontier:
        exit_lp[src] = max(exit_lp[src], acc)

    by_dst = {}
    for src, dst, lp in arcs:
        by_dst.setdefault(dst, []).append((src, lp))
    din = max((len(v) for v in by_dst.values()), default=1)
    in_src = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, din))
    in_lp = np.full((N, din), LOG_ZERO, dtype=np.float32)
    for dst, lst in by_dst.items():
        for k, (src, lp) in enumerate(lst):
            in_src[dst, k] = src
            in_lp[dst, k] = lp
    return SentenceChain(
        score_idx=np.asarray(score_idx, dtype=np.int32),
        in_src=in_src, in_lp=in_lp,
        entry_lp=entry, exit_lp=exit_lp,
        node_word=np.asarray(node_word, dtype=np.int32),
        node_phone=np.asarray(node_phone, dtype=np.int32),
        node_state=np.asarray(node_state, dtype=np.int32),
        phone_names=phone_names,
        phone_word=np.asarray(phone_word, dtype=np.int32),
    )


class _Viterbi:
    """viterbi_chain's frame loop over fixed tensors of `N` nodes and `T`
    frames: the chain's [N, Din] in-arc tables, the [T, N] emission rows
    and backpointers, the [N] scores and the frame t ([1] int64).  A
    chain of fewer nodes is padded: a pad node's only in-arc is itself at
    LOG_ZERO, its entry is LOG_ZERO and its emission column 0, and no
    real node has it as a source, so the real nodes' scores and
    backpointers are those of the chain alone.  `step` is one frame and
    writes everything back in place, so a CUDA graph of it replays the
    loop."""

    def __init__(self, N: int, Din: int, T: int, device):
        self.src = torch.empty((N, Din), dtype=torch.int64, device=device)
        self.lp = torch.empty((N, Din), dtype=torch.float32, device=device)
        self.emit = torch.empty((T, N), dtype=torch.float32, device=device)
        self.bp = torch.empty((T, N), dtype=torch.int64, device=device)
        self.score = torch.empty(N, dtype=torch.float32, device=device)
        self.t = torch.empty(1, dtype=torch.int64, device=device)
        self.nodes = torch.arange(N, device=device)
        self.graph = None       # the captured step, on a CUDA card

    def load(self, score_idx, in_src, in_lp, entry_lp, out_ext) -> None:
        """Start an utterance: a chain's tables (N <= the loop's nodes)
        and its [T, R] outprob rows (T <= the loop's frames); every
        backpointer row points each node at itself, t = 1."""
        N, pad = in_src.shape[0], self.src.shape[0] - in_src.shape[0]
        self.src.copy_(self.nodes[:, None].expand_as(self.src))
        self.src[:N].copy_(in_src)
        self.lp.fill_(LOG_ZERO)
        self.lp[:N].copy_(in_lp)
        sidx = torch.nn.functional.pad(score_idx, (0, pad))
        self.emit[:out_ext.shape[0]].copy_(out_ext.index_select(1, sidx))
        self.bp.copy_(self.nodes.expand_as(self.bp))
        self.score.copy_(torch.nn.functional.pad(entry_lp, (0, pad),
                                                 value=LOG_ZERO)
                         + self.emit[0])
        self.t.fill_(1)

    def step(self) -> None:
        """Frame t: each node's first best in-arc (as `argmax` gives
        it) into backpointer row t, then the emission of row t."""
        cand = self.score[self.src] + self.lp                     # [N, Din]
        best_d = cand.argmax(dim=1, keepdim=True)
        mx = cand.gather(1, best_d)[:, 0]
        self.bp.index_copy_(0, self.t, self.src.gather(1, best_d).view(1, -1))
        emit = self.emit.index_select(0, self.t)[0]
        self.score.copy_(torch.where(mx > _NEG_HALF, mx + emit, LOG_ZERO))
        self.t.add_(1)

    def result(self, exit_lp: torch.Tensor, T: int):
        """(total score, a copy of the [T, N] backpointers, best final
        node) of the chain's N = len(exit_lp) nodes."""
        N = exit_lp.shape[0]
        ended = self.score[:N] + exit_lp
        best_node = ended.argmax()
        return ended[best_node], self.bp[:T, :N].clone(), best_node


def buckets(N: int, T: int) -> Tuple[int, int]:
    """The nodes and frames a captured Viterbi holds for a chain of N
    nodes over T frames: powers of two, at least MIN_N_BUCKET nodes and
    MIN_T_BUCKET frames (pass 1's rule)."""
    return (max(MIN_N_BUCKET, 1 << (N - 1).bit_length()),
            max(MIN_T_BUCKET, 1 << (T - 1).bit_length()))


def _eager(cache: Optional[GraphCache], tables, out_ext: torch.Tensor,
           steps: int):
    """viterbi_chain as a Python loop over the chain's own sizes."""
    (N, Din), T = tables[1].shape, out_ext.shape[0]
    loop = _Viterbi(N, Din, T, out_ext.device)
    loop.load(*tables[:4], out_ext)
    for _ in range(steps):
        loop.step()
    return loop.result(tables[4], T)


def _graphed(cache: GraphCache, tables, out_ext: torch.Tensor, steps: int):
    """viterbi_chain on a CUDA card: `steps` replays of a captured frame,
    keyed by the card, the bucketed nodes, the exact in-arc width and the
    bucketed frames (`buckets`; a padded in-arc column would change the
    backpointer of a dead node, whose float32 sums near LOG_ZERO tie).
    The first chain of a key captures the step (`_capture`) and loads
    again; past GRAPHS_KEPT the oldest entry is dropped.  Nothing falls
    back to the eager loop."""
    (N, Din), T = tables[1].shape, out_ext.shape[0]
    device = out_ext.device
    n_cap, t_cap = buckets(N, T)
    key = (device, n_cap, Din, t_cap)
    with cache.lock, torch.cuda.device(device):
        loop = cache.entries.pop(key, None)
        if loop is None:
            while len(cache.entries) >= GRAPHS_KEPT:
                del cache.entries[next(iter(cache.entries))]
            t0 = time.perf_counter()
            loop = _Viterbi(n_cap, Din, t_cap, device)
            loop.load(*tables[:4], out_ext)
            loop.graph, = _capture(cache, device, loop.step)
            cache.captures += 1
            cache.capture_s += time.perf_counter() - t0
        cache.entries[key] = loop
        loop.load(*tables[:4], out_ext)
        for _ in range(steps):
            loop.graph.replay()
        return loop.result(tables[4], T)


def viterbi_chain(score_idx: torch.Tensor, in_src: torch.Tensor,
                  in_lp: torch.Tensor, entry_lp: torch.Tensor,
                  exit_lp: torch.Tensor, out_ext: torch.Tensor,
                  n_frames: int, graphs: Optional[GraphCache] = None,
                  eager: bool = False):
    """Viterbi over one chain on out_ext's device: [T, R] outprob rows ->
    (total score, [T, N] int64 backpointers, best final node), the first
    two as tensors on that device.  Frames from n_frames on keep the
    scores and point every node at itself.

    On a CUDA card the frames are replays of a captured frame step kept
    in `graphs` (an engine's `align_graphs`; without one, a cache of
    this call's own); eager=True runs the same step once a frame from
    Python at the chain's own sizes instead, the graph's oracle.  The
    CPU always runs that loop."""
    device = out_ext.device
    tables = (score_idx.to(device=device, dtype=torch.int64),
              in_src.to(device=device, dtype=torch.int64),
              in_lp.to(device=device, dtype=torch.float32),
              entry_lp.to(device=device, dtype=torch.float32),
              exit_lp.to(device=device, dtype=torch.float32))
    out_ext = out_ext.to(torch.float32)
    steps = max(0, min(out_ext.shape[0], int(n_frames)) - 1)
    if device.type == "cpu" or eager:
        return _eager(graphs, tables, out_ext, steps)
    return _graphed(graphs if graphs is not None else GraphCache(), tables,
                    out_ext, steps)


@dataclass
class Alignment:
    """Per-unit segments (reference align_...: begin/end frame, score)."""

    words: List[dict]
    phones: List[dict]
    states: List[dict]
    score: float


def align_backtrace(chain: SentenceChain, bp: np.ndarray, best_node: int,
                    n_frames: int, score: float,
                    word_ids: Sequence[int],
                    voca: Vocabulary) -> Alignment:
    """Trace the [T, N] backpointers into state/phone/word segments."""
    path = np.zeros(n_frames, dtype=np.int32)
    n = int(best_node)
    for t in range(n_frames - 1, -1, -1):
        path[t] = n
        n = int(bp[t, n])

    def segs(labels: np.ndarray) -> List[Tuple[int, int, int]]:
        out = []
        start = 0
        for t in range(1, n_frames):
            if labels[path[t]] != labels[path[t - 1]]:
                out.append((int(labels[path[start]]), start, t - 1))
                start = t
        out.append((int(labels[path[start]]), start, n_frames - 1))
        return out

    # state segments: consecutive identical nodes (HTK state numbering
    # starts at 2 like the reference output)
    out_states = []
    start = 0
    for t in range(1, n_frames):
        if path[t] != path[t - 1]:
            nd = path[start]
            out_states.append({
                "phone": chain.phone_names[chain.node_phone[nd]],
                "state": int(chain.node_state[nd]) + 2,
                "begin": start, "end": t - 1})
            start = t
    nd = path[start]
    out_states.append({"phone": chain.phone_names[chain.node_phone[nd]],
                       "state": int(chain.node_state[nd]) + 2,
                       "begin": start, "end": n_frames - 1})

    phones = [{"phone": chain.phone_names[p], "begin": b, "end": e}
              for p, b, e in segs(chain.node_phone)]
    words = [{"word": voca.names[word_ids[w]],
              "text": voca.outputs[word_ids[w]],
              "begin": b, "end": e}
             for w, b, e in segs(chain.node_word)]
    return Alignment(words=words, phones=phones, states=out_states,
                     score=float(score))


def chain_tensors(chain: SentenceChain, device) -> List[torch.Tensor]:
    """(score_idx, in_src, in_lp, entry_lp, exit_lp) of `chain` on
    `device`, as `viterbi_chain` takes them."""
    return [torch.as_tensor(a, device=device) for a in (
        chain.score_idx, chain.in_src, chain.in_lp, chain.entry_lp,
        chain.exit_lp)]


def forced_align(engine, feats, n_frames: int,
                 word_ids: Sequence[int]) -> Alignment:
    """Align one utterance's [T, D] features against a transcript using
    the engine's acoustic scorer on its device (reference
    do_alignment_all, word_align.c:547)."""
    chain = build_chain(engine.hmm, engine.voca, word_ids,
                        pseudo=engine.net.pseudo)
    feats = torch.as_tensor(feats, dtype=torch.float32, device=engine.device)
    if engine.align_graphs is None:
        engine.align_graphs = GraphCache()
    with torch.no_grad():
        out_ext = engine._outprob(feats[None])[0]
        score, bp, best = viterbi_chain(
            *chain_tensors(chain, engine.device), out_ext, int(n_frames),
            graphs=engine.align_graphs)
        score, best = float(score), int(best)
    return align_backtrace(chain, bp.cpu().numpy(), best, int(n_frames),
                           score, word_ids, engine.voca)
