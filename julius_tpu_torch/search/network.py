"""Decode network: the tree-lexicon (wchmm) equivalent as dense arrays.

The reference compiles the dictionary into a state-level prefix tree with
pointer-chased per-node arrays (`libjulius/src/wchmm.c:1749` build_wchmm2,
`wchmm.h:211-278` WCHMM_INFO) because a 2005-era CPU could not afford to
score or propagate every state.  A TPU can: this module compiles each word
into an independent linear HMM chain ("flat lexicon") and stores, for every
network node, a fixed-width *incoming arc* table:

    in_src[N, Din] int32, in_lp[N, Din] f32

so the per-frame Viterbi update is a dense gather + max-reduce — no
scatter, no tokens, no tree.  Prefix sharing in the reference exists to
save compute and forces the 1-gram *factoring* machinery
(`factoring_sub.c`) to approximate LM scores on shared nodes; with a flat
lexicon the word identity is known at entry, so pass 1 applies each word's
own unigram at entry and the exact 2-gram correction at word end (see
pass1.py) — strictly tighter than the reference's shared-node max-unigram
factoring.

Cross-word context dependency follows the reference's pass-1 approximation
(`outprob_style.c`, iwcd1 "best" mode): word-head phones use pseudo
context sets with free left context ("p+r"), word-tail phones free right
context ("l-p"), aggregated by max over member senones (ops/gmm.py
pseudo_scores).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import (HMMSet, PseudoPhoneSets, build_pseudo_sets,
                                   compose_triphone)
from julius_tpu_torch.utils.logadd import LOG_ZERO

_NEG_HALF = LOG_ZERO / 2


@dataclass
class DecodeNetwork:
    """Flat decode network over the whole vocabulary (host-side numpy)."""

    # nodes
    score_idx: np.ndarray        # [N] int32 row into extended outprob table
    in_src: np.ndarray           # [N, Din] int32 source node (pad: self)
    in_lp: np.ndarray            # [N, Din] f32 ln transition (pad: LOG_ZERO)
    entry_word: np.ndarray       # [N] int32 word id, -1 = not an entry node
    entry_lp: np.ndarray         # [N] f32
    exit_word: np.ndarray        # [N] int32 word id, -1 = not an exit node
    exit_lp: np.ndarray          # [N] f32
    # word metadata
    word_node_ofs: np.ndarray    # [V+1] int32 node range of each word
    n_score_rows: int            # S + n pseudo set-states
    pseudo: Optional[PseudoPhoneSets]
    head_word: int               # vocabulary id of the head sil word (<s>)
    tail_word: int               # vocabulary id of the tail sil word (</s>)

    @property
    def n_nodes(self) -> int:
        return len(self.score_idx)

    @property
    def n_words(self) -> int:
        return len(self.word_node_ofs) - 1


def _phone_entry_pairs(trans: np.ndarray, ns: int) -> Tuple[List[Tuple[int, float]], float]:
    """Entry distribution of one phone: [(emitting state, ln p)], tee lp."""
    pairs = [(j, float(trans[0, j + 1]))
             for j in range(ns) if trans[0, j + 1] > _NEG_HALF]
    tee = float(trans[0, ns + 1])
    return pairs, tee


def _resolve_phone(hmm: HMMSet, pseudo: Optional[PseudoPhoneSets],
                   name: str) -> Tuple[str, int]:
    """Resolve a (tri)phone name -> ('phys', phone id) or ('pseudo', set id).

    Falls back like the reference voca_load_htkdict.c: exact logical ->
    physical -> pseudo set -> center monophone."""
    pid = hmm.logical_map.get(name)
    if pid is None:
        pid = hmm.phone_index.get(name)
    if pid is not None:
        return "phys", pid
    if pseudo is not None and name in pseudo.name_index:
        return "pseudo", pseudo.name_index[name]
    from julius_tpu_torch.models.hmm import center_name
    c = center_name(name)
    pid = hmm.logical_map.get(c, hmm.phone_index.get(c))
    if pid is not None:
        return "phys", pid
    if pseudo is not None and c in pseudo.name_index:
        return "pseudo", pseudo.name_index[c]
    raise KeyError(f"cannot resolve phone '{name}' in acoustic model")


def word_phone_names(phones: Sequence[str], use_triphone: bool) -> List[str]:
    """Dictionary base phones -> network phone names with cross-word
    approximation: head phone left-context-free, tail phone
    right-context-free (reference wchmm.c cross-word pseudo assignment)."""
    if not use_triphone:
        return list(phones)
    n = len(phones)
    if n == 1:
        return [phones[0]]
    out = []
    for i, p in enumerate(phones):
        left = phones[i - 1] if i > 0 else None
        right = phones[i + 1] if i < n - 1 else None
        out.append(compose_triphone(left, p, right))
    return out


def build_network(
    hmm: HMMSet,
    voca: Vocabulary,
    use_triphone: Optional[bool] = None,
    pseudo: Optional[PseudoPhoneSets] = None,
    iwsp: bool = False,
    sp_name: str = "sp",
    iwsp_penalty: float = -1.0,
) -> DecodeNetwork:
    """Compile vocabulary + HMM set into a flat decode network.

    iwsp appends a skippable short-pause model after every word
    (reference -iwsp multipath mode, wchmm.c iwsp insertion): the word
    may exit directly or through the sp states, entered with
    iwsp_penalty (default.c:144)."""
    if use_triphone is None:
        use_triphone = hmm.names_are_triphone

    # collect all phone names; build pseudo sets for unresolvable ones
    all_names: List[List[str]] = []
    for phones in voca.phones:
        all_names.append(word_phone_names(phones, use_triphone))
    if pseudo is None:
        need = sorted({
            n for names in all_names for n in names
            if n not in hmm.logical_map and n not in hmm.phone_index
        })
        pseudo = build_pseudo_sets(hmm, need) if need else None

    S = hmm.n_states
    score_idx: List[int] = []
    arcs: List[Tuple[int, int, float]] = []      # (src, dst, lp)
    entry_word: List[int] = []
    entry_lp: List[float] = []
    exit_word: List[int] = []
    exit_lp: List[float] = []
    word_node_ofs = [0]

    def add_node(sidx: int) -> int:
        score_idx.append(sidx)
        entry_word.append(-1)
        entry_lp.append(LOG_ZERO)
        exit_word.append(-1)
        exit_lp.append(LOG_ZERO)
        return len(score_idx) - 1

    for w, names in enumerate(all_names):
        # frontier: (src_node or -1 for word entry, accumulated ln p)
        frontier: List[Tuple[int, float]] = [(-1, 0.0)]
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
            nodes = [add_node(sidx_of(j)) for j in range(ns)]
            epairs, tee = _phone_entry_pairs(trans, ns)
            # connect frontier into this phone's entry states
            for src, acc in frontier:
                for j, elp in epairs:
                    lp = acc + elp
                    if lp <= _NEG_HALF:
                        continue
                    if src < 0:
                        if lp > entry_lp[nodes[j]]:
                            entry_word[nodes[j]] = w
                            entry_lp[nodes[j]] = lp
                    else:
                        arcs.append((src, nodes[j], lp))
            # internal arcs (self loops + forward/skip)
            for i in range(ns):
                for j in range(ns):
                    lp = float(trans[i + 1, j + 1])
                    if lp > _NEG_HALF:
                        arcs.append((nodes[i], nodes[j], lp))
            # next frontier: exits of this phone (+ tee pass-through)
            nxt = [(nodes[i], float(trans[i + 1, ns + 1]))
                   for i in range(ns) if trans[i + 1, ns + 1] > _NEG_HALF]
            if tee > _NEG_HALF:
                nxt.extend((src, acc + tee) for src, acc in frontier)
            frontier = nxt
        if iwsp:
            sp = hmm.logical_map.get(sp_name, hmm.phone_index.get(sp_name))
            if sp is not None:
                ns = int(hmm.phone_ns[sp])
                trans = hmm.phone_trans[sp]
                nodes = [add_node(int(hmm.phone_states[sp, j]))
                         for j in range(ns)]
                epairs, _tee = _phone_entry_pairs(trans, ns)
                for src, acc in frontier:
                    if src < 0:
                        continue
                    for j, elp in epairs:
                        lp = acc + elp + iwsp_penalty
                        if lp > _NEG_HALF:
                            arcs.append((src, nodes[j], lp))
                for i in range(ns):
                    for j in range(ns):
                        lp = float(trans[i + 1, j + 1])
                        if lp > _NEG_HALF:
                            arcs.append((nodes[i], nodes[j], lp))
                # word may end through sp (in addition to skipping it)
                frontier = frontier + [
                    (nodes[i], float(trans[i + 1, ns + 1]))
                    for i in range(ns) if trans[i + 1, ns + 1] > _NEG_HALF]
        for src, acc in frontier:
            if src < 0:
                raise ValueError(
                    f"word {voca.names[w]} is entirely tee (empty acoustics)")
            if acc > exit_lp[src]:
                exit_word[src] = w
                exit_lp[src] = acc
        word_node_ofs.append(len(score_idx))

    N = len(score_idx)
    # incoming-arc table, padded to max in-degree
    by_dst: Dict[int, List[Tuple[int, float]]] = {}
    for src, dst, lp in arcs:
        by_dst.setdefault(dst, []).append((src, lp))
    din = max((len(v) for v in by_dst.values()), default=1)
    in_src = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, din))
    in_lp = np.full((N, din), LOG_ZERO, dtype=np.float32)
    for dst, lst in by_dst.items():
        for k, (src, lp) in enumerate(lst):
            in_src[dst, k] = src
            in_lp[dst, k] = lp

    n_pseudo = pseudo.n_set_states if pseudo is not None else 0
    head = voca.head_silword if voca.head_silword >= 0 else 0
    tail = voca.tail_silword if voca.tail_silword >= 0 else 0
    return DecodeNetwork(
        score_idx=np.asarray(score_idx, dtype=np.int32),
        in_src=in_src,
        in_lp=in_lp,
        entry_word=np.asarray(entry_word, dtype=np.int32),
        entry_lp=np.asarray(entry_lp, dtype=np.float32),
        exit_word=np.asarray(exit_word, dtype=np.int32),
        exit_lp=np.asarray(exit_lp, dtype=np.float32),
        word_node_ofs=np.asarray(word_node_ofs, dtype=np.int32),
        n_score_rows=S + n_pseudo,
        pseudo=pseudo,
        head_word=head,
        tail_word=tail,
    )
