"""Word lattice, posteriors, confusion network and MBR.

Reference: `libjulius/src/graphout.c` (word graph generated during pass 2,
dynamic merge + post passes), `confnet.c:697` confnet_create,
`mbr.c:400` candidate_mbr.

Here the word graph derives from the pass-1 trellis directly (every
recorded word-end atom is a graph word; adjacency = frame-contiguity),
posteriors come from an exact forward-backward over that DAG, the
confusion network from posterior-weighted clustering, and MBR re-ranks
the pass-2 N-best by expected word error against the N-best posterior
distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from julius_tpu_torch.search.pass2 import NBestResult, TrellisLattice


@dataclass
class GraphWord:
    """One lattice word (reference WordGraph struct, graph.h)."""

    id: int
    word: int           # vocab word id
    begin: int
    end: int
    score: float        # pass-1 cumulative score at word end
    am: float           # acoustic score of the span
    lm: float           # pass-1 LM score
    left: List[int] = field(default_factory=list)    # predecessor ids
    right: List[int] = field(default_factory=list)   # successor ids
    posterior: float = 0.0


@dataclass
class WordGraph:
    words: List[GraphWord]
    n_frames: int

    def __len__(self):
        return len(self.words)


def build_word_graph(lattice: TrellisLattice,
                     scale: float = 0.05) -> WordGraph:
    """Trellis -> word DAG with link lists and posteriors.

    scale: acoustic score scaling for posterior computation (the
    reference's graph posteriors use CM alpha-like scaling)."""
    words: List[GraphWord] = []
    index: Dict[Tuple[int, int], int] = {}
    for t in range(lattice.T):
        for m in range(lattice.M):
            if lattice.word[t, m] < 0:
                continue
            gid = len(words)
            index[(t, m)] = gid
            words.append(GraphWord(
                id=gid,
                word=int(lattice.word[t, m]),
                begin=int(lattice.begin[t, m]),
                end=t,
                score=float(lattice.score[t, m]),
                am=lattice.am_of(t, m),
                lm=float(lattice.lm[t, m]),
            ))
    # adjacency by frame contiguity
    by_begin: Dict[int, List[int]] = {}
    for w in words:
        by_begin.setdefault(w.begin, []).append(w.id)
    for w in words:
        for nid in by_begin.get(w.end + 1, []):
            w.right.append(nid)
            words[nid].left.append(w.id)
    g = WordGraph(words=words, n_frames=lattice.T)
    _compute_posteriors(g, scale)
    return g


def _logsumexp(xs: np.ndarray) -> float:
    if len(xs) == 0:
        return -np.inf
    m = np.max(xs)
    if not np.isfinite(m):
        return -np.inf
    return float(m + np.log(np.sum(np.exp(xs - m))))


def _compute_posteriors(g: WordGraph, scale: float) -> None:
    """Exact forward-backward over the word DAG in log space; edge
    scores are the scaled per-word (AM + LM) contributions."""
    n = len(g.words)
    if n == 0:
        return
    order = sorted(range(n), key=lambda i: g.words[i].end)
    alpha = np.full(n, -np.inf)
    beta = np.full(n, -np.inf)
    local = np.asarray([scale * (w.am + w.lm) for w in g.words])
    for i in order:
        w = g.words[i]
        if w.begin == 0:
            alpha[i] = local[i]
        else:
            pa = [alpha[j] for j in w.left]
            alpha[i] = _logsumexp(np.asarray(pa)) + local[i] if pa else -np.inf
    for i in reversed(order):
        w = g.words[i]
        if w.end == g.n_frames - 1:
            beta[i] = 0.0
        else:
            pb = [beta[j] + local[j] for j in w.right]
            beta[i] = _logsumexp(np.asarray(pb)) if pb else -np.inf
    total = _logsumexp(np.asarray(
        [alpha[i] for i in range(n) if g.words[i].end == g.n_frames - 1]))
    for i in range(n):
        v = alpha[i] + beta[i] - total
        g.words[i].posterior = float(np.exp(v)) if np.isfinite(v) else 0.0


def build_word_graph_pass2(gwords: Dict, n_frames: int,
                           scale: float = 0.05) -> WordGraph:
    """Pass-2 word graph: words collected DURING the rescanned A*
    (reference wordgraph_assign graphout.c:1901, dynamic merge :2020),
    so AM spans are re-scanned exact scores under hypothesis context
    and LM scores are the pass-2 weighted N-gram values — not pass-1
    approximations.

    gwords: {(word, begin, end): (cum, am, lm)} from
    pass2_rescan.rescan_nbest_batch(graphs=...)."""
    words: List[GraphWord] = []
    for (w, b, e), (cum, am, lm) in sorted(gwords.items(),
                                           key=lambda kv: kv[0][2]):
        words.append(GraphWord(
            id=len(words), word=int(w), begin=int(b), end=int(e),
            score=float(cum), am=float(am), lm=float(lm)))
    by_begin: Dict[int, List[int]] = {}
    for w in words:
        by_begin.setdefault(w.begin, []).append(w.id)
    for w in words:
        for nid in by_begin.get(w.end + 1, []):
            w.right.append(nid)
            words[nid].left.append(w.id)
    g = WordGraph(words=words, n_frames=n_frames)
    _compute_posteriors(g, scale)
    return g


def prune_graph(g: WordGraph, min_posterior: float = 1e-4) -> WordGraph:
    """Drop words below a posterior floor and unreachable words
    (reference wordgraph_clean / depth cut, graphout.c:871,1050)."""
    keep = [w for w in g.words
            if w.posterior >= min_posterior or w.begin == 0
            or w.end == g.n_frames - 1]
    remap = {w.id: i for i, w in enumerate(keep)}
    out = []
    for i, w in enumerate(keep):
        out.append(GraphWord(
            id=i, word=w.word, begin=w.begin, end=w.end, score=w.score,
            am=w.am, lm=w.lm,
            left=[remap[j] for j in w.left if j in remap],
            right=[remap[j] for j in w.right if j in remap],
            posterior=w.posterior,
        ))
    return WordGraph(words=out, n_frames=g.n_frames)


def graph_to_text(g: WordGraph, names: List[str],
                  frame_shift_s: float = 0.01) -> str:
    """Dump in the reference's lattice text format (graphout.c
    wordgraph_dump: one line per word with id, time span, name, scores,
    left/right link lists)."""
    lines = []
    for w in g.words:
        left = ",".join(str(j) for j in w.left) or "-"
        right = ",".join(str(j) for j in w.right) or "-"
        lines.append(
            f"{w.id}: [{w.begin}..{w.end}] {names[w.word]} "
            f"AMavg={w.am / max(1, w.end - w.begin + 1):.6f} "
            f"AM={w.am:.6f} LM={w.lm:.6f} graphcm={w.posterior:.6f} "
            f"begintime={w.begin * frame_shift_s:.2f} "
            f"endtime={(w.end + 1) * frame_shift_s:.2f} "
            f"left={left} right={right}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Confusion network (reference confnet.c:697)
# ---------------------------------------------------------------------------

@dataclass
class CNCluster:
    """One confusion slot: word alternatives with posteriors
    (reference CN_CLUSTER)."""

    words: List[int]
    probs: List[float]
    begin: int
    end: int

    def best(self) -> Tuple[int, float]:
        i = int(np.argmax(self.probs))
        return self.words[i], self.probs[i]


def _order_matrix(g: WordGraph) -> np.ndarray:
    """order[i, j] = a path exists from word i to word j (reference
    graph_make_order, confnet.c:154).  Transitive closure by topological
    DP over the DAG."""
    n = len(g.words)
    order = np.zeros((n, n), dtype=bool)
    topo = sorted(range(n), key=lambda i: g.words[i].end, reverse=True)
    for i in topo:
        for j in g.words[i].right:
            order[i, j] = True
            order[i] |= order[j]
    return order


def confusion_network(g: WordGraph) -> List[CNCluster]:
    """Consensus clustering under the lattice partial order: two words
    may share a slot only if no path orders them (reference confnet.c
    intra-/inter-word merging over the order matrix; Mangu-style
    consensus restricted to the pass-1 lattice)."""
    if not g.words:
        return []
    order = _order_matrix(g)

    # greedy intra-word then inter-word merging, highest posterior first
    groups: List[List[int]] = []     # clusters of word ids

    def ordered(gi: List[int], gj: List[int]) -> bool:
        for a in gi:
            for b in gj:
                if order[a, b] or order[b, a]:
                    return True
        return False

    def overlap(gi: List[int], gj: List[int]) -> bool:
        b1 = min(g.words[a].begin for a in gi)
        e1 = max(g.words[a].end for a in gi)
        b2 = min(g.words[a].begin for a in gj)
        e2 = max(g.words[a].end for a in gj)
        return not (e1 < b2 or e2 < b1)

    # intra-word merge: same word, time-overlapping, unordered
    for wid in sorted(range(len(g.words)),
                      key=lambda i: -g.words[i].posterior):
        placed = False
        for grp in groups:
            if (g.words[grp[0]].word == g.words[wid].word
                    and overlap(grp, [wid]) and not ordered(grp, [wid])):
                grp.append(wid)
                placed = True
                break
        if not placed:
            groups.append([wid])

    # inter-word merge: unordered + overlapping groups, posterior-greedy
    def gpost(grp):
        return sum(g.words[a].posterior for a in grp)

    groups.sort(key=gpost, reverse=True)
    slots: List[List[int]] = []
    for grp in groups:
        placed = False
        for slot in slots:
            if overlap(slot, grp) and not ordered(slot, grp):
                slot.extend(grp)
                placed = True
                break
        if not placed:
            slots.append(list(grp))

    clusters: List[CNCluster] = []
    for slot in slots:
        agg: Dict[int, float] = {}
        for a in slot:
            agg[g.words[a].word] = agg.get(g.words[a].word, 0.0) \
                + g.words[a].posterior
        words = sorted(agg, key=lambda w: -agg[w])
        probs = [agg[w] for w in words]
        z = sum(probs)
        if z > 1.0:
            probs = [p / z for p in probs]
        clusters.append(CNCluster(
            words=words, probs=probs,
            begin=min(g.words[a].begin for a in slot),
            end=max(g.words[a].end for a in slot)))
    clusters.sort(key=lambda c: (c.begin + c.end, c.begin))
    return clusters


# ---------------------------------------------------------------------------
# MBR re-ranking (reference mbr.c candidate_mbr:400)
# ---------------------------------------------------------------------------

def edit_distance(a: List[int], b: List[int],
                  weights: Optional[np.ndarray] = None) -> float:
    """Word-level Levenshtein; optional per-word weights (reference
    USE_MBR weighted word error)."""
    la, lb = len(a), len(b)
    d = np.zeros((la + 1, lb + 1))
    for i in range(1, la + 1):
        d[i, 0] = d[i - 1, 0] + (weights[a[i - 1]] if weights is not None else 1.0)
    for j in range(1, lb + 1):
        d[0, j] = d[0, j - 1] + (weights[b[j - 1]] if weights is not None else 1.0)
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0.0 if a[i - 1] == b[j - 1] else (
                weights[a[i - 1]] if weights is not None else 1.0)
            d[i, j] = min(d[i - 1, j - 1] + cost,
                          d[i - 1, j] + (weights[a[i - 1]] if weights is not None else 1.0),
                          d[i, j - 1] + (weights[b[j - 1]] if weights is not None else 1.0))
    return float(d[la, lb])


def mbr_rerank(results: List[NBestResult], score_scale: float = 0.1,
               weights: Optional[np.ndarray] = None) -> List[NBestResult]:
    """Re-rank the N-best by minimum Bayes risk under the posterior
    distribution implied by the (scaled) hypothesis scores."""
    if len(results) <= 1:
        return results
    scores = np.asarray([r.score for r in results]) * score_scale
    post = np.exp(scores - np.max(scores))
    post = post / post.sum()
    risks = []
    for r in results:
        risk = sum(p * edit_distance(r.word_ids, r2.word_ids, weights)
                   for r2, p in zip(results, post) if r2 is not r)
        risks.append(risk)
    order = np.argsort(risks, kind="stable")
    return [results[i] for i in order]
