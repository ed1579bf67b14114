"""Plain Viterbi over word and sentence chains, in float64.

`word_scores` gives, for each (word, first frame, last frame), the best
score of the word's chain over exactly those frames: entered at the
first frame, left at the last, every frame scored by its state's column
of the extended score matrix.  `sentence_scores` does the same for a
whole sentence's chain over a whole utterance.  Both are dense maxima
over every state pair, with no beam.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

LOG_ZERO = -1.0e10


def word_scores(lex, ext: torch.Tensor, rows0: np.ndarray, words: np.ndarray,
                begins: np.ndarray, ends: np.ndarray,
                chunk: int = 16384) -> np.ndarray:
    """Best in-word score of each (word, begin, end); frame f of an
    item reads row rows0[i] + f of `ext` ([rows, C] float64)."""
    dev = ext.device
    n = len(words)
    out = np.empty(n, np.float64)
    if n == 0:
        return out
    cols_all = torch.as_tensor(lex.cols, device=dev)
    arcs_all = torch.as_tensor(lex.arcs, device=dev)
    ent_all = torch.as_tensor(lex.entry, device=dev)
    ext_all = torch.as_tensor(lex.exit, device=dev)
    span = ends - begins
    order = np.argsort(span, kind="stable")
    for c0 in range(0, n, chunk):
        sel = order[c0:c0 + chunk]
        w = torch.as_tensor(words[sel], device=dev)
        row = torch.as_tensor(rows0[sel] + begins[sel], device=dev)
        sp = torch.as_tensor(span[sel], device=dev)
        cols, arcs = cols_all[w], arcs_all[w]
        delta = ent_all[w] + ext[row[:, None], cols]
        for f in range(1, int(span[sel].max()) + 1):
            live = (sp >= f)[:, None]
            r = torch.where(sp >= f, row + f, row)
            cand = (delta[:, :, None] + arcs).amax(dim=1) \
                + ext[r[:, None], cols]
            delta = torch.where(live, cand, delta)
        out[sel] = (delta + ext_all[w]).amax(dim=1).cpu().numpy()
    return out


def sentence_scores(chains: Sequence, ext_rows: List[torch.Tensor]
                    ) -> np.ndarray:
    """Best score of each sentence chain (cols, arcs, entry, exit) over
    all frames of its [T, C] float64 score rows."""
    if not chains:
        return np.zeros(0)
    dev = ext_rows[0].device
    n = max(len(c[0]) for c in chains)
    K = len(chains)
    T = torch.as_tensor([e.shape[0] for e in ext_rows], device=dev)
    Tmax = int(T.max())
    pad_col = [e.shape[1] - 1 for e in ext_rows]
    cols = np.zeros((K, n), np.int64)
    arcs = np.full((K, n, n), LOG_ZERO)
    ent = np.full((K, n), LOG_ZERO)
    exi = np.full((K, n), LOG_ZERO)
    for k, (c, a, e, x) in enumerate(chains):
        m = len(c)
        cols[k] = pad_col[k]
        cols[k, :m], arcs[k, :m, :m], ent[k, :m], exi[k, :m] = c, a, e, x
    rows = torch.stack([torch.nn.functional.pad(
        e, (0, 0, 0, Tmax - e.shape[0]), value=LOG_ZERO) for e in ext_rows])
    cols_t = torch.as_tensor(cols, device=dev)
    arcs_t = torch.as_tensor(arcs, device=dev)
    kk = torch.arange(K, device=dev)[:, None]
    delta = torch.as_tensor(ent, device=dev) + rows[kk, 0, cols_t]
    for f in range(1, Tmax):
        cand = (delta[:, :, None] + arcs_t).amax(dim=1) + rows[kk, f, cols_t]
        delta = torch.where((T > f)[:, None], cand, delta)
    return (delta + torch.as_tensor(exi, device=dev)).amax(dim=1).cpu().numpy()


def forced_alignment(chains: Sequence, owners: List[np.ndarray],
                     ext_rows: List[torch.Tensor]):
    """The best path of each sentence chain over all frames of its
    [T, C] float64 score rows, as `sentence_scores` scores it, followed
    back: returns (scores, ends), ends[k] holding the last frame of each
    word of sentence k on that path.  owners[k] gives the word (its
    position in the sentence) of each state of chain k."""
    if not chains:
        return np.zeros(0), []
    dev = ext_rows[0].device
    n = max(len(c[0]) for c in chains)
    K = len(chains)
    T = torch.as_tensor([e.shape[0] for e in ext_rows], device=dev)
    Tmax = int(T.max())
    cols = np.zeros((K, n), np.int64)
    arcs = np.full((K, n, n), LOG_ZERO)
    ent = np.full((K, n), LOG_ZERO)
    exi = np.full((K, n), LOG_ZERO)
    for k, (c, a, e, x) in enumerate(chains):
        m = len(c)
        cols[k] = ext_rows[k].shape[1] - 1
        cols[k, :m], arcs[k, :m, :m], ent[k, :m], exi[k, :m] = c, a, e, x
    rows = torch.stack([torch.nn.functional.pad(
        e, (0, 0, 0, Tmax - e.shape[0]), value=LOG_ZERO) for e in ext_rows])
    cols_t = torch.as_tensor(cols, device=dev)
    arcs_t = torch.as_tensor(arcs, device=dev)
    kk = torch.arange(K, device=dev)[:, None]
    delta = torch.as_tensor(ent, device=dev) + rows[kk, 0, cols_t]
    back = []
    for f in range(1, Tmax):
        best, arg = (delta[:, :, None] + arcs_t).max(dim=1)
        delta = torch.where((T > f)[:, None], best + rows[kk, f, cols_t],
                            delta)
        back.append(arg.to(torch.int16))
    final = delta + torch.as_tensor(exi, device=dev)
    scores, last = final.max(dim=1)
    back = (torch.stack(back, dim=1).cpu().numpy() if back
            else np.zeros((K, 0, n), np.int16))
    last = last.cpu().numpy()
    ends = []
    for k in range(K):
        Tk = ext_rows[k].shape[0]
        path = np.empty(Tk, np.int64)
        s = int(last[k])
        for f in range(Tk - 1, -1, -1):
            path[f] = s
            if f:
                s = int(back[k, f - 1, s])
        word = np.asarray(owners[k])[path]
        ends.append(np.flatnonzero(np.diff(np.append(word, -1)) != 0))
    return scores.cpu().numpy(), ends
