"""Plain word models and the 2-gram, worked out from the model inputs.

A word is a chain of HMM states: its phones' emitting states in order,
the phone's own transitions inside a phone, the exit of one phone times
the entry of the next between phones, the first phone's entry into the
word and the last phone's exit out of it (all ln p).  Where a
configuration has triphones, the word's head phone has no left context
and its tail no right context in pass 1 (Julius's pass-1 approximation,
wchmm.c), so those phones read a pseudo set: every physical triphone
whose name matches with any context there, each state position scored
by its best member's senone score (Julius's outprob_cd under -iwcd1
max).  In pass 2 with strict inter-word
context (Julius's PASS2_STRICT_IWCD) the head phone is resolved with
the previous word's last phone wherever the HMMList has that triphone.
Scores of a state are a column of an extended score matrix: the
senones first, then one column per distinct pseudo set-state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LOG_ZERO = -1.0e10


def center(name: str) -> str:
    i = name.find("-")
    if i >= 0:
        name = name[i + 1:]
    j = name.find("+")
    return name[:j] if j >= 0 else name


def _names(phones: List[str], triphone: bool) -> List[str]:
    if not triphone or len(phones) == 1:
        return list(phones)
    out = []
    for i, p in enumerate(phones):
        s = p
        if i > 0:
            s = f"{phones[i - 1]}-{s}"
        if i < len(phones) - 1:
            s = f"{s}+{phones[i + 1]}"
        out.append(s)
    return out


class Lexicon:
    """Every word's chain, padded to `L` states: `cols` [V, L] score
    columns (padding: the LOG_ZERO column), `arcs` [V, L, L] ln p of
    state i -> j, `entry` / `exit` [V, L] ln p into / out of the word."""

    def __init__(self, model):
        self.model = model
        self.index = {n: i for i, n in enumerate(model.phone_names)}
        self.S = int(model.n_states)
        self.sets: Dict[Tuple[int, ...], int] = {}
        self._phones: Dict[str, tuple] = {}
        self._member_idx = None
        proj_cr: Dict[str, set] = {}
        proj_lc: Dict[str, set] = {}
        if model.triphone:
            for name, pid in list(model.logical_map.items()) \
                    + list(self.index.items()):
                j = name.find("+")
                i = name.find("-")
                proj_lc.setdefault(name[:j] if j >= 0 else name,
                                   set()).add(pid)
                proj_cr.setdefault(name[i + 1:] if i >= 0 else name,
                                   set()).add(pid)
        self._proj = (proj_lc, proj_cr)
        chains = [self._chain(_names(ph, model.triphone))
                  for ph in model.phones]
        self.L = max(len(c[0]) for c in chains)
        V, L = len(chains), self.L
        self.cols = np.full((V, L), -1, np.int64)
        self.arcs = np.full((V, L, L), LOG_ZERO, np.float64)
        self.entry = np.full((V, L), LOG_ZERO, np.float64)
        self.exit = np.full((V, L), LOG_ZERO, np.float64)
        self.length = np.zeros(V, np.int64)
        for w, (cols, arcs, ent, ext) in enumerate(chains):
            n = len(cols)
            self.length[w] = n
            self.cols[w, :n] = cols
            self.arcs[w, :n, :n] = arcs
            self.entry[w, :n] = ent
            self.exit[w, :n] = ext
        self.members = [list(k) for k, _ in sorted(self.sets.items(),
                                                    key=lambda kv: kv[1])]
        # the LOG_ZERO column that padding reads
        self.pad_col = self.S + len(self.members)
        self.cols[self.cols < 0] = self.pad_col

    # -- phones --------------------------------------------------------

    def _physical(self, name: str) -> Optional[int]:
        pid = self.model.logical_map.get(name)
        return self.index.get(name) if pid is None else pid

    def _phone(self, name: str):
        """(columns of the phone's states, its ln p transitions)."""
        if name not in self._phones:
            self._phones[name] = self._resolve(name)
        return self._phones[name]

    def _resolve(self, name: str):
        m = self.model
        pid = self._physical(name)
        if pid is not None:
            ns = int(m.phone_ns[pid])
            return ([int(m.phone_states[pid, s]) for s in range(ns)],
                    np.asarray(m.phone_trans[pid], np.float64))
        proj_lc, proj_cr = self._proj
        if "+" in name and "-" not in name:
            cands = sorted(proj_cr.get(name, ()))
        elif "-" in name and "+" not in name:
            cands = sorted(proj_lc.get(name, ()))
        else:
            cands = []
        if not cands:
            return self._phone(center(name))
        ns = max(int(m.phone_ns[p]) for p in cands)
        cols = []
        for pos in range(ns):
            key = tuple(sorted({int(m.phone_states[p, pos]) for p in cands
                                if pos < m.phone_ns[p]}))
            cols.append(self.S + self.sets.setdefault(key, len(self.sets)))
        return cols, np.asarray(m.phone_trans[cands[0]], np.float64)

    def _chain(self, names: List[str], head=None):
        """(cols, arcs [n, n], entry [n], exit [n]) of one word; `head`
        replaces the first phone's columns."""
        phones = [self._phone(n) for n in names]
        if head is not None:
            phones[0] = (head, phones[0][1])
        n = sum(len(c) for c, _ in phones)
        arcs = np.full((n, n), LOG_ZERO)
        entry = np.full(n, LOG_ZERO)
        exit_ = np.full(n, LOG_ZERO)
        cols: List[int] = []
        prev_exit: List[Tuple[int, float]] = []
        for k, (pc, tr) in enumerate(phones):
            ns = len(pc)
            o = len(cols)
            cols.extend(pc)
            for i in range(ns):
                for j in range(ns):
                    if tr[i + 1, j + 1] > LOG_ZERO / 2:
                        arcs[o + i, o + j] = tr[i + 1, j + 1]
            for j in range(ns):
                if tr[0, j + 1] <= LOG_ZERO / 2:
                    continue
                if k == 0:
                    entry[o + j] = tr[0, j + 1]
                for src, lp in prev_exit:
                    arcs[src, o + j] = max(arcs[src, o + j],
                                           lp + tr[0, j + 1])
            prev_exit = [(o + i, tr[i + 1, ns + 1]) for i in range(ns)
                         if tr[i + 1, ns + 1] > LOG_ZERO / 2]
        for src, lp in prev_exit:
            exit_[src] = lp
        return cols, arcs, entry, exit_

    def strict_head(self, w: int, prev: Optional[int]) -> Optional[List[int]]:
        """Pass 2's head columns of word w after word `prev`: the exact
        triphone of the previous word's last phone where the HMMList
        has it (and it has as many states as the pass-1 head), else
        None (the pass-1 columns stay)."""
        m = self.model
        if not m.triphone or prev is None or not m.phones[prev]:
            return None
        ph = m.phones[w]
        lc = center(m.phones[prev][-1])
        right = center(ph[1]) if len(ph) > 1 else None
        tri = f"{lc}-{center(ph[0])}" + (f"+{right}" if right else "")
        pid = self._physical(tri)
        head = _names(ph, True)[0]
        n_head = len(self._phone(head)[0])
        if pid is None or int(m.phone_ns[pid]) != n_head:
            return None
        return [int(m.phone_states[pid, s]) for s in range(n_head)]

    def sentence(self, words: List[int], strict: bool):
        """The chain of a whole sentence: each word's chain in turn, a
        word's exits joined to the next word's entries.  Returns (cols,
        arcs, entry, exit)."""
        parts = []
        for i, w in enumerate(words):
            head = self.strict_head(w, words[i - 1] if i else None) \
                if strict else None
            names = _names(self.model.phones[w], self.model.triphone)
            parts.append(self._chain(names, head))
        n = sum(len(p[0]) for p in parts)
        arcs = np.full((n, n), LOG_ZERO)
        cols: List[int] = []
        entry = exit_ = None
        for cols_w, arcs_w, ent_w, ext_w in parts:
            o = len(cols)
            k = len(cols_w)
            cols.extend(cols_w)
            arcs[o:o + k, o:o + k] = arcs_w
            if exit_ is None:
                entry = np.full(n, LOG_ZERO)
                entry[:k] = ent_w
            else:
                src = np.flatnonzero(exit_ > LOG_ZERO / 2)
                dst = np.flatnonzero(ent_w > LOG_ZERO / 2)
                for s in src:
                    arcs[s, o + dst] = np.maximum(arcs[s, o + dst],
                                                  exit_[s] + ent_w[dst])
            exit_ = np.full(n, LOG_ZERO)
            exit_[o:o + k] = ext_w
        return (np.asarray([c if c >= 0 else self.pad_col for c in cols]),
                arcs, entry, exit_)

    def extend(self, senone: torch.Tensor, scheme: str) -> torch.Tensor:
        """[T, S] senone scores -> [T, S + Q + 1]: each pseudo
        set-state's score after them (the best member's, Julius's
        -iwcd1 max) and a LOG_ZERO column."""
        if self.members and scheme != "max":
            raise ValueError(f"pseudo sets scored by {scheme!r}: the "
                             "reference has only -iwcd1 max")
        cols = [senone]
        if self.members:
            if self._member_idx is None:
                width = max(len(m) for m in self.members)
                # each set padded with its own first member, which leaves
                # its maximum as it is
                self._member_idx = torch.as_tensor(
                    [m + m[:1] * (width - len(m)) for m in self.members],
                    device=senone.device)
            cols.append(senone[:, self._member_idx].amax(dim=2))
        cols.append(senone.new_full((senone.shape[0], 1), LOG_ZERO))
        return torch.cat(cols, dim=1)


class Bigram:
    """log10 P(w | v) of the model's 2-gram with back-off; v = -1 (no
    context) gives the unigram."""

    def __init__(self, model):
        self.uni = {w: p for w, (p, _) in model.uni.items()}
        self.bo = {w: b for w, (_, b) in model.uni.items()}
        self.bi = model.bi

    def __call__(self, v: int, w: int) -> float:
        if v < 0:
            return self.uni[w]
        p = self.bi.get((v, w))
        return p if p is not None else self.bo[v] + self.uni[w]
