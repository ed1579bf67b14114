"""DFA grammar reader (.dfa) and grammar structures.

Copy of `julius_tpu/io/dfa.py` (plain Python).  Reference:
libsent/src/dfa/rddfa.c:143 — line format ``state terminalID nextstate
statuscode`` (statuscode is hex; bit 0x1 marks an accept state; state 0
is initial).  Arcs with negative terminal and next state are status-only
lines.  Also builds the category-pair constraint
table used as the pass-1 inter-word constraint (reference
libsent/src/dfa/{cpair.c,mkcpair.c}).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

ACCEPT_S = 0x01
INITIAL_S = 0x02


@dataclass
class DFAGrammar:
    """DFA_INFO equivalent (reference libsent/include/sent/dfa.h).

    IMPORTANT direction convention: a Julius ``.dfa`` is generated from
    the *reversed* grammar (gramtools/mkdfa/mkdfa.py:26
    gen_reverse_grammar) — it accepts sentences read from last word to
    first.  All helpers below account for that."""

    n_states: int = 0
    n_terms: int = 0
    # arcs[s] = list of (category, next_state)
    arcs: List[List[Tuple[int, int]]] = field(default_factory=list)
    accept: List[bool] = field(default_factory=list)
    initial: List[bool] = field(default_factory=list)
    # category id -> word ids (filled from the paired .dict, mkterminfo.c)
    term_words: List[List[int]] = field(default_factory=list)
    sp_category: int = -1

    def category_pair_matrix(self):
        """(cp, cp_begin, cp_end): cp[i, j] = can category j follow
        category i in FORWARD sentence order; cp_begin = may start the
        sentence; cp_end = may end it (reference mkcpair.c
        extract_cpair, accounting for the reversed-DFA convention:
        an arc pair left-then-right in the DFA means right-then-left in
        the spoken sentence, so cp[right, left] is set; arcs into accept
        states carry sentence-INITIAL categories; arcs out of initial
        states carry sentence-FINAL ones)."""
        C = self.n_terms
        cp = np.zeros((C, C), dtype=bool)
        cp_begin = np.zeros(C, dtype=bool)
        cp_end = np.zeros(C, dtype=bool)
        for s in range(self.n_states):
            if self.initial[s]:
                for (cat, _to) in self.arcs[s]:
                    cp_end[cat] = True
            for (left, to) in self.arcs[s]:
                if self.accept[to]:
                    cp_begin[left] = True
                for (right, _to2) in self.arcs[to]:
                    cp[right, left] = True
        return cp, cp_begin, cp_end

    def next_categories(self, state: int) -> List[Tuple[int, int]]:
        return self.arcs[state]

    def reverse_nfa_step(self, gset: frozenset, cat: int) -> frozenset:
        """Forward-direction NFA simulation of the reversed DFA: given
        the set g of states from which consuming the (reversed) sentence
        so far reaches accept, return the set after prepending one more
        word of category ``cat`` to the reversed run (i.e. appending it
        in forward order):  g' = { q : delta(q, cat) in g }."""
        out = set()
        for q in range(self.n_states):
            for (c, to) in self.arcs[q]:
                if c == cat and to in gset:
                    out.add(q)
                    break
        return frozenset(out)

    def accept_start_set(self) -> frozenset:
        return frozenset(s for s in range(self.n_states) if self.accept[s])

    def accepts_forward(self, cats: List[int]) -> bool:
        """Does the grammar accept this forward-order category sequence?
        (reference gramtools/accept_check equivalent)"""
        g = self.accept_start_set()
        for c in cats:
            g = self.reverse_nfa_step(g, c)
            if not g:
                return False
        return any(self.initial[s] for s in g)


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


def load_dfa(path: str) -> DFAGrammar:
    with _open_maybe_gz(path) as f:
        return parse_dfa(f)


def parse_dfa(f) -> DFAGrammar:
    dfa = DFAGrammar()
    max_state = -1
    max_term = -1
    arcs: Dict[int, List[Tuple[int, int]]] = {}
    accept: Set[int] = set()
    initial: Set[int] = set()
    for line in f:
        s = line.strip()
        if not s:
            continue
        if s == "DFAEND":
            break
        parts = s.split()
        if len(parts) < 4:
            raise ValueError(f"bad dfa line: {line!r}")
        state = int(parts[0])
        term = int(parts[1])
        nxt = int(parts[2])
        status = int(parts[3], 16)
        max_state = max(max_state, state, nxt)
        if status & ACCEPT_S:
            accept.add(state)
        if status & INITIAL_S:
            initial.add(state)
        if term >= 0 and nxt >= 0:
            arcs.setdefault(state, []).append((term, nxt))
            max_term = max(max_term, term)
    dfa.n_states = max_state + 1
    dfa.n_terms = max_term + 1
    dfa.arcs = [arcs.get(s, []) for s in range(dfa.n_states)]
    dfa.accept = [s in accept for s in range(dfa.n_states)]
    if not initial:
        initial = {0}   # state 0 is initial by convention (rddfa.c)
    dfa.initial = [s in initial for s in range(dfa.n_states)]
    dfa.term_words = [[] for _ in range(dfa.n_terms)]
    return dfa


def load_grammar(prefix: str):
    """Load a Julius grammar pair ``prefix.dfa`` + ``prefix.dict``
    (reference multigram_load gramlist.c).  Returns (dfa, voca,
    word_cat) where word names in the dict are category-id strings
    (mkdfa.py vocafile2dictfile writes ``catid [word] phones...``)."""
    from julius_tpu_torch.io.htk_dict import load_htkdict

    dfa = load_dfa(prefix + ".dfa")
    voca = load_htkdict(prefix + ".dict")
    word_cat = np.asarray([int(n) for n in voca.names], dtype=np.int32)
    attach_terminfo(dfa, [int(c) for c in word_cat])
    return dfa, voca, word_cat


def attach_terminfo(dfa: DFAGrammar, categories: List[int]) -> None:
    """Fill category -> word-id lists from per-word category assignments
    (the .dict for a grammar uses the category id as the word name column;
    reference mkterminfo.c make_terminfo)."""
    dfa.term_words = [[] for _ in range(dfa.n_terms)]
    for wid, cat in enumerate(categories):
        if 0 <= cat < dfa.n_terms:
            dfa.term_words[cat].append(wid)
