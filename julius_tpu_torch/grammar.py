"""Grammar compiler: .grammar + .voca -> .dfa / .dfa.forward / .dict.

Copy of `julius_tpu/grammar.py` (plain Python).  Reference:
`gramtools/mkdfa/mkdfa.py` driving the flex-based `mkfa` compiler
(gramtools/mkfa-1.44-flex).  Grammar format:

  .grammar:  LHS : SYM SYM ...     (# comments; start symbol "S")
  .voca:     % CATEGORY            (terminal categories, id = order)
             word  phone phone ...

The ``.dfa`` accepts REVERSED sentences (mkdfa.py gen_reverse_grammar)
and ``.dfa.forward`` the original order — both written here, matching
the 4.6 toolchain (Release.txt:8-10).

Compilation: CFG -> NFA by per-call-site inlining; self/mutually
recursive nonterminals are supported in tail position only (the same
regular-language restriction as mkfa — a center-recursive grammar is
not a finite automaton), then subset construction and Hopcroft-style
minimisation.
"""

from __future__ import annotations

import io
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from julius_tpu_torch.io.dfa import DFAGrammar
from julius_tpu_torch.io.htk_dict import Vocabulary


class GrammarError(ValueError):
    pass


@dataclass
class CFG:
    rules: Dict[str, List[List[str]]] = field(default_factory=dict)
    terminals: List[str] = field(default_factory=list)
    start: str = "S"

    @property
    def term_ids(self) -> Dict[str, int]:
        return {t: i for i, t in enumerate(self.terminals)}


def parse_grammar(text: str, terminals: Sequence[str],
                  start: str = "S") -> CFG:
    cfg = CFG(terminals=list(terminals), start=start)
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        left, right = line.split(":", 1)
        lhs = left.strip()
        rhs = right.split()
        cfg.rules.setdefault(lhs, []).append(rhs)
    if start not in cfg.rules:
        raise GrammarError(f"no rule for start symbol '{start}'")
    return cfg


def parse_voca(text: str) -> Tuple[List[str], Vocabulary, List[int]]:
    """.voca -> (categories, vocabulary, per-word category ids).
    Word names in the vocabulary are category-id strings like the
    mkdfa-generated .dict (vocafile2dictfile)."""
    cats: List[str] = []
    voca = Vocabulary()
    word_cat: List[int] = []
    cur = -1
    for line in text.splitlines():
        line = re.sub("#.*$", "", line).strip()
        if not line:
            continue
        if line.startswith("%"):
            cats.append(line[1:].strip())
            cur = len(cats) - 1
        else:
            if cur < 0:
                raise GrammarError("word before any % category in .voca")
            toks = line.split()
            voca.add(str(cur), toks[1:], toks[0])
            word_cat.append(cur)
    return cats, voca, word_cat


# ---------------------------------------------------------------------------
# NFA construction
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: List[Set[int]] = []
        self.arcs: List[List[Tuple[int, int]]] = []   # (term, next)

    def new_state(self) -> int:
        self.eps.append(set())
        self.arcs.append([])
        return len(self.eps) - 1


def _find_recursive(cfg: CFG) -> Set[str]:
    """Nonterminals on a recursion cycle."""
    recursive: Set[str] = set()
    for nt in cfg.rules:
        seen: Set[str] = set()
        stack = [nt]
        while stack:
            cur = stack.pop()
            for rhs in cfg.rules.get(cur, []):
                for sym in rhs:
                    if sym in cfg.rules:
                        if sym == nt:
                            recursive.add(nt)
                        elif sym not in seen:
                            seen.add(sym)
                            stack.append(sym)
    return recursive


def cfg_to_nfa(cfg: CFG) -> Tuple[_NFA, int, int]:
    """Returns (nfa, start_state, accept_state)."""
    nfa = _NFA()
    tids = cfg.term_ids
    recursive = _find_recursive(cfg)

    def build(nt: str, entry: int, exit_: int, trail: Tuple[str, ...]):
        """Inline nonterminal nt between entry/exit states."""
        if nt in trail and nt not in recursive:
            raise GrammarError(f"unexpected recursion through {nt}")
        if len(trail) > 100:
            raise GrammarError(
                "grammar nesting too deep (left/center recursion is not "
                "expressible as a finite automaton; mkfa has the same "
                "restriction)")
        for rhs in cfg.rules.get(nt, []):
            cur = entry
            start_k = 0
            if rhs and rhs[0] == nt:
                if len(rhs) == 1:
                    continue        # A : A is vacuous
                # left recursion A : A alpha (a reversed right-linear
                # list): after a complete A, alpha may repeat from exit
                cur = exit_
                start_k = 1
            for k, sym in enumerate(rhs[start_k:], start=start_k):
                last = k == len(rhs) - 1
                if sym in tids and sym not in cfg.rules:
                    nxt = exit_ if last else nfa.new_state()
                    nfa.arcs[cur].append((tids[sym], nxt))
                    cur = nxt
                elif sym in cfg.rules:
                    if sym == nt and last:
                        # tail recursion: loop back to our own entry
                        nfa.eps[cur].add(entry)
                        cur = None
                        break
                    if sym in trail:
                        raise GrammarError(
                            f"non-tail recursion through '{sym}' is not "
                            "regular (mkfa restriction)")
                    nxt = exit_ if last else nfa.new_state()
                    build(sym, cur, nxt, trail + (nt,))
                    cur = nxt
                else:
                    raise GrammarError(
                        f"symbol '{sym}' is neither a category in .voca "
                        f"nor a rule LHS")
            if cur is not None and not rhs:
                nfa.eps[cur].add(exit_)

    start = nfa.new_state()
    accept = nfa.new_state()
    build(cfg.start, start, accept, ())
    return nfa, start, accept


# ---------------------------------------------------------------------------
# subset construction + minimisation
# ---------------------------------------------------------------------------

def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def nfa_to_dfa(nfa: _NFA, start: int, accept: int) -> DFAGrammar:
    init = _eps_closure(nfa, frozenset([start]))
    states: Dict[FrozenSet[int], int] = {init: 0}
    arcs: List[List[Tuple[int, int]]] = [[]]
    acc: List[bool] = [accept in init]
    work = [init]
    while work:
        cur = work.pop()
        cid = states[cur]
        by_term: Dict[int, Set[int]] = {}
        for s in cur:
            for (t, nxt) in nfa.arcs[s]:
                by_term.setdefault(t, set()).add(nxt)
        for t, nxts in sorted(by_term.items()):
            tgt = _eps_closure(nfa, frozenset(nxts))
            if tgt not in states:
                states[tgt] = len(arcs)
                arcs.append([])
                acc.append(accept in tgt)
                work.append(tgt)
            arcs[cid].append((t, states[tgt]))

    return _minimize(arcs, acc)


def _minimize(arcs: List[List[Tuple[int, int]]],
              acc: List[bool]) -> DFAGrammar:
    """Partition-refinement (Hopcroft-style) minimisation of a
    deterministic automaton whose initial state is 0 (reference
    gramtools/dfa_minimize).  Returns a DFAGrammar with state 0
    initial."""
    n = len(arcs)
    part = [0 if a else 1 for a in acc]
    while True:
        sig = {}
        newpart = [0] * n
        next_id = 0
        for s in range(n):
            key = (part[s], tuple(sorted((t, part[to]) for t, to in arcs[s])))
            if key not in sig:
                sig[key] = next_id
                next_id += 1
            newpart[s] = sig[key]
        if newpart == part:
            break
        part = newpart
    n_min = max(part) + 1
    # remap with the initial state as 0
    order = {}
    order[part[0]] = 0
    for s in range(n):
        if part[s] not in order:
            order[part[s]] = len(order)
    dfa = DFAGrammar()
    dfa.n_states = n_min
    dfa.arcs = [[] for _ in range(n_min)]
    dfa.accept = [False] * n_min
    dfa.initial = [False] * n_min
    dfa.initial[0] = True
    seen_arc = [set() for _ in range(n_min)]
    max_term = -1
    for s in range(n):
        ms = order[part[s]]
        if acc[s]:
            dfa.accept[ms] = True
        for (t, to) in arcs[s]:
            key = (t, order[part[to]])
            if key not in seen_arc[ms]:
                seen_arc[ms].add(key)
                dfa.arcs[ms].append(key)
            max_term = max(max_term, t)
    dfa.n_terms = max_term + 1
    dfa.term_words = [[] for _ in range(dfa.n_terms)]
    return dfa


def determinize_dfa(dfa: DFAGrammar) -> DFAGrammar:
    """Subset construction over a (possibly nondeterministic) category
    automaton loaded from a .dfa file (reference
    gramtools/dfa_determinize).  .dfa files carry no epsilon arcs, so
    this is plain powerset determinisation."""
    init = frozenset(s for s in range(dfa.n_states) if dfa.initial[s])
    if not init:
        init = frozenset({0})
    states: Dict[FrozenSet[int], int] = {init: 0}
    arcs: List[List[Tuple[int, int]]] = [[]]
    acc: List[bool] = [any(dfa.accept[s] for s in init)]
    work = [init]
    while work:
        cur = work.pop()
        cid = states[cur]
        by_term: Dict[int, Set[int]] = {}
        for s in cur:
            for (t, nxt) in dfa.arcs[s]:
                by_term.setdefault(t, set()).add(nxt)
        for t, nxts in sorted(by_term.items()):
            tgt = frozenset(nxts)
            if tgt not in states:
                states[tgt] = len(arcs)
                arcs.append([])
                acc.append(any(dfa.accept[s] for s in tgt))
                work.append(tgt)
            arcs[cid].append((t, states[tgt]))
    out = DFAGrammar()
    out.n_states = len(arcs)
    out.arcs = arcs
    out.accept = acc
    out.initial = [i == 0 for i in range(len(arcs))]
    out.n_terms = dfa.n_terms
    out.term_words = [list(w) for w in dfa.term_words] \
        if dfa.term_words else [[] for _ in range(out.n_terms)]
    return out


def minimize_dfa(dfa: DFAGrammar) -> DFAGrammar:
    """Determinize (if needed) then minimise a loaded automaton
    (reference gramtools/dfa_minimize)."""
    det = determinize_dfa(dfa)
    out = _minimize(det.arcs, det.accept)
    out.n_terms = max(out.n_terms, dfa.n_terms)
    out.term_words = [list(w) for w in dfa.term_words] \
        if dfa.term_words else [[] for _ in range(out.n_terms)]
    return out


def compile_grammar(grammar_text: str, voca_text: str):
    """Full mkdfa pipeline.  Returns (dfa_reversed, dfa_forward, voca,
    word_cat, categories)."""
    cats, voca, word_cat = parse_voca(voca_text)
    cfg_fwd = parse_grammar(grammar_text, cats)
    # reversed grammar: RHS of every rule reversed (gen_reverse_grammar)
    rev = CFG(terminals=list(cats), start=cfg_fwd.start)
    for lhs, rhss in cfg_fwd.rules.items():
        rev.rules[lhs] = [list(reversed(r)) for r in rhss]
    dfa_fwd = nfa_to_dfa(*cfg_to_nfa(cfg_fwd))
    dfa_rev = nfa_to_dfa(*cfg_to_nfa(rev))
    ncat = len(cats)
    for d in (dfa_fwd, dfa_rev):
        d.n_terms = ncat
        d.term_words = [[] for _ in range(ncat)]
        for wid, c in enumerate(word_cat):
            d.term_words[c].append(wid)
    return dfa_rev, dfa_fwd, voca, word_cat, cats


def write_dfa(dfa: DFAGrammar, path_or_f) -> None:
    """mkfa output format: 'state term next status' lines + DFAEND."""
    f = open(path_or_f, "wt") if isinstance(path_or_f, str) else path_or_f
    try:
        for s in range(dfa.n_states):
            status = (1 if dfa.accept[s] else 0) | \
                (2 if dfa.initial[s] else 0)
            if dfa.arcs[s]:
                for (t, to) in dfa.arcs[s]:
                    f.write(f"{s} {t} {to} {status:x}\n")
            else:
                f.write(f"{s} -1 -1 {status:x}\n")
        f.write("DFAEND\n")
    finally:
        if isinstance(path_or_f, str):
            f.close()


def write_dict(voca: Vocabulary, path_or_f) -> None:
    """mkdfa .dict format: 'catid [word] phones...'."""
    f = open(path_or_f, "wt") if isinstance(path_or_f, str) else path_or_f
    try:
        for i in range(voca.n_words):
            phones = " ".join(voca.phones[i])
            f.write(f"{voca.names[i]}\t[{voca.outputs[i]}]\t{phones}\n")
    finally:
        if isinstance(path_or_f, str):
            f.close()


def mkdfa(prefix: str) -> None:
    """Compile prefix.grammar + prefix.voca into prefix.{dfa,
    dfa.forward, dict, term} (the mkdfa.py CLI behaviour)."""
    with open(prefix + ".grammar") as f:
        gtext = f.read()
    with open(prefix + ".voca") as f:
        vtext = f.read()
    dfa_rev, dfa_fwd, voca, word_cat, cats = compile_grammar(gtext, vtext)
    write_dfa(dfa_rev, prefix + ".dfa")
    write_dfa(dfa_fwd, prefix + ".dfa.forward")
    write_dict(voca, prefix + ".dict")
    with open(prefix + ".term", "wt") as f:
        for i, c in enumerate(cats):
            f.write(f"{i}\t{c}\n")


# ---------------------------------------------------------------------------
# grammar QA tools (reference gramtools/accept_check, generate, nextword)
# ---------------------------------------------------------------------------

def accept_check(dfa_fwd: DFAGrammar, cats: Sequence[int]) -> bool:
    """Run a FORWARD-order category sequence through a forward DFA."""
    states = {s for s in range(dfa_fwd.n_states) if dfa_fwd.initial[s]}
    for c in cats:
        nxt = set()
        for s in states:
            for (t, to) in dfa_fwd.arcs[s]:
                if t == c:
                    nxt.add(to)
        if not nxt:
            return False
        states = nxt
    return any(dfa_fwd.accept[s] for s in states)


def generate_sentences(dfa_fwd: DFAGrammar, n: int = 10, seed: int = 0,
                       max_len: int = 50) -> List[List[int]]:
    """Sample random category sequences accepted by the grammar
    (reference gramtools/generate)."""
    import random
    rng = random.Random(seed)
    out = []
    for _ in range(n * 4):
        if len(out) >= n:
            break
        s = next(i for i in range(dfa_fwd.n_states) if dfa_fwd.initial[i])
        sent: List[int] = []
        for _ in range(max_len):
            if dfa_fwd.accept[s] and (not dfa_fwd.arcs[s]
                                      or rng.random() < 0.3):
                out.append(sent)
                break
            if not dfa_fwd.arcs[s]:
                break
            t, to = rng.choice(dfa_fwd.arcs[s])
            sent.append(t)
            s = to
    return out[:n]


def next_categories(dfa_fwd: DFAGrammar,
                    prefix: Sequence[int]) -> List[int]:
    """Possible next categories after a forward prefix (reference
    gramtools/nextword)."""
    states = {s for s in range(dfa_fwd.n_states) if dfa_fwd.initial[s]}
    for c in prefix:
        states = {to for s in states for (t, to) in dfa_fwd.arcs[s]
                  if t == c}
        if not states:
            return []
    return sorted({t for s in states for (t, _to) in dfa_fwd.arcs[s]})
