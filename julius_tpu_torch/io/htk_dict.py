"""Word dictionary reader (Julius/HTK-style .dict and word lists).

Reference: libsent/src/voca/voca_load_htkdict.c:305,374 — line format
``WORDNAME [@classprob] [OutputString] [:weight] phone1 phone2 ...``
where ``[...]`` output marks a normal word and ``{...}`` a transparent word;
and voca_load_wordlist.c:142 for isolated-word mode word lists."""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Vocabulary:
    """WORD_INFO equivalent (reference libsent/include/sent/vocabulary.h)."""

    names: List[str] = field(default_factory=list)       # wname (LM entry key)
    outputs: List[str] = field(default_factory=list)     # woutput
    phones: List[List[str]] = field(default_factory=list)  # base phone seq
    transparent: List[bool] = field(default_factory=list)
    cprob: List[float] = field(default_factory=list)     # class n-gram log10 p
    weight: List[float] = field(default_factory=list)    # MBR word weight

    head_silword: int = -1
    tail_silword: int = -1

    @property
    def n_words(self) -> int:
        return len(self.names)

    def index_by_name(self) -> Dict[str, List[int]]:
        idx: Dict[str, List[int]] = {}
        for i, n in enumerate(self.names):
            idx.setdefault(n, []).append(i)
        return idx

    def add(self, name: str, phones: List[str], output: Optional[str] = None,
            transparent: bool = False, cprob: float = 0.0,
            weight: float = 1.0) -> int:
        self.names.append(name)
        self.outputs.append(output if output is not None else name)
        self.phones.append(list(phones))
        self.transparent.append(transparent)
        self.cprob.append(cprob)
        self.weight.append(weight)
        return len(self.names) - 1


_BRACKET_RE = re.compile(r"^\[(.*)\]$|^\{(.*)\}$")


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


def parse_dict_line(line: str, voca: Vocabulary) -> bool:
    """Parse one dictionary entry line; returns False on DICEND."""
    line = line.rstrip("\n")
    if line.strip() == "DICEND":
        return False
    if not line.strip() or line.lstrip().startswith("#"):
        return True
    toks = line.split()
    i = 0
    name = toks[i]
    i += 1
    cprob = 0.0
    if i < len(toks) and toks[i].startswith("@"):
        cprob = float(toks[i][1:])
        i += 1
        # class-ngram form: classname @prob wordname [out] phones...
        if i < len(toks) and not (toks[i].startswith("[") or toks[i].startswith("{")):
            i += 1  # skip the word name; class name is the LM key
    output = None
    transparent = False
    if i < len(toks) and (toks[i].startswith("[") or toks[i].startswith("{")):
        close = "]" if toks[i].startswith("[") else "}"
        transparent = toks[i].startswith("{")
        # output string may contain spaces: join until closing bracket
        j = i
        while j < len(toks) and not toks[j].endswith(close):
            j += 1
        if j >= len(toks):
            raise ValueError(f"unterminated output string: {line}")
        output = " ".join(toks[i: j + 1])[1:-1]
        i = j + 1
    weight = 1.0
    if i < len(toks) and toks[i].startswith(":") and len(toks[i]) > 1:
        weight = float(toks[i][1:])
        i += 1
    phones = toks[i:]
    if not phones:
        raise ValueError(f"word '{name}' has no phonemes: {line}")
    voca.add(name, phones, output, transparent, cprob, weight)
    return True


def load_htkdict(path: str) -> Vocabulary:
    voca = Vocabulary()
    with _open_maybe_gz(path) as f:
        for line in f:
            if not parse_dict_line(line, voca):
                break
    return voca


def load_wordlist(path: str) -> Vocabulary:
    """Isolated-word recognition word list (reference
    voca_load_wordlist.c:142): ``WORDNAME phone1 phone2 ...``"""
    voca = Vocabulary()
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) < 2:
                raise ValueError(f"bad wordlist line: {line}")
            voca.add(toks[0], toks[1:])
    return voca


def word_internal_triphones(phones: List[str]) -> List[str]:
    """Convert a base phone sequence to word-internal triphone names
    (reference cycle_triphone in voca_load_htkdict.c): the first phone gets
    only a right context, the last only a left context."""
    n = len(phones)
    if n == 1:
        return [phones[0]]
    out = []
    for i, p in enumerate(phones):
        left = phones[i - 1] if i > 0 else None
        right = phones[i + 1] if i < n - 1 else None
        s = p
        if left:
            s = f"{left}-{s}"
        if right:
            s = f"{s}+{right}"
        out.append(s)
    return out
