"""ARPA word N-gram reader (arbitrary order).

Reference: libsent/src/ngram/ngram_read_arpa.c:540 and ngram2.h.  Probabilities
are kept as base-10 logs exactly as stored in the ARPA file (the reference
does the same; LM weights are tuned against log10).

The reference pairs a *forward 2-gram* with a *backward N-gram* for its
two-pass search (`ngram2.h:169` BOS/EOS swap).  Here a single forward N-gram
is sufficient for both passes: pass 1 uses P(w|v) directly, and pass 2's
backward stack search re-derives prefix-conditional scores from the forward
model (see search/pass2.py), which is exactly equivalent to the reference's
`ngram_forw2back` (ngram_decode.c:139) generalised to any order.
Backward ARPA files are still accepted via ``direction='RL'``.
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from julius_tpu_torch.utils.logadd import LOG_ZERO

UNK_SYMBOLS = ("<unk>", "<UNK>")


@dataclass
class NGramLM:
    """Host-side N-gram with backoff (NGRAM_INFO equivalent)."""

    order: int
    words: List[str]
    word_index: Dict[str, int]
    # ngrams[k] maps a k+1-length tuple of word ids -> (log10 prob, log10 bow)
    ngrams: List[Dict[Tuple[int, ...], Tuple[float, float]]]
    direction: str = "LR"      # LR = forward, RL = backward
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    # open-vocabulary unknown word mass (reference init_ngram.c:201)
    unk_num: int = 0

    @property
    def n_words(self) -> int:
        return len(self.words)

    def wid(self, name: str) -> int:
        i = self.word_index.get(name, self.unk_id)
        return i

    def logprob(self, context: Tuple[int, ...], w: int) -> float:
        """log10 P(w | context) with standard Katz backoff walk
        (reference ngram_access.c ngram_prob)."""
        if w < 0:
            return LOG_ZERO
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        acc = 0.0
        while True:
            ent = self.ngrams[len(ctx)].get(ctx + (w,))
            if ent is not None:
                return acc + ent[0]
            if not ctx:
                # word absent even from unigrams -> unknown mass
                return acc + self._unk_prob()
            bo = self.ngrams[len(ctx) - 1].get(ctx)
            acc += bo[1] if bo is not None else 0.0
            ctx = ctx[1:]

    def _unk_prob(self) -> float:
        if self.unk_id >= 0:
            ent = self.ngrams[0].get((self.unk_id,))
            if ent is not None:
                # distribute unknown mass over unseen words
                # (reference set_unknown_id / fix_uniprob_srilm)
                return ent[0] - math.log10(max(1, self.unk_num))
        return LOG_ZERO

    def sentence_logprob(self, word_ids: List[int]) -> float:
        """Sum of conditional log10 probs over a full sentence
        (ids excluding BOS/EOS; they are added here)."""
        seq = [self.bos_id] + list(word_ids) + [self.eos_id]
        total = 0.0
        for i in range(1, len(seq)):
            total += self.logprob(tuple(seq[max(0, i - self.order + 1): i]), seq[i])
        return total

    # -- dense/flat exports for device use ---------------------------------

    def unigram_array(self) -> np.ndarray:
        out = np.full(self.n_words, LOG_ZERO, dtype=np.float32)
        for (w,), (p, _) in self.ngrams[0].items():
            out[w] = p
        return out

    def bigram_arrays(self):
        """(keys, probs, bo_weights) for device hash lookup; keys are
        v * n_words + w (sorted)."""
        V = self.n_words
        items = sorted(self.ngrams[1].items()) if self.order >= 2 else []
        keys = np.asarray([c[0] * V + c[1] for c, _ in items], dtype=np.int64)
        probs = np.asarray([p for _, (p, _) in items], dtype=np.float32)
        bo = np.zeros(V, dtype=np.float32)
        for (w,), (_, b) in self.ngrams[0].items():
            bo[w] = b
        return keys, probs, bo


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


def load_arpa(path: str, direction: str = "LR") -> NGramLM:
    with _open_maybe_gz(path) as f:
        return parse_arpa(f, direction=direction)


def parse_arpa(f, direction: str = "LR") -> NGramLM:
    counts: List[int] = []
    # scan to \data\
    for line in f:
        if line.strip() == "\\data\\":
            break
    for line in f:
        line = line.strip()
        if not line:
            continue
        if line.startswith("ngram "):
            counts.append(int(line.split("=")[1]))
        else:
            break
    if not counts:
        raise ValueError("not an ARPA file: no \\data\\ section")
    order = len(counts)

    words: List[str] = []
    word_index: Dict[str, int] = {}
    ngrams: List[Dict[Tuple[int, ...], Tuple[float, float]]] = [
        {} for _ in range(order)
    ]

    def intern(name: str) -> int:
        i = word_index.get(name)
        if i is None:
            i = len(words)
            words.append(name)
            word_index[name] = i
        return i

    cur = 0  # current section order-1, set when hitting \N-grams:
    # `line` currently holds the first section header
    def handle_header(s: str) -> Optional[int]:
        s = s.strip()
        if s.endswith("-grams:") and s.startswith("\\"):
            return int(s[1:].split("-")[0]) - 1
        return None

    sec = handle_header(line)
    if sec is not None:
        cur = sec
    for line in f:
        s = line.strip()
        if not s:
            continue
        if s == "\\end\\":
            break
        h = handle_header(s)
        if h is not None:
            cur = h
            continue
        parts = s.split("\t") if "\t" in s else s.split()
        if "\t" in s:
            # fields themselves may have spaces only in the word tuple
            flat = []
            for p in parts:
                flat.extend(p.split())
            parts = flat
        prob = float(parts[0])
        wtup = tuple(intern(w) for w in parts[1: 2 + cur])
        bow = 0.0
        if len(parts) > 2 + cur:
            bow = float(parts[2 + cur])
        ngrams[cur][wtup] = (prob, bow)

    lm = NGramLM(
        order=order,
        words=words,
        word_index=word_index,
        ngrams=ngrams,
        direction=direction,
    )
    lm.bos_id = word_index.get("<s>", -1)
    lm.eos_id = word_index.get("</s>", -1)
    for sym in UNK_SYMBOLS:
        if sym in word_index:
            lm.unk_id = word_index[sym]
            break
    if direction == "RL":
        # the reference swaps BOS/EOS for backward models (ngram2.h:169)
        lm.bos_id, lm.eos_id = lm.eos_id, lm.bos_id
    return lm


def write_arpa(lm: NGramLM, path: str) -> None:
    """ARPA dump (binlm2arpa equivalent, reference binlm2arpa/)."""
    with open(path, "wt", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for k in range(lm.order):
            f.write(f"ngram {k + 1}={len(lm.ngrams[k])}\n")
        for k in range(lm.order):
            f.write(f"\n\\{k + 1}-grams:\n")
            for tup in sorted(lm.ngrams[k]):
                p, b = lm.ngrams[k][tup]
                ws = " ".join(lm.words[w] for w in tup)
                if k < lm.order - 1 and b != 0.0:
                    f.write(f"{p:.6f}\t{ws}\t{b:.6f}\n")
                else:
                    f.write(f"{p:.6f}\t{ws}\n")
        f.write("\n\\end\\\n")


def forward_view(lm: NGramLM,
                 forward: Optional["NGramLM"] = None) -> "NGramLM":
    """A forward 2-gram view for pass-1 from an RL model pair.

    The reference pairs a forward 2-gram with the backward N-gram
    (mkbingram -nlr/-nrl; ngram2.h bo_wt_1/p_2).  Given the explicit
    forward model, returns it; given an RL model read from a bingram
    pair (with .forward_bigram / .forward_bo_uni attached by
    io.bingram), synthesizes a forward 2-gram over the same word ids."""
    if lm.direction == "LR":
        return lm
    if forward is not None:
        return forward
    fwd_bi = getattr(lm, "forward_bigram", None)
    if fwd_bi is None:
        raise ValueError(
            "backward N-gram needs a forward 2-gram for pass 1 "
            "(give -nlr, or use a bingram containing the pair)")
    uni = dict(lm.ngrams[0])
    bo1 = getattr(lm, "forward_bo_uni", None)
    if bo1 is not None:
        uni = {t: (p, float(bo1[t[0]]) if t[0] < len(bo1) else 0.0)
               for t, (p, _b) in uni.items()}
    return NGramLM(
        order=2,
        words=lm.words,
        word_index=lm.word_index,
        ngrams=[uni, {t: (p, 0.0) for t, p in fwd_bi.items()}],
        direction="LR",
        bos_id=lm.bos_id, eos_id=lm.eos_id, unk_id=lm.unk_id,
        unk_num=lm.unk_num,
    )
