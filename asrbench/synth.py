"""The benchmark's model inputs and traffic, made from a seed.

Frozen copies of `julius_tpu_torch/tools/synth.py`'s builders
(`make_hmmset`, `make_vocabulary`, `make_ngram`, `make_triphone_hmmset`,
`bind_triphones`, `trained_dnn_weights`, `_lm_sampler`, `_word_frames`,
`make_flagship_utts`, `make_lvcsr_utts`), kept here so that a change to
the program cannot move the yardstick.  They make plain data (numpy
arrays, lists and dicts in a `Model`), which both the program
(`asrbench/program.py` turns it into the port's types) and the plain
reference (`asrbench/reference/`) read.  Two departures from the
originals: a state's frame count is drawn in bulk for a whole utterance
(the same geometric distribution the originals draw frame by frame),
and the utterances' word counts are a fixed multiset that the seed only
orders, so every seed gives a cell the same amount of work.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

LOG_ZERO = -1.0e10


# -- phone names (copies of julius_tpu_torch/models/hmm.py's) ------------

def center_name(name: str) -> str:
    """'a-b+c' -> 'b'."""
    i = name.find("-")
    if i >= 0:
        name = name[i + 1:]
    j = name.find("+")
    return name[:j] if j >= 0 else name


def compose_triphone(left: Optional[str], base: str,
                     right: Optional[str]) -> str:
    s = base
    if left:
        s = f"{left}-{s}"
    if right:
        s = f"{s}+{right}"
    return s


def word_phone_names(phones: List[str], use_triphone: bool) -> List[str]:
    """Dictionary phones -> network phone names: the head phone free of
    its left context, the tail free of its right context."""
    if not use_triphone or len(phones) == 1:
        return list(phones)
    n = len(phones)
    return [compose_triphone(phones[i - 1] if i > 0 else None, p,
                             phones[i + 1] if i < n - 1 else None)
            for i, p in enumerate(phones)]


@dataclass
class Model:
    """One configuration's model inputs, as plain data."""

    # acoustic model
    means: np.ndarray              # [S, D] (the GMM view the port's
    ivars: np.ndarray              # HMMSet carries; a DNN model never
    gconst: np.ndarray             # scores with it)
    phone_states: np.ndarray       # [P, ns] senone ids
    phone_ns: np.ndarray           # [P]
    phone_trans: np.ndarray        # [P, ns + 2, ns + 2] ln p
    phone_names: List[str]
    logical_map: Dict[str, int]    # HMMList: logical name -> physical id
    triphone: bool
    # dictionary
    names: List[str]
    phones: List[List[str]]
    # 2-gram: unigram (log10 p, log10 back-off) per word, bigram log10 p
    uni: Dict[int, Tuple[float, float]]
    bi: Dict[Tuple[int, int], float]
    # DNN: hidden layers [in, out], output layer, log10 prior
    weights: List[np.ndarray]
    biases: List[np.ndarray]
    out_w: np.ndarray
    out_b: np.ndarray
    log_prior: np.ndarray
    context: int
    feat_dim: int
    protos: np.ndarray             # [S, D] senone prototypes (traffic)
    search: dict = field(default_factory=dict)

    @property
    def n_states(self) -> int:
        return int(self.out_w.shape[1])

    @property
    def phone_index(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.phone_names)}


def _trans(n_states: int) -> np.ndarray:
    N = n_states + 2
    trans = np.full((N, N), LOG_ZERO, dtype=np.float32)
    trans[0, 1] = 0.0
    for s in range(1, N - 1):
        trans[s, s] = math.log(0.6)
        trans[s, s + 1] = math.log(0.4)
    return trans


def _gauss(rng, S, dim):
    means = rng.standard_normal((S, dim)).astype(np.float32)
    ivars = (1.0 / (0.5 + rng.random((S, dim)))).astype(np.float32)
    gconst = (dim * math.log(2 * math.pi)
              - np.sum(np.log(ivars), axis=1)).astype(np.float32)
    return means, ivars, gconst


def make_hmmset(n_phones: int, dim: int, seed: int, n_states: int = 3,
                n_senones: Optional[int] = None):
    """Monophones: n_phones x n_states senones, strict L2R.  With
    `n_senones` below n_phones x n_states the last states (the silence
    phone's) tie to the last senone."""
    rng = np.random.default_rng(seed)
    S = n_senones or n_phones * n_states
    if not n_phones * n_states - n_states < S <= n_phones * n_states:
        raise ValueError(f"{n_phones} phones of {n_states} states cannot "
                         f"hold {S} senones")
    means, ivars, gconst = _gauss(rng, S, dim)
    names = [f"p{i:03d}" for i in range(n_phones - 1)] + ["sil"]
    states = np.minimum(np.arange(n_phones * n_states), S - 1)
    return dict(means=means, ivars=ivars, gconst=gconst,
                phone_states=states.astype(np.int32).reshape(
                    n_phones, n_states),
                phone_ns=np.full(n_phones, n_states, dtype=np.int32),
                phone_trans=np.tile(_trans(n_states)[None], (n_phones, 1, 1)),
                phone_names=names, logical_map={}, triphone=False)


def make_triphone_hmmset(n_base: int, variants: int, dim: int,
                         tied_pool: int, seed: int, n_states: int = 3):
    """Tied-state triphones: n_base monophones and n_base * variants
    physical triphones whose states tie into clusters of a senone pool
    of about `tied_pool` states."""
    rng = np.random.default_rng(seed)
    n_phys = n_base * (variants + 1)
    n_pos = n_base * n_states
    C = max(1, tied_pool // n_pos)
    S = n_pos * C
    protos_cl = rng.standard_normal((n_pos, dim)).astype(np.float32)
    means = (np.repeat(protos_cl, C, axis=0)
             + 0.35 * rng.standard_normal((S, dim))).astype(np.float32)
    ivars = (1.0 / (0.5 + rng.random((S, dim)))).astype(np.float32)
    gconst = (dim * math.log(2 * math.pi)
              - np.sum(np.log(ivars), axis=1)).astype(np.float32)
    phone_states = np.zeros((n_phys, n_states), dtype=np.int32)
    for b in range(n_base):
        for s in range(n_states):
            phone_states[b, s] = (b * n_states + s) * C
    for b in range(n_base):
        for v in range(variants):
            for s in range(n_states):
                m = zlib.crc32(f"{b}/{v}/{s}".encode()) % C
                phone_states[n_base + b * variants + v, s] = \
                    (b * n_states + s) * C + m
    base_names = [f"q{i:02d}" for i in range(n_base - 1)] + ["sil"]
    names = list(base_names) + [f"{base_names[b]}#t{v:02d}"
                                for b in range(n_base)
                                for v in range(variants)]
    return dict(means=means, ivars=ivars, gconst=gconst,
                phone_states=phone_states,
                phone_ns=np.full(n_phys, n_states, dtype=np.int32),
                phone_trans=np.tile(_trans(n_states)[None], (n_phys, 1, 1)),
                phone_names=names, logical_map={}, triphone=True)


def make_vocabulary(phone_names: List[str], n_words: int, seed: int,
                    min_phones: int = 3, max_phones: int = 7):
    """<s> and </s> on the silence phone, then random words of 3-7
    phones.  Returns (names, phones)."""
    rng = np.random.default_rng(seed)
    usable = [n for n in phone_names if n != "sil" and "#" not in n
              and "-" not in n and "+" not in n]
    names, phones = ["<s>", "</s>"], [["sil"], ["sil"]]
    for i in range(n_words - 2):
        k = int(rng.integers(min_phones, max_phones + 1))
        phones.append([usable[int(j)]
                       for j in rng.integers(0, len(usable), size=k)])
        names.append(f"w{i:05d}")
    return names, phones


def make_ngram(n_words: int, seed: int, n_bigrams_per_word: int = 12):
    """A 2-gram: every word a unigram (back-off -0.4) and 12 random
    successors."""
    rng = np.random.default_rng(seed)
    uni = {i: (float(-1.0 - 3.0 * rng.random()), -0.4)
           for i in range(n_words)}
    bi = {}
    for v in range(n_words):
        for w in rng.integers(0, n_words, size=n_bigrams_per_word):
            bi[(v, int(w))] = float(-0.5 - 2.0 * rng.random())
    return uni, bi


def bind_triphones(hmm: dict, phones: List[List[str]], n_base: int,
                   variants: int) -> None:
    """Fill the HMMList with every triphone the vocabulary can compose,
    in-word and across words, each tied to a physical variant of its
    centre phone by a hash of its name."""
    index = {n: i for i, n in enumerate(hmm["phone_names"])}
    lmap = hmm["logical_map"]
    bases = hmm["phone_names"][:n_base]
    base_set = set(bases)

    def tie(name: str) -> None:
        if name in lmap or name in index:
            return
        c = center_name(name)
        if c not in base_set:
            return
        v = zlib.crc32(name.encode()) % variants
        lmap[name] = index[f"{c}#t{v:02d}"]

    heads, tails, singles = set(), set(), set()
    for ph in phones:
        for name in word_phone_names(ph, True):
            if "-" in name and "+" in name:
                tie(name)
            elif "+" in name:
                heads.add(name)
            elif "-" in name:
                tails.add(name)
            else:
                singles.add(name)
    for h in sorted(heads):
        for lc in bases:
            tie(f"{lc}-{h}")
    for t in sorted(tails):
        for rc in bases:
            tie(f"{t}+{rc}")
    for s in sorted(singles):
        for lc in bases:
            for rc in bases:
                tie(f"{lc}-{s}+{rc}")


def trained_dnn_weights(n_out, din, dim, context, hidden, n_layers, seed,
                        cluster=None):
    """A constructed matched-filter DNN of the published shapes: layer 1
    embeds the centre frame into the first `dim` hidden units, the other
    hidden layers carry it through scaled-identity sigmoids, and the
    output layer correlates it with each senone prototype, so frames
    made from the prototypes decode back.  Returns (weights, biases,
    out_w, out_b, protos)."""
    rng = np.random.default_rng(seed + 3)
    if hidden < dim:
        raise ValueError(f"hidden {hidden} < feature dim {dim}")

    def mat(a, b):
        return (rng.standard_normal((a, b)) / math.sqrt(a)).astype(np.float32)

    if cluster:
        proto_cl = rng.standard_normal(
            (-(-n_out // cluster), dim)).astype(np.float32)
        protos = (np.repeat(proto_cl, cluster, axis=0)[:n_out]
                  + 0.5 * rng.standard_normal((n_out, dim))
                  ).astype(np.float32)
    else:
        protos = rng.standard_normal((n_out, dim)).astype(np.float32)
    c0 = (context // 2) * dim
    alpha, beta = 0.5, 4.0
    W1 = mat(din, hidden) * 0.05
    W1[:, :dim] = 0.0
    W1[c0:c0 + dim, :dim] = alpha * np.eye(dim, dtype=np.float32)
    weights, biases = [W1], [np.zeros(hidden, np.float32)]
    for _ in range(n_layers - 1):
        Wk = mat(hidden, hidden) * 0.05
        Wk[:, :dim] = 0.0
        Wk[:dim, :dim] = beta * np.eye(dim, dtype=np.float32)
        weights.append(Wk)
        biases.append(np.concatenate(
            [np.full(dim, -0.5 * beta, np.float32),
             np.zeros(hidden - dim, np.float32)]))
    M = 4096
    t2 = rng.integers(0, n_out, size=M)
    x = (protos[t2] + 0.25 * rng.standard_normal((M, dim))).astype(np.float32)
    h = 1.0 / (1.0 + np.exp(-alpha * x))
    for _ in range(n_layers - 1):
        h = 1.0 / (1.0 + np.exp(-beta * (h - 0.5)))
    xm, hm_ = x.mean(axis=0), h.mean(axis=0)
    g = float(np.sum((x - xm) * (h - hm_))
              / max(np.sum((x - xm) ** 2), 1e-6))
    a = hm_ - g * xm
    out_w = np.zeros((hidden, n_out), np.float32)
    out_w[:dim, :] = protos.T
    out_b = (-(protos @ a) - 0.5 * g * np.sum(protos * protos, axis=1)
             ).astype(np.float32)
    logits = h @ out_w[:dim] + out_b
    srt = np.sort(logits, axis=1)
    scale = 8.0 / max(float(np.mean(srt[:, -1] - srt[:, -2])), 1e-3)
    return weights, biases, out_w * scale, out_b * scale, protos


def build_model(cfg: dict, seed: int) -> Model:
    """A configuration file's model from `seed`: `kind` "monophone"
    (the flagship builder) or "tied_triphone" (the 20k-word builder)."""
    dim, ctx = int(cfg["feat_dim"]), int(cfg["context"])
    hidden, layers = int(cfg["hidden_size"]), int(cfg["num_hidden_layers"])
    if int(cfg.get("input_size", dim * ctx)) != dim * ctx:
        raise ValueError("input_size is not feat_dim x context")
    if cfg["kind"] == "monophone":
        hmm = make_hmmset(int(cfg["num_phones"]), dim, seed,
                          n_senones=cfg.get("num_senones"))
        cluster = None
    elif cfg["kind"] == "tied_triphone":
        nb, var = int(cfg["num_base_phones"]), int(cfg["variants"])
        hmm = make_triphone_hmmset(nb, var, dim, int(cfg["tied_pool"]), seed)
        cluster = max(1, int(cfg["tied_pool"]) // (nb * 3))
    else:
        raise ValueError(f"unknown model kind {cfg['kind']!r}")
    names, phones = make_vocabulary(hmm["phone_names"],
                                    int(cfg["vocab_size"]), seed + 1)
    if hmm["triphone"]:
        bind_triphones(hmm, phones, nb, var)
    uni, bi = make_ngram(len(names), seed + 2)
    n_out = int(hmm["phone_states"].max()) + 1
    weights, biases, out_w, out_b, protos = trained_dnn_weights(
        n_out, dim * ctx, dim, ctx, hidden, layers, seed + 3, cluster=cluster)
    return Model(
        **hmm, names=names, phones=phones, uni=uni, bi=bi, weights=weights,
        biases=biases, out_w=out_w, out_b=out_b,
        log_prior=np.full(n_out, math.log10(1.0 / n_out), np.float32),
        context=ctx, feat_dim=dim, protos=protos, search=dict(cfg["search"]))


# -- traffic -------------------------------------------------------------

def _sampler(model: Model, rng, follow_p: float):
    """Next-word draw that follows the 2-gram: with probability
    `follow_p` a bigram successor of the previous word, else any word."""
    skip = {0, 1}
    usable = [i for i in range(len(model.names)) if i not in skip]
    succ: Dict[int, List[int]] = {}
    for (v, w) in model.bi:
        if w not in skip:
            succ.setdefault(v, []).append(w)

    def draw(prev):
        s = succ.get(prev)
        if s and rng.random() < follow_p:
            return int(s[int(rng.integers(0, len(s)))])
        return int(usable[int(rng.integers(0, len(usable)))])
    return draw


def _senone_path(model: Model, seq: List[int], index) -> List[int]:
    """Each state of the word sequence once, in order: monophones as
    they are; triphones resolved with the true neighbouring words'
    phones, as the 20k-word generator resolves them."""
    out = []
    for i, w in enumerate(seq):
        names = word_phone_names(model.phones[w], model.triphone)
        lc = (center_name(model.phones[seq[i - 1]][-1]) if i > 0 else None)
        rc = (center_name(model.phones[seq[i + 1]][0])
              if i + 1 < len(seq) else None)
        for name in names:
            full = name
            if model.triphone:
                if "-" not in name and "+" in name and lc:
                    full = f"{lc}-{name}"
                elif "+" not in name and "-" in name and rc:
                    full = f"{name}+{rc}"
                elif "-" not in name and "+" not in name and lc and rc:
                    full = f"{lc}-{name}+{rc}"
            pid = model.logical_map.get(full, index.get(full))
            if pid is None:
                pid = model.logical_map.get(name, index.get(name))
            if pid is None:
                pid = index[center_name(name)]
            out.extend(int(model.phone_states[pid, s])
                       for s in range(int(model.phone_ns[pid])))
    return out


def make_utterances(model: Model, word_counts: List[int], seed: int,
                    follow_p: float):
    """Generative utterances: for each entry of `word_counts` a sentence
    <s> w1 .. wk </s> drawn by the 2-gram sampler, its states each held
    1 + Geometric frames (leaving with p 0.4 for monophones, 0.6 for
    triphones, as the originals' loops do), frames = senone prototype +
    0.25 noise.  Returns (truths as word ids, [T, D] float32 frames
    before splicing)."""
    rng = np.random.default_rng(seed + 9)
    draw = _sampler(model, rng, follow_p)
    leave = 0.6 if model.triphone else 0.4
    index = model.phone_index
    truths, frames = [], []
    for k in word_counts:
        seq = [0]
        for _ in range(int(k)):
            seq.append(draw(seq[-1]))
        seq.append(1)
        path = np.asarray(_senone_path(model, seq, index), dtype=np.int64)
        senones = np.repeat(path, rng.geometric(leave, size=len(path)))
        base = model.protos[senones]
        base += 0.25 * rng.standard_normal(base.shape, dtype=np.float32)
        truths.append(seq)
        frames.append(base)
    return truths, frames


def splice_into(dst: np.ndarray, base: np.ndarray, context: int) -> None:
    """Write the spliced windows of [T, D] frames into dst [T, D *
    context]: frame t's window holds frames t - context // 2 .. t +
    context - context // 2 - 1, clamped to the utterance's ends."""
    half = context // 2
    T, D = base.shape
    ext = np.concatenate([np.repeat(base[:1], half, axis=0), base,
                          np.repeat(base[-1:], context - half - 1, axis=0)])
    win = np.lib.stride_tricks.sliding_window_view(ext, (context, D))
    dst[:] = win.reshape(T, context * D)
