"""Synthetic model builders at realistic scale.

Copies of `julius_tpu/tools/synth.py`'s builders, so the port builds the
same tables from the same seeds, without shipping model files: the
flagship DNN-HMM LVCSR configuration (ENVR-v5.4-like: 40ch FBANK_D_A
front-end, 11-frame splice, 5x2048 sigmoid hidden layers, ~2k senones —
reference README.md Quick Run model + Sample.dnnconf) and the 20k-word
tied-triphone configuration (`lvcsr_engine`: HMMList-tied triphones,
cross-word pseudo sets, strict inter-word CD in pass 2).  Beside them,
`write_gmm_task` writes a GMM-HMM task of the flagship's shape as the
model, dictionary, N-gram and feature files the command line reads;
`make_grammar` splits a dictation vocabulary into the categories of a
command grammar, `grammar_sentences` samples word sequences the grammar
accepts, `make_word_utts` turns given word sequences into generative
utterances, and `write_grammar_task` writes a grammar and an
isolated-word list beside a `write_gmm_task` task.  `backward_ngram`
turns a 2-gram into the backward (RL) model of a -nlr / -nrl pair.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np

from julius_tpu_torch.config import AMConfig, SearchConfig, parse_feature_type
from julius_tpu_torch.io.arpa import NGramLM
from julius_tpu_torch.io.dnn import DNNParams
from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.utils.logadd import LOG_ZERO


def make_hmmset(n_phones: int = 668, n_states: int = 3, dim: int = 120,
                n_mix: int = 1, seed: int = 0) -> HMMSet:
    """HMMSet with P phones x n_states unique senones, strict L2R."""
    rng = np.random.default_rng(seed)
    S = n_phones * n_states
    G = S * n_mix
    means = rng.standard_normal((G, dim)).astype(np.float32)
    ivars = (1.0 / (0.5 + rng.random((G, dim)))).astype(np.float32)
    gconst = (dim * math.log(2 * math.pi)
              - np.sum(np.log(ivars), axis=1)).astype(np.float32)
    state_mix = np.arange(S, dtype=np.int32).reshape(S, 1) * n_mix \
        + np.arange(n_mix, dtype=np.int32)[None, :]
    state_lw = np.full((S, n_mix), -math.log(n_mix), dtype=np.float32)
    phone_states = np.arange(S, dtype=np.int32).reshape(n_phones, n_states)
    phone_ns = np.full(n_phones, n_states, dtype=np.int32)
    N = n_states + 2
    trans = np.full((N, N), LOG_ZERO, dtype=np.float32)
    trans[0, 1] = 0.0
    for s in range(1, N - 1):
        trans[s, s] = math.log(0.6)
        trans[s, s + 1] = math.log(0.4)
    phone_trans = np.tile(trans[None], (n_phones, 1, 1))
    names = [f"p{i:03d}" for i in range(n_phones - 1)] + ["sil"]
    return HMMSet(
        means=means, ivars=ivars, gconst=gconst,
        state_mix=state_mix, state_lw=state_lw,
        state_sid=np.arange(S, dtype=np.int32),
        phone_states=phone_states, phone_ns=phone_ns,
        phone_trans=phone_trans,
        phone_names=names,
        phone_index={n: i for i, n in enumerate(names)},
        logical_map={},
        veclen=dim,
        names_are_triphone=False,
    )


def make_vocabulary(hmm: HMMSet, n_words: int = 5000,
                    min_phones: int = 3, max_phones: int = 7,
                    seed: int = 1) -> Vocabulary:
    rng = np.random.default_rng(seed)
    usable = [n for n in hmm.phone_names
              if n != "sil" and "#" not in n
              and "-" not in n and "+" not in n]
    voca = Vocabulary()
    # empty output strings like the reference dict convention
    # ("<s> [] sil"): the silence words never appear in transcripts
    voca.add("<s>", ["sil"], output="")
    voca.add("</s>", ["sil"], output="")
    for i in range(n_words - 2):
        k = int(rng.integers(min_phones, max_phones + 1))
        phones = [usable[int(j)] for j in
                  rng.integers(0, len(usable), size=k)]
        voca.add(f"w{i:05d}", phones)
    return voca


def make_ngram(voca: Vocabulary, n_bigrams_per_word: int = 12,
               seed: int = 2) -> NGramLM:
    rng = np.random.default_rng(seed)
    words = list(voca.names)
    V = len(words)
    uni = {}
    for i in range(V):
        uni[(i,)] = (float(-1.0 - 3.0 * rng.random()), -0.4)
    bi = {}
    for v in range(V):
        tgt = rng.integers(0, V, size=n_bigrams_per_word)
        for w in tgt:
            bi[(v, int(w))] = (float(-0.5 - 2.0 * rng.random()), 0.0)
    return NGramLM(
        order=2, words=words,
        word_index={w: i for i, w in enumerate(words)},
        ngrams=[uni, bi],
        bos_id=0, eos_id=1,
    )


def backward_ngram(lm: NGramLM) -> NGramLM:
    """The 2-gram `lm` as a backward (RL) model: the same unigrams, each
    bigram (v, w) turned into (w, v) with its probability (as if trained
    on reversed sentences; adequate for decode-machinery checks), BOS
    and EOS swapped as the reference does for RL models
    (ngram2.h:169)."""
    return dataclasses.replace(
        lm, ngrams=[dict(lm.ngrams[0]),
                    {(b, a): p for (a, b), p in lm.ngrams[1].items()}],
        direction="RL", bos_id=lm.eos_id, eos_id=lm.bos_id)


def make_dnn(dim_in: int = 1320, hidden: int = 2048, n_layers: int = 5,
             n_out: int = 2004, seed: int = 3) -> DNNParams:
    rng = np.random.default_rng(seed)

    def mat(a, b):
        return (rng.standard_normal((a, b)) / math.sqrt(a)).astype(np.float32)

    weights = [mat(dim_in, hidden)] + [
        mat(hidden, hidden) for _ in range(n_layers - 1)]
    biases = [np.zeros(hidden, dtype=np.float32) for _ in range(n_layers)]
    return DNNParams(
        weights=weights,
        biases=biases,
        output_w=mat(hidden, n_out),
        output_b=np.zeros(n_out, dtype=np.float32),
        log_prior=np.full(n_out, math.log10(1.0 / n_out), dtype=np.float32),
        context_len=11,
        feature_len=dim_in // 11,
    )


def make_triphone_hmmset(n_base: int = 40, variants: int = 50,
                         n_states: int = 3, dim: int = 120,
                         tied_pool: int = 2048,
                         seed: int = 0) -> HMMSet:
    """Tied-STATE triphone HMM set at realistic scale: `n_base`
    monophones plus `n_base * variants` physical triphone models whose
    states are tied into a shared senone pool of ~`tied_pool` states —
    the HTK tied-state architecture the reference consumes (shared
    ~o <SID> macros, rdhmmdef.c state macros; ENVR-v5.4 has 2004
    senones for 8k+ logical triphones).  Each (base phone, state
    position) owns a cluster of `tied_pool // (n_base*n_states)`
    senones; variant v of that phone draws its state from the cluster
    by hash, the monophone takes member 0.  Distinct base phones never
    share senones, so the generative decode stays well-posed, while
    same-center variants share states exactly like decision-tree-tied
    real AMs.  The HMMList (logical_map) is filled lazily by
    `bind_triphones` with the composed names a vocabulary actually
    uses, hash-tied to a physical variant of the same center phone
    (the reference's rdhmmlist.c logical->physical tying)."""
    rng = np.random.default_rng(seed)
    n_phys = n_base * (variants + 1)
    n_pos = n_base * n_states
    C = max(1, tied_pool // n_pos)
    S = n_pos * C
    # senones CLUSTER like real decision-tree-tied AMs: members of one
    # (base phone, state position) share a prototype with small
    # offsets, distinct positions are well separated.  Fully random
    # members (round 4) made every cross-word pseudo CD set a max over
    # ~C unrelated Gaussians — per-frame mix-and-match inflation no
    # physical path can achieve, which pass 2 then used to prefer junk
    # many-seam segmentations over the generative truth (measured: 6
    # of 16 20k-word utterances decoded ABOVE the truth's own score)
    protos_cl = rng.standard_normal((n_pos, dim)).astype(np.float32)
    means = (np.repeat(protos_cl, C, axis=0)
             + 0.35 * rng.standard_normal((S, dim))).astype(np.float32)
    ivars = (1.0 / (0.5 + rng.random((S, dim)))).astype(np.float32)
    gconst = (dim * math.log(2 * math.pi)
              - np.sum(np.log(ivars), axis=1)).astype(np.float32)
    state_mix = np.arange(S, dtype=np.int32).reshape(S, 1)
    state_lw = np.zeros((S, 1), dtype=np.float32)
    # model layout: [0, n_base) monophones, then variant v of base b at
    # n_base + b*variants + v.  State of (b, pos) for variant v ties to
    # cluster member crc(b,v,pos) % C; monophone to member 0.
    phone_states = np.zeros((n_phys, n_states), dtype=np.int32)
    for b in range(n_base):
        for s in range(n_states):
            phone_states[b, s] = (b * n_states + s) * C
    import zlib as _zlib
    for b in range(n_base):
        for v in range(variants):
            i = n_base + b * variants + v
            for s in range(n_states):
                m = _zlib.crc32(f"{b}/{v}/{s}".encode()) % C
                phone_states[i, s] = (b * n_states + s) * C + m
    phone_ns = np.full(n_phys, n_states, dtype=np.int32)
    N = n_states + 2
    trans = np.full((N, N), LOG_ZERO, dtype=np.float32)
    trans[0, 1] = 0.0
    for s in range(1, N - 1):
        trans[s, s] = math.log(0.6)
        trans[s, s + 1] = math.log(0.4)
    phone_trans = np.tile(trans[None], (n_phys, 1, 1))
    base_names = [f"q{i:02d}" for i in range(n_base - 1)] + ["sil"]
    names = list(base_names)
    for b in range(n_base):
        for v in range(variants):
            names.append(f"{base_names[b]}#t{v:02d}")
    return HMMSet(
        means=means, ivars=ivars, gconst=gconst,
        state_mix=state_mix, state_lw=state_lw,
        state_sid=np.arange(S, dtype=np.int32),
        phone_states=phone_states, phone_ns=phone_ns,
        phone_trans=phone_trans,
        phone_names=names,
        phone_index={n: i for i, n in enumerate(names)},
        logical_map={},
        veclen=dim,
        names_are_triphone=True,
    )


def bind_triphones(hmm: HMMSet, voca: Vocabulary, n_base: int = 40,
                   variants: int = 50) -> int:
    """Fill hmm.logical_map with every triphone the vocabulary can
    compose (the HMMList role, reference rdhmmlist.c): each logical
    'l-c+r' ties to a physical variant of center c by name hash.

    Both IN-WORD triphones and CROSS-WORD compositions (every word-head
    'c+r' and word-tail 'l-c' crossed with every possible adjacent base
    phone) are listed, like the full-triphone HMMLists real tied-state
    AMs ship — so strict inter-word CD (pass-1 head_rc_dynamic,
    pass-2 strict_iwcd2) resolves exact models at word boundaries
    instead of falling back to pseudo sets.  Returns the number of
    logical entries added."""
    import zlib

    from julius_tpu_torch.models.hmm import center_name
    from julius_tpu_torch.search.network import word_phone_names

    base_index = {n: i for i, n in enumerate(hmm.phone_names[:n_base])}
    bases = hmm.phone_names[:n_base]

    def tie(name: str) -> None:
        nonlocal added
        if name in hmm.logical_map or name in hmm.phone_index:
            return
        bi = base_index.get(center_name(name))
        if bi is None:
            return
        v = zlib.crc32(name.encode()) % variants
        hmm.logical_map[name] = hmm.phone_index[f"{bases[bi]}#t{v:02d}"]
        added += 1

    added = 0
    heads, tails, singles = set(), set(), set()
    for phones in voca.phones:
        names = word_phone_names(phones, True)
        for name in names:
            if "-" in name and "+" in name:
                tie(name)
            elif "+" in name:               # word head 'c+r'
                heads.add(name)
            elif "-" in name:               # word tail 'l-c'
                tails.add(name)
            else:                           # single-phone word
                singles.add(name)
    for h in heads:
        for lc in bases:
            tie(f"{lc}-{h}")
    for t in tails:
        for rc in bases:
            tie(f"{t}+{rc}")
    for s in singles:
        for lc in bases:
            for rc in bases:
                tie(f"{lc}-{s}+{rc}")
    return added


def lvcsr_engine(n_words: int = 20000, n_base: int = 40,
                 variants: int = 50, hidden: int = 2048,
                 n_layers: int = 5, seed: int = 0,
                 search: Optional[SearchConfig] = None,
                 device: str = "cuda"):
    """20k-word tied-triphone DNN-HMM configuration (VERDICT r4 #4:
    the reference's 20k-word dictation capability, README.md:24, over
    HMMList-tied triphones with cross-word pseudo sets active).

    Returns (engine, protos): decodable like flagship_engine(trained=
    True) — frames built from senone prototypes decode back."""
    from julius_tpu_torch.engine import Engine

    fe_cfg = parse_feature_type("FBANK_D_A")
    fe_cfg.fbank_num = 40
    feat_dim = 120
    hmm = make_triphone_hmmset(n_base=n_base, variants=variants,
                               dim=feat_dim, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    # vocabulary phones are base names; rebuild with base phones only
    bind_triphones(hmm, voca, n_base=n_base, variants=variants)
    lm = make_ngram(voca, seed=seed + 2)
    if search is None:
        # strict pass-2 inter-word CD (the reference's
        # --enable-setup=standard): with ~50 random same-center
        # variants, the v1 pseudo-set max lets junk segmentations
        # mix-and-match member senones frame-by-frame at every word
        # seam — 3-phone words are 2/3 word-edge — and pass 2 happily
        # confirms them; strict heads re-score each seam with the one
        # exact triphone its left context implies
        search = SearchConfig(lm_weight=8.0, lm_penalty=-2.0,
                              strict_iwcd2=True)
    n_out = hmm.n_states
    # cluster size of the tied senone pool (make_triphone_hmmset)
    tied_c = max(1, 2048 // (n_base * 3))
    weights, biases, out_w, out_b, protos = trained_dnn_weights(
        n_out, feat_dim * 11, feat_dim, 11, hidden, n_layers, seed + 3,
        cluster=tied_c)
    dnn = DNNParams(
        weights=weights, biases=biases, output_w=out_w, output_b=out_b,
        log_prior=np.full(n_out, math.log10(1.0 / n_out), np.float32),
        context_len=11, feature_len=feat_dim)
    # iwcd1 'max' (reference outprob_cd max mode) for the pass-1
    # pseudo sets: with the sharp clustered matched-filter model the
    # max picks the exact member on truth frames, so pass-1 scores
    # stay consistent with the strict pass-2 estimates WITHOUT
    # head_rc_dynamic, which stays off: the fused pass-1 beam update
    # does not carry the context payload into emissions
    eng = Engine(hmm, voca, lm, dnn=dnn, frontend=fe_cfg, search=search,
                 am_cfg=AMConfig(iwcd_scheme="max"), device=device)
    return eng, protos


def trained_dnn_weights(n_out, din, dim, context, hidden, n_layers,
                        seed, cluster=None):
    """Constructed matched-filter DNN: the first layer embeds the
    CENTER frame into the leading `dim` hidden units inside sigmoid's
    near-linear range, the remaining layers carry it through scaled-
    identity sigmoids (strictly monotone per unit), and the output
    layer correlates it against every senone prototype with the
    nearest-prototype bias (logits ~ x . p_j - |p_j|^2/2).  Gives the
    synthetic flagship DNN actual decoding power: frames built from
    per-senone prototypes (+noise) decode to the generating senone
    sequence, so WER is measurable at flagship scale (BASELINE.md) and
    pass-2 search behaves like it does on real speech instead of
    burning its pop budget on noise.

    Same shapes and FLOPs as the real ENVR-v5.4-like net
    (Sample.dnnconf) — only the values are designed.  Earlier rounds
    ridge-regressed a readout through RANDOM sigmoid layers; its
    sibling discrimination lived in near-null-space directions with
    huge weights, which the engine's bfloat16 matmul path (ops/dnn.py,
    matching calc_dnn.c's SIMD design point) quantised away — senone
    top-1 through the engine fell to ~0 while float32 probes scored
    0.98.  The matched-filter margins are O(|p_i - p_j|^2) at every
    stage and survive bf16 by construction.

    `cluster`: group size of consecutive senone ids sharing a
    prototype neighbourhood (make_triphone_hmmset's tied pool); same-
    cluster senones are acoustically close like real decision-tree-
    tied states, so cross-word pseudo CD aggregates stay within a
    small bonus of the exact member.

    Returns (weights, biases, out_w, out_b, protos[n_out, dim])."""
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
    # layer 1: alpha * center frame into units [0, dim); filler noise
    # everywhere else (the filler columns never feed the carried units)
    alpha = 0.5
    W1 = mat(din, hidden) * 0.05
    b1 = np.zeros(hidden, np.float32)
    W1[:, :dim] = 0.0
    W1[c0:c0 + dim, :dim] = alpha * np.eye(dim, dtype=np.float32)
    weights = [W1]
    biases = [b1]
    # layers 2..L: scaled-identity sigmoids centred at 0.5 over the
    # carried units (near-linear for the residual, strictly monotone)
    beta = 4.0
    for _ in range(n_layers - 1):
        Wk = mat(hidden, hidden) * 0.05
        Wk[:, :dim] = 0.0
        Wk[:dim, :dim] = beta * np.eye(dim, dtype=np.float32)
        weights.append(Wk)
        biases.append(np.concatenate(
            [np.full(dim, -0.5 * beta, np.float32),
             np.zeros(hidden - dim, np.float32)]))

    # calibrate the carried units' affine response h ~ a + g*x on probe
    # frames (sigmoid chains are only approximately linear), then read
    # the matched filter off them: logits_j = s*(h . p_j) + ob_j with
    # ob_j cancelling the offset term and adding -g*|p_j|^2/2
    M = 4096
    t2 = rng.integers(0, n_out, size=M)
    x = (protos[t2]
         + 0.25 * rng.standard_normal((M, dim))).astype(np.float32)
    h = 1.0 / (1.0 + np.exp(-alpha * x))
    for _ in range(n_layers - 1):
        h = 1.0 / (1.0 + np.exp(-beta * (h - 0.5)))
    xm = x.mean(axis=0)
    hm_ = h.mean(axis=0)
    g = float(np.sum((x - xm) * (h - hm_)) / max(np.sum((x - xm) ** 2),
                                                 1e-6))
    a = hm_ - g * xm
    out_w = np.zeros((hidden, n_out), np.float32)
    out_w[:dim, :] = protos.T
    out_b = (-(protos @ a) - 0.5 * g * np.sum(protos * protos, axis=1)
             ).astype(np.float32)
    # sharpen: rescale logits so the mean top1-top2 margin is large
    # enough that the log-softmax outprob differences compete with the
    # weighted LM scores (softmax temperature is a free parameter of
    # this synthetic model)
    logits = h @ out_w[:dim] + out_b
    srt = np.sort(logits, axis=1)
    margin = float(np.mean(srt[:, -1] - srt[:, -2]))
    scale = 8.0 / max(margin, 1e-3)
    out_w *= scale
    out_b *= scale
    return weights, biases, out_w, out_b, protos


def _lm_sampler(lm, voca, rng, follow_p=0.85):
    """Word-sequence sampler that FOLLOWS the N-gram: with probability
    `follow_p` the next word is drawn from the previous word's bigram
    successors, else uniformly.  Uniform-random truth sequences pay the
    back-off penalty at every transition, so at LVCSR vocabulary sizes
    the model-optimal decode genuinely differs from the truth (verified
    by forced-alignment scoring) and exact-match accuracy measures LM
    mismatch, not decoder quality.  Real speech follows its LM; so do
    these utterances."""
    name2id = {n: i for i, n in enumerate(voca.names)}
    skip = {name2id["<s>"], name2id["</s>"]}
    usable = [i for i in range(voca.n_words) if i not in skip]
    succ = {}
    if lm is not None and len(lm.ngrams) > 1:
        l2v = {}
        for w, nm in enumerate(voca.names):
            li = lm.word_index.get(nm)
            if li is not None:
                l2v.setdefault(li, w)
        for (v, w) in lm.ngrams[1].keys():
            dv, dw = l2v.get(v), l2v.get(w)
            if dv is None or dw is None or dw in skip:
                continue
            succ.setdefault(dv, []).append(dw)

    def draw(prev):
        s = succ.get(prev)
        if s and rng.random() < follow_p:
            return int(s[int(rng.integers(0, len(s)))])
        return int(usable[int(rng.integers(0, len(usable)))])

    return draw


def _word_frames(hmm, voca, protos, seq, dim, context, rng, counts=None):
    """Spliced [T, dim * context] windows of a word sequence: senone path
    via the HMM transitions, base frames = senone prototypes + noise.
    Each word's frame count is appended to `counts` when it is given."""
    senones = []
    for w in seq:
        first = len(senones)
        for p in voca.phones[w]:
            pid = hmm.phone_index[p]
            ns = int(hmm.phone_ns[pid])
            trans = hmm.phone_trans[pid]
            s = 0
            while s < ns:
                senones.append(int(hmm.phone_states[pid, s]))
                if rng.random() > math.exp(trans[s + 1, s + 1]):
                    s += 1
        if counts is not None:
            counts.append(len(senones) - first)
    base = protos[senones] \
        + 0.25 * rng.standard_normal((len(senones), dim)) \
        .astype(np.float32)
    half = context // 2
    T = base.shape[0]
    idx = np.clip(np.arange(T)[:, None]
                  + np.arange(-half, context - half)[None, :], 0, T - 1)
    return base[idx].reshape(T, dim * context).astype(np.float32)


def make_flagship_utts(hmm, voca, lm, protos, n_utts, dim, context,
                       min_words=4, max_words=9, seed=0, word_counts=False):
    """Generative flagship utterances: word sequence -> senone path via
    the HMM transitions -> base frames = senone prototypes + noise ->
    spliced windows (what the decoders consume).  Truth is known by
    construction.  Returns (truths, windows, lens), and with word_counts
    each utterance's per-word frame counts last (the same draws)."""
    rng = np.random.default_rng(seed + 9)
    name2id = {n: i for i, n in enumerate(voca.names)}
    draw = _lm_sampler(lm, voca, rng)
    truths, windows, lens, counts = [], [], [], []
    for _ in range(n_utts):
        k = int(rng.integers(min_words, max_words + 1))
        seq = [name2id["<s>"]]
        for _i in range(k):
            seq.append(draw(seq[-1]))
        seq.append(name2id["</s>"])
        counts.append([])
        win = _word_frames(hmm, voca, protos, seq, dim, context, rng,
                           counts[-1])
        truths.append([voca.names[w] for w in seq])
        windows.append(win)
        lens.append(win.shape[0])
    if word_counts:
        return truths, windows, lens, counts
    return truths, windows, lens


def make_word_utts(hmm, voca, protos, seqs, dim, context, seed=0):
    """Generative utterances of the given word-id sequences, made as
    `make_flagship_utts` makes its own.  Returns (windows, lens)."""
    rng = np.random.default_rng(seed + 9)
    windows = [_word_frames(hmm, voca, protos, seq, dim, context, rng)
               for seq in seqs]
    return windows, [w.shape[0] for w in windows]


def make_grammar(voca: Vocabulary, n_cats: int = 40, max_route: int = 8):
    """A command grammar over a dictation vocabulary whose silence words
    are <s> and </s> (`make_vocabulary`'s), as the .grammar and .voca
    texts that `grammar.compile_grammar` compiles.

    <s> and </s> form the sentence-edge categories NS_B and NS_E; the
    other words are dealt in id order into n_cats categories C00, C01,
    ...  A sentence is NS_B, one route and NS_E.  The routes take the
    categories in order, 1, 2, ..., max_route of them a route and again,
    so each position of each route is a state of the automaton; the last
    three categories form the route Ca LIST with the tail-recursive LIST
    : Cb | Cc LIST.  Returns (grammar text, voca text)."""
    if n_cats < 4:
        raise ValueError(f"n_cats={n_cats}: the grammar needs at least 4")
    edge = {"<s>": "NS_B", "</s>": "NS_E"}
    cats = {name: [] for name in edge.values()}
    cats.update({f"C{k:02d}": [] for k in range(n_cats)})
    others = [w for w in range(voca.n_words) if voca.names[w] not in edge]
    for w in range(voca.n_words):
        if voca.names[w] in edge:
            cats[edge[voca.names[w]]].append(w)
    for j, w in enumerate(others):
        cats[f"C{j % n_cats:02d}"].append(w)
    rules = ["S : NS_B BODY NS_E"]
    n_route, c, length = n_cats - 3, 0, 1
    while c < n_route:
        k = min(length, n_route - c)
        rules.append("BODY : "
                     + " ".join(f"C{i:02d}" for i in range(c, c + k)))
        c += k
        length = length % max_route + 1
    a, b, d = n_cats - 3, n_cats - 2, n_cats - 1
    rules += [f"BODY : C{a:02d} LIST", f"LIST : C{b:02d}",
              f"LIST : C{d:02d} LIST"]
    voca_lines = []
    for name, words in cats.items():
        voca_lines.append(f"% {name}")
        voca_lines += [f"{voca.names[w]} {' '.join(voca.phones[w])}"
                       for w in words]
    return "\n".join(rules) + "\n", "\n".join(voca_lines) + "\n"


def grammar_sentences(dfa_fwd, word_cat, n: int, seed: int = 0,
                      min_words: int = 3, max_words: int = 10):
    """n word-id sequences of min_words..max_words words that the forward
    automaton accepts: category sequences drawn by
    `grammar.generate_sentences`, each category's word drawn uniformly."""
    from julius_tpu_torch.grammar import generate_sentences

    rng = np.random.default_rng(seed)
    members = {}
    for w, c in enumerate(word_cat):
        members.setdefault(int(c), []).append(w)
    out = []
    draw_seed = seed
    while len(out) < n:
        for cats in generate_sentences(dfa_fwd, n=4 * n, seed=draw_seed):
            if min_words <= len(cats) <= max_words and len(out) < n:
                out.append([members[c][int(rng.integers(len(members[c])))]
                            for c in cats])
        draw_seed += 1
    return out


def make_lvcsr_utts(eng, protos, n_utts, dim, context,
                    min_words=4, max_words=9, seed=0, follow_p=1.0):
    """Generative utterances for a triphone engine: the senone path is
    composed from the sampled word sequence's EXACT triphones —
    in-word logicals plus cross-word heads/tails resolved with the
    true adjacent contexts (see the in-loop comment).  Truth known by
    construction.

    follow_p defaults to 1.0 (every transition is a real bigram): a
    uniform off-LM draw pays ~-35 weighted log points of back-off at
    lvcsr vocabulary sizes, so the model-optimal decode provably
    differs from the truth on most such utterances (measured round 5:
    9 of 14 20k-word 'errors' were the decoder finding a HIGHER-
    scoring sequence than the truth) and exact-match stops measuring
    the decoder.  Real dictation follows its LM; so do these."""
    from julius_tpu_torch.models.hmm import center_name
    from julius_tpu_torch.search.network import word_phone_names

    rng = np.random.default_rng(seed + 9)
    hmm, voca = eng.hmm, eng.voca
    name2id = {n: i for i, n in enumerate(voca.names)}
    draw = _lm_sampler(eng.lm, voca, rng, follow_p=follow_p)

    def resolve(name):
        pid = hmm.logical_map.get(name)
        return hmm.phone_index.get(name) if pid is None else pid

    truths, windows, lens = [], [], []
    for _ in range(n_utts):
        k = int(rng.integers(min_words, max_words + 1))
        seq = [name2id["<s>"]]
        for _i in range(k):
            seq.append(draw(seq[-1]))
        seq.append(name2id["</s>"])
        # senone path from the EXACT cross-word triphones of the
        # sampled sequence (contexts known at generation time): the
        # truth's word-edge frames then score top under strict IWCD
        # (head_rc_dynamic / strict_iwcd2) AND under the pseudo-set
        # approximations (the exact physical is a member, and max /
        # bestN aggregates include it).  Generating from an arbitrary
        # first member (round 4) made the truth suboptimal the moment
        # any strict scoring was applied.
        senones = []
        for i, w in enumerate(seq):
            names = word_phone_names(voca.phones[w], True)
            lc = (center_name(voca.phones[seq[i - 1]][-1])
                  if i > 0 and voca.phones[seq[i - 1]] else None)
            rc = (center_name(voca.phones[seq[i + 1]][0])
                  if i + 1 < len(seq) and voca.phones[seq[i + 1]]
                  else None)
            for name in names:
                full = name
                if "-" not in name and "+" in name and lc:
                    full = f"{lc}-{name}"          # word head 'c+r'
                elif "+" not in name and "-" in name and rc:
                    full = f"{name}+{rc}"          # word tail 'l-c'
                elif "-" not in name and "+" not in name and lc and rc:
                    full = f"{lc}-{name}+{rc}"     # single-phone word
                pid = resolve(full)
                if pid is None:
                    pid = resolve(name)
                if pid is None:
                    pid = hmm.phone_index[center_name(name)]
                for s_ in range(int(hmm.phone_ns[pid])):
                    sidx = int(hmm.phone_states[pid, s_])
                    # ~1.5 frames per state on average (p_stay 0.6-like)
                    senones.append(sidx)
                    while rng.random() < 0.4:
                        senones.append(sidx)
        base = protos[senones] \
            + 0.25 * rng.standard_normal((len(senones), dim)) \
            .astype(np.float32)
        half = context // 2
        T = base.shape[0]
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-half, context - half)[None, :],
                      0, T - 1)
        win = base[idx].reshape(T, dim * context).astype(np.float32)
        truths.append([voca.names[w] for w in seq])
        windows.append(win)
        lens.append(T)
    return truths, windows, lens


def first_component_hmmset(hmm: HMMSet) -> HMMSet:
    """A 1-mixture copy of `hmm`: each state keeps its first mixture
    component at weight 1 (a Gaussian-selection model of the same
    monophones, as mkgshmm derives one)."""
    g = hmm.state_mix[:, 0]
    S = hmm.n_states
    return dataclasses.replace(
        hmm, means=hmm.means[g], ivars=hmm.ivars[g], gconst=hmm.gconst[g],
        state_mix=np.arange(S, dtype=np.int32)[:, None],
        state_lw=np.zeros((S, 1), np.float32),
        phone_index=dict(hmm.phone_index), logical_map={})


def write_gmm_task(out_dir: str, n_utts: int = 16, n_words: int = 5000,
                   n_phones: int = 668, dim: int = 39, n_mix: int = 16,
                   seed: int = 0, min_words: int = 6, max_words: int = 12):
    """A GMM-HMM dictation task written as the model files the `julius`
    command line reads: the flagship's shape (`make_hmmset` with n_mix
    diagonal Gaussians a state at MFCC_E_D_A width, `make_vocabulary`,
    `make_ngram`) as `am.binhmm` (with its feature parameters embedded),
    its first-component monophones as the -gshmm model `gs.binhmm`, an
    HTK dictionary `words.dict`, a v5 `lm.bingram`, and `n_utts`
    generative utterances as HTK parameter files `uNNN.mfc` listed in
    `list.txt`: each state's frames are its first component's mean plus
    `make_flagship_utts`' noise (context 1, no splicing).

    Returns (truths, {name: path}), the truths as word-name lists."""
    from julius_tpu_torch.io.bingram import write_bingram
    from julius_tpu_torch.io.binhmm import write_binhmm
    from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param

    hmm = make_hmmset(n_phones=n_phones, n_states=3, dim=dim, n_mix=n_mix,
                      seed=seed)
    voca = make_vocabulary(hmm, n_words, seed=seed + 1)
    lm = make_ngram(voca, seed=seed + 2)
    kind = "MFCC_E_D_A"
    para = parse_feature_type(kind)
    if para.veclen != dim:
        raise ValueError(f"{kind} is {para.veclen} wide, not {dim}")
    files = {k: os.path.join(out_dir, v) for k, v in (
        ("am", "am.binhmm"), ("gs", "gs.binhmm"), ("dict", "words.dict"),
        ("lm", "lm.bingram"), ("list", "list.txt"))}
    write_binhmm(files["am"], hmm, para=para)
    write_binhmm(files["gs"], first_component_hmmset(hmm), para=para)
    with open(files["dict"], "w", encoding="utf-8") as f:
        for name, out, phones in zip(voca.names, voca.outputs, voca.phones):
            f.write(f"{name}\t[{out}]\t{' '.join(phones)}\n")
    write_bingram(files["lm"], lm)
    protos = hmm.means[hmm.state_mix[:, 0]]
    truths, frames, _ = make_flagship_utts(
        hmm, voca, lm, protos, n_utts, dim, 1, min_words=min_words,
        max_words=max_words, seed=seed + 1)
    utts = []
    for u, x in enumerate(frames):
        utts.append(os.path.join(out_dir, f"u{u:03d}.mfc"))
        write_htk_param(utts[-1], HTKParam(data=x, samp_period=100000,
                                           kind=kind))
    with open(files["list"], "w") as f:
        f.write("\n".join(utts) + "\n")
    files["utts"] = utts
    return truths, files


def write_class_gmm(path: str, models, kind: str = "USER") -> None:
    """An HTK text model set of one-state, one-Gaussian models, the
    shape of the -gmm verification and GMM-VAD models (reference gmm.c
    reads an HMM set whose models are classes such as speech and
    noise): `models` maps each model name to its (mean, variance), each
    [D]."""
    dim = len(next(iter(models.values()))[0])
    lines = [f"~o <VecSize> {dim} <{kind}> <DIAGC> <NULLD>"]
    for name, (mean, var) in models.items():
        lines += [f'~h "{name}"', "<BeginHMM>", "<NumStates> 3",
                  "<State> 2", f"<Mean> {dim}",
                  " " + " ".join(f"{x:.6f}" for x in mean),
                  f"<Variance> {dim}",
                  " " + " ".join(f"{x:.6f}" for x in var),
                  "<TransP> 3", " 0.0 1.0 0.0", " 0.0 0.5 0.5",
                  " 0.0 0.0 0.0", "<EndHMM>"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def flagship_engine(n_words: int = 5000, n_phones: int = 668,
                    hidden: int = 2048, n_layers: int = 5,
                    seed: int = 0, trained: bool = False,
                    device: str = "cuda"):
    """The headline configuration: DNN-HMM dictation, FBANK_D_A 40ch.

    trained=True swaps the random output layer for the ridge-regressed
    senone readout (trained_dnn_weights) and also returns the senone
    prototypes: (engine, protos).  The search configuration is the
    reference's: pass 2 is the device A* re-scan."""
    from julius_tpu_torch.engine import Engine

    fe_cfg = parse_feature_type("FBANK_D_A")
    fe_cfg.fbank_num = 40
    feat_dim = 120          # 40 static + 40 delta + 40 accel
    hmm = make_hmmset(n_phones=n_phones, dim=feat_dim, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    lm = make_ngram(voca, seed=seed + 2)
    search = SearchConfig(lm_weight=8.0, lm_penalty=-2.0, trellis_topm=32)
    if trained:
        n_out = hmm.n_states
        weights, biases, out_w, out_b, protos = trained_dnn_weights(
            n_out, feat_dim * 11, feat_dim, 11, hidden, n_layers, seed + 3)
        dnn = DNNParams(
            weights=weights, biases=biases, output_w=out_w, output_b=out_b,
            log_prior=np.full(n_out, math.log10(1.0 / n_out), np.float32),
            context_len=11, feature_len=feat_dim)
        eng = Engine(hmm, voca, lm, dnn=dnn, frontend=fe_cfg, search=search,
                     device=device)
        return eng, protos
    dnn = make_dnn(dim_in=feat_dim * 11, hidden=hidden, n_layers=n_layers,
                   n_out=hmm.n_states, seed=seed + 3)
    return Engine(hmm, voca, lm, dnn=dnn, frontend=fe_cfg, search=search,
                  device=device)


def write_grammar_task(out_dir: str, n_utts: int = 16, n_words: int = 5000,
                       n_phones: int = 668, dim: int = 39, n_mix: int = 16,
                       seed: int = 0, n_cats: int = 40):
    """A grammar task and an isolated-word task beside `write_gmm_task`'s
    files (the same seeds give the same models and vocabulary): the
    vocabulary's `make_grammar` compiled by `grammar.mkdfa` into
    `gram.dfa`, `gram.dfa.forward`, `gram.dict` and `gram.term`
    (-gram gram), its words as the word list `words.list` (-w), and
    `n_utts` generative utterances each as HTK parameter files: grammar
    sentences `gNNN.mfc` (`grammar_sentences`) and single words
    `iNNN.mfc`.

    Returns (grammar truths, word truths, {name: path}), the truths as
    lists of output strings."""
    from julius_tpu_torch import grammar
    from julius_tpu_torch.io.dfa import load_dfa, load_grammar
    from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param

    hmm = make_hmmset(n_phones=n_phones, n_states=3, dim=dim, n_mix=n_mix,
                      seed=seed)
    voca = make_vocabulary(hmm, n_words, seed=seed + 1)
    prefix = os.path.join(out_dir, "gram")
    gtext, vtext = make_grammar(voca, n_cats)
    for ext, text in ((".grammar", gtext), (".voca", vtext)):
        with open(prefix + ext, "w", encoding="utf-8") as f:
            f.write(text)
    grammar.mkdfa(prefix)
    _, gvoca, word_cat = load_grammar(prefix)
    seqs = grammar_sentences(load_dfa(prefix + ".dfa.forward"), word_cat,
                             n_utts, seed=seed + 5)
    files = {"gram": prefix, "dfa": prefix + ".dfa",
             "gram_dict": prefix + ".dict",
             "wordlist": os.path.join(out_dir, "words.list")}
    with open(files["wordlist"], "w", encoding="utf-8") as f:
        for name, phones in zip(voca.names, voca.phones):
            f.write(f"{name} {' '.join(phones)}\n")
    rng = np.random.default_rng(seed + 6)
    words = [[int(w)] for w in rng.integers(2, voca.n_words, n_utts)]
    protos = hmm.means[hmm.state_mix[:, 0]]
    kind = "MFCC_E_D_A"
    for key, tag, v, batch in (("gram_utts", "g", gvoca, seqs),
                               ("word_utts", "i", voca, words)):
        frames, _ = make_word_utts(hmm, v, protos, batch, dim, 1,
                                   seed=seed + 7)
        files[key] = []
        for u, x in enumerate(frames):
            files[key].append(os.path.join(out_dir, f"{tag}{u:03d}.mfc"))
            write_htk_param(files[key][-1], HTKParam(
                data=x, samp_period=100000, kind=kind))
    return ([[gvoca.outputs[w] for w in q] for q in seqs],
            [[voca.names[w] for w in q] for q in words], files)
