"""Synthetic model builders at realistic scale (flagship builders only).

Copies of `julius_tpu/tools/synth.py`'s flagship builders, so the port
builds the same tables from the same seeds: the flagship DNN-HMM LVCSR
configuration (ENVR-v5.4-like: 40ch FBANK_D_A front-end, 11-frame
splice, 5x2048 sigmoid hidden layers, ~2k senones — reference README.md
Quick Run model + Sample.dnnconf) without shipping model files.  The
lvcsr (tied-triphone) builders wait for the port's pseudo-set scorer.
"""

from __future__ import annotations

import math

import numpy as np

from julius_tpu_torch.config import SearchConfig, parse_feature_type
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


def make_flagship_utts(hmm, voca, lm, protos, n_utts, dim, context,
                       min_words=4, max_words=9, seed=0):
    """Generative flagship utterances: word sequence -> senone path via
    the HMM transitions -> base frames = senone prototypes + noise ->
    spliced windows (what the decoders consume).  Truth is known by
    construction.  Returns (truths, windows, lens)."""
    rng = np.random.default_rng(seed + 9)
    name2id = {n: i for i, n in enumerate(voca.names)}
    draw = _lm_sampler(lm, voca, rng)
    truths, windows, lens = [], [], []
    for _ in range(n_utts):
        k = int(rng.integers(min_words, max_words + 1))
        seq = [name2id["<s>"]]
        for _i in range(k):
            seq.append(draw(seq[-1]))
        seq.append(name2id["</s>"])
        senones = []
        for w in seq:
            for p in voca.phones[w]:
                pid = hmm.phone_index[p]
                ns = int(hmm.phone_ns[pid])
                trans = hmm.phone_trans[pid]
                s = 0
                while s < ns:
                    senones.append(int(hmm.phone_states[pid, s]))
                    if rng.random() > math.exp(trans[s + 1, s + 1]):
                        s += 1
        base = protos[senones] \
            + 0.25 * rng.standard_normal((len(senones), dim)) \
            .astype(np.float32)
        half = context // 2
        T = base.shape[0]
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-half, context - half)[None, :], 0, T - 1)
        win = base[idx].reshape(T, dim * context).astype(np.float32)
        truths.append([voca.names[w] for w in seq])
        windows.append(win)
        lens.append(T)
    return truths, windows, lens


def flagship_engine(n_words: int = 5000, n_phones: int = 668,
                    hidden: int = 2048, n_layers: int = 5,
                    seed: int = 0, trained: bool = False,
                    device: str = "cuda"):
    """The headline configuration: DNN-HMM dictation, FBANK_D_A 40ch.

    trained=True swaps the random output layer for the ridge-regressed
    senone readout (trained_dnn_weights) and also returns the senone
    prototypes: (engine, protos).  Pass 2 is the frozen-score search
    (pass2_rescan=False), the one pass 2 this port has."""
    from julius_tpu_torch.engine import Engine

    fe_cfg = parse_feature_type("FBANK_D_A")
    fe_cfg.fbank_num = 40
    feat_dim = 120          # 40 static + 40 delta + 40 accel
    hmm = make_hmmset(n_phones=n_phones, dim=feat_dim, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    lm = make_ngram(voca, seed=seed + 2)
    search = SearchConfig(lm_weight=8.0, lm_penalty=-2.0, trellis_topm=32,
                          pass2_rescan=False)
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
