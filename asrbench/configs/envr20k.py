"""The configuration's model inputs: tied-state triphones over an exact
senone count (asrbench/synth.py's pieces).

`synth.build_model`'s tied-triphone builder gives every (base phone,
state) position a cluster of one size, so its senone count is a
multiple of the positions; ENVR-v5.4's 4874 (2 x 2437, 2437 prime) is
none for 40 base phones.  Here the senones are spread over the
positions in clusters of uneven size, as a decision tree ties them.
The DNN is synth's matched-filter construction over a bank of
positions x largest-cluster prototypes, each position's cluster
prototypes drawn around one centre, of which the output layer keeps
the columns of the real senones.

As in flagship.py, the model comes from the configuration's own
`model_seed`, the same in every run, and the run's seed draws only the
traffic.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from asrbench import synth

#: the CMU pronouncing dictionary's 39 phones; sil makes the 40th
CMU_PHONES = ("aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k l m "
              "n ng ow oy p r s sh t th uh uw v w y z zh").split()
N_STATES = 3


def base_phone_names(n: int):
    """n base phones: the CMU set's first n - 1 and sil last."""
    if not 1 < n <= len(CMU_PHONES) + 1:
        raise ValueError(f"{n} base phones: 2 to {len(CMU_PHONES) + 1}")
    return CMU_PHONES[:n - 1] + ["sil"]


def cluster_sizes(n_senones: int, n_clusters: int, shape: float, cap: int,
                  rng) -> np.ndarray:
    """Senones of each cluster, from 1 to `cap` each, summing to
    n_senones exactly: the senones above one a cluster shared in
    proportion to gamma(shape) draws, a share held at the cap giving
    its excess to the others in proportion, then rounded by largest
    remainder."""
    if not n_clusters <= n_senones <= n_clusters * cap:
        raise ValueError(f"{n_senones} senones for {n_clusters} clusters "
                         f"of 1 to {cap}")
    w = rng.gamma(shape, size=n_clusters)
    room = cap - 1
    share = np.zeros(n_clusters)
    free = np.ones(n_clusters, bool)
    left = float(n_senones - n_clusters)
    while left > 1e-9 and free.any():
        share[free] += left * w[free] / w[free].sum()
        over = share > room
        left = float((share[over] - room).sum())
        share[over] = room
        free &= ~over
    sizes = 1 + np.floor(share).astype(np.int64)
    frac = np.where(sizes < cap, share - np.floor(share), -1.0)
    rest = n_senones - int(sizes.sum())
    sizes[np.argsort(-frac, kind="stable")[:rest]] += 1
    return sizes


def position_clusters(n_senones: int, n_base: int, cap: int, shape: float,
                      rng):
    """(cluster of each of the n_base x 3 positions, senones of each
    cluster, at most `cap`).  With fewer senones than positions the
    silence phone's last states share its last cluster, as flagship's
    silence ties its last two states."""
    n_pos = n_base * N_STATES
    if n_senones <= n_pos - N_STATES:
        raise ValueError(f"{n_base} phones of {N_STATES} states cannot "
                         f"hold {n_senones} senones")
    n_cl = min(n_senones, n_pos)
    return (np.minimum(np.arange(n_pos), n_cl - 1),
            cluster_sizes(n_senones, n_cl, shape, cap, rng))


def tied_hmmset(n_base: int, variants: int, dim: int, n_senones: int,
                shape: float, seed: int):
    """Base phones and n_base x variants physical triphones whose states
    tie into the position clusters; returns (hmm dict as synth's
    builders give it, [clusters] sizes).  A position's cluster has at
    most its 1 + variants physical states' senones, and they use every
    one: the base phone takes the cluster's first, each variant the
    senone of its rank (in a hash order of the variants) modulo the
    cluster's size."""
    rng = np.random.default_rng(seed)
    pos_cl, sizes = position_clusters(n_senones, n_base, 1 + variants,
                                      shape, rng)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    means, ivars, gconst = synth._gauss(rng, n_senones, dim)
    n_phys = n_base * (variants + 1)
    states = np.zeros((n_phys, N_STATES), np.int32)
    for b in range(n_base):
        for s in range(N_STATES):
            c = pos_cl[b * N_STATES + s]
            states[b, s] = first[c]
            order = sorted(range(variants),
                           key=lambda v: zlib.crc32(f"{b}/{v}/{s}".encode()))
            for rank, v in enumerate(order, start=1):
                states[n_base + b * variants + v, s] = \
                    first[c] + rank % int(sizes[c])
    bases = base_phone_names(n_base)
    names = bases + [f"{bases[b]}#t{v:02d}" for b in range(n_base)
                     for v in range(variants)]
    hmm = dict(means=means, ivars=ivars, gconst=gconst, phone_states=states,
               phone_ns=np.full(n_phys, N_STATES, np.int32),
               phone_trans=np.tile(synth._trans(N_STATES)[None],
                                   (n_phys, 1, 1)),
               phone_names=names, logical_map={}, triphone=True)
    return hmm, sizes


def clustered_dnn(sizes: np.ndarray, dim: int, context: int, hidden: int,
                  layers: int, seed: int):
    """synth.trained_dnn_weights over a bank of len(sizes) x max(sizes)
    prototypes, clustered by bank row; the output layer keeps the first
    sizes[c] columns of each row, in order: one column a senone."""
    cmax = int(sizes.max())
    weights, biases, out_w, out_b, protos = synth.trained_dnn_weights(
        len(sizes) * cmax, dim * context, dim, context, hidden, layers, seed,
        cluster=cmax)
    keep = np.concatenate([c * cmax + np.arange(n)
                           for c, n in enumerate(sizes)])
    return (weights, biases, np.ascontiguousarray(out_w[:, keep]),
            out_b[keep], protos[keep])


def build_model(cfg: dict, seed: int) -> synth.Model:
    dim, ctx = int(cfg["feat_dim"]), int(cfg["context"])
    if int(cfg.get("input_size", dim * ctx)) != dim * ctx:
        raise ValueError("input_size is not feat_dim x context")
    n_base, variants = int(cfg["num_phones"]), int(cfg["variants"])
    S = int(cfg["num_senones"])
    hmm, sizes = tied_hmmset(n_base, variants, dim, S,
                             float(cfg["cluster_shape"]), seed)
    names, phones = synth.make_vocabulary(hmm["phone_names"],
                                          int(cfg["vocab_size"]), seed + 1)
    synth.bind_triphones(hmm, phones, n_base, variants)
    uni, bi = synth.make_ngram(len(names), seed + 2)
    weights, biases, out_w, out_b, protos = clustered_dnn(
        sizes, dim, ctx, int(cfg["hidden_size"]),
        int(cfg["num_hidden_layers"]), seed + 3)
    return synth.Model(
        **hmm, names=names, phones=phones, uni=uni, bi=bi, weights=weights,
        biases=biases, out_w=out_w, out_b=out_b,
        log_prior=np.full(S, math.log10(1.0 / S), np.float32),
        context=ctx, feat_dim=dim, protos=protos, search=dict(cfg["search"]))


def build(cfg: dict, seed: int):
    return build_model(cfg, int(cfg["model_seed"]))
