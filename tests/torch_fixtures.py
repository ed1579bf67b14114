"""Shared inputs and settings for the port's tests (imports neither JAX
nor the reference package, so the card-only tests can use it where JAX
is not installed)."""

import numpy as np
import torch

from julius_tpu_torch.ops import pass1_kernel as tpk

LOG_ZERO = -1e10

# The test suite runs in several pytest workers on one machine.  torch's
# OpenMP threads spin between parallel regions, and with one pool per
# core in every worker a host re-scan test ran 29 times slower (290 s
# against 10 s, six workers on eight cores) than with one thread each.
# Every test module of the port imports this one, so each worker keeps
# a single intra-op thread.
torch.set_num_threads(1)


def make_step_inputs(seed, B, N, K, R=50):
    """One beam-update frame's arrays ([B, N] state, K+1 arc shifts, an
    R-wide outprob row) built to hit every rule of the update."""
    rng = np.random.default_rng(seed)
    # small integer-valued scores make exact ties common
    score = rng.integers(-40, 0, (B, N)).astype(np.float32)
    score[rng.random((B, N)) < 0.2] = LOG_ZERO
    score[:, 100:400] = LOG_ZERO                     # a LOG_ZERO run
    ctx = rng.integers(-1, 500, (B, N)).astype(np.int32)
    prev = rng.integers(-1, 5000, (B, N)).astype(np.int32)
    loc = rng.integers(-3, 1, (K + 1, N)).astype(np.float32)
    loc[rng.random((K + 1, N)) < 0.3] = LOG_ZERO     # missing arcs
    et = rng.integers(-6, 0, N).astype(np.float32)
    et[rng.random(N) < 0.7] = LOG_ZERO               # no word entry
    row = rng.integers(-5, 0, (B, R)).astype(np.float32)
    sidx = rng.integers(0, R, N).astype(np.int32)
    ent = rng.integers(-40, -20, B).astype(np.float32)
    ent[0] = LOG_ZERO                                # no word end yet
    ectx = rng.integers(-1, 500, B).astype(np.int32)
    eprev = rng.integers(-1, 5000, B).astype(np.int32)
    fv = np.ones(B, bool)
    fv[1:2] = False                                  # a frozen row
    return dict(score=score, ctx=ctx, prev=prev, loc=loc, et=et, row=row,
                sidx=sidx, ent=ent, ectx=ectx, eprev=eprev, fv=fv)


def run_step(d, device="cpu", fn=tpk.fused_step_plain):
    """One beam-update frame of `fn` on the make_step_inputs arrays."""
    t = {k: torch.tensor(v, device=device) for k, v in d.items()}
    res = fn(t["score"], t["ctx"], t["prev"], t["loc"], t["et"], t["row"],
             t["sidx"], t["ent"], t["ectx"], t["eprev"], t["fv"])
    return [a.cpu().numpy() for a in res]


def assert_same_step(a, b):
    """Scores within atol 1e-5, ctx and prev equal."""
    assert np.allclose(a[0], b[0], atol=1e-5, rtol=0)
    assert np.array_equal(a[1], b[1])
    assert np.array_equal(a[2], b[2])


def make_word_end_inputs(seed, B, N, Ex, M, V=120, n_lm=80, wide=False,
                         lm=True, straddle=True):
    """One frame's word-end stage inputs as numpy arrays: the [B, N]
    state (integer-valued scores with runs of LOG_ZERO, so ties are the
    rule), the Ex exits' tables (sorted node ids, words of a V-word
    vocabulary, n_lm of them in a 2-gram over n_lm LM words, some
    transparent), ctx_info and the 2-gram's hashed rows (narrow keys or,
    with wide=True, (v, w) pairs).  straddle=True puts equal scores
    across the 2M-th exit of row 0 and, among exits without an LM word
    (no swap), across the M-th corrected score of row 1."""
    from julius_tpu_torch.search.ngram_device import (_build_hash,
                                                      _build_hash_wide)
    rng = np.random.default_rng(seed)
    score = rng.integers(-40, 0, (B, N)).astype(np.float32)
    score[rng.random((B, N)) < 0.5] = LOG_ZERO
    score[:, N // 3:N // 2] = LOG_ZERO               # a LOG_ZERO run
    exit_nodes = np.sort(rng.choice(N, Ex, replace=False)).astype(np.int64)
    exit_nlp = -rng.integers(0, 3, Ex).astype(np.float32)
    exit_w = rng.integers(0, V, Ex).astype(np.int32)
    wid2lm = np.where(np.arange(V) < n_lm, np.arange(V), -1)
    wid2lm = rng.permutation(wid2lm).astype(np.int32)
    exit_wlm = wid2lm[exit_w]
    uni = -rng.random(n_lm).astype(np.float32) * 3.0
    uni[rng.random(n_lm) < 0.1] = LOG_ZERO           # absent unigrams
    bo = -rng.random(n_lm).astype(np.float32)
    exit_uni = np.where(exit_wlm >= 0, uni[np.maximum(exit_wlm, 0)],
                        0.0).astype(np.float32)
    exit_transp = rng.random(Ex) < 0.05
    ctx = rng.integers(-1, V, (B, N)).astype(np.int32)
    prev = rng.integers(-1, 5000, (B, N)).astype(np.int32)
    if straddle and Ex >= 2 * M + 8:
        # row 0: 2M - 3 exits above v, 6 at v
        e = rng.permutation(Ex)
        score[0, exit_nodes] = LOG_ZERO
        score[0, exit_nodes[e[:2 * M - 3]]] = -1.0 - exit_nlp[e[:2 * M - 3]]
        score[0, exit_nodes[e[2 * M - 3:2 * M + 3]]] = \
            -20.0 - exit_nlp[e[2 * M - 3:2 * M + 3]]
    if straddle and B > 1:
        # row 1: M - 2 exits without an LM word above v, 5 at v
        nolm = np.flatnonzero(exit_wlm < 0)
        if len(nolm) >= M + 3:
            e = rng.permutation(nolm)
            score[1, exit_nodes[e[:M - 2]]] = 50.0 - exit_nlp[e[:M - 2]]
            score[1, exit_nodes[e[M - 2:M + 3]]] = \
                40.0 - exit_nlp[e[M - 2:M + 3]]
    ctx_info = np.stack([wid2lm.astype(np.float32),
                         np.where(wid2lm >= 0, bo[np.maximum(wid2lm, 0)],
                                  0.0)], axis=1).astype(np.float32)
    pairs = rng.choice(n_lm * n_lm, n_lm * n_lm // 3, replace=False)
    v, w = (pairs // n_lm).astype(np.uint32), (pairs % n_lm).astype(np.uint32)
    vals = -rng.random(len(pairs)).astype(np.float32) * 4.0
    if wide:
        tv_, tw_, tp = _build_hash_wide(v, w, vals)
        rows = np.stack([tv_.view(np.int32), tw_.view(np.int32),
                         tp.view(np.int32)], axis=1)
    else:
        tk, tv = _build_hash(v * np.uint32(n_lm) + w, vals)
        rows = np.stack([tk.view(np.int32), tv.view(np.int32)], axis=1)
    return dict(score=score, ctx=ctx, prev=prev, exit_nodes=exit_nodes,
                exit_nlp=exit_nlp, exit_w=exit_w, exit_wlm=exit_wlm,
                exit_uni=exit_uni, exit_transp=exit_transp,
                ctx_info=ctx_info if lm else None, uni=uni, bo_uni=bo,
                bi_rows=rows, n_words=n_lm, wide=wide, lm=lm)


def word_end_args(d, device="cpu"):
    """(dev, ngram, score, ctx, prev) of the port from
    make_word_end_inputs arrays: `dev` carries the exit tables and
    ctx_info as search.pass1's DeviceNetwork names them; ngram is None
    without an LM."""
    import types

    from julius_tpu_torch.search.ngram_device import device_ngram_from_numpy

    def t(name):
        a = d[name]
        return None if a is None else torch.from_numpy(np.array(a)).to(device)
    dev = types.SimpleNamespace(**{k: t(k) for k in (
        "exit_nodes", "exit_nlp", "exit_w", "exit_wlm", "exit_uni",
        "exit_transp", "ctx_info")})
    ng = None
    if d["lm"]:
        ng = device_ngram_from_numpy(d["uni"], d["bo_uni"], d["bi_rows"],
                                     d["n_words"], 0, 1, 2, d["wide"], device)
    return dev, ng, t("score"), t("ctx"), t("prev")
