"""Port vs reference: pass 1's word-end stage.

The port's `word_end_plain` (ops/word_end_kernel.py, the CPU path and
the oracle of csrc/word_end.cu) against the reference's
`_word_end_candidates` (vmapped over the batch) and
`_scalar_entry_batched` on the same seeded states and tables: narrow
and wide 2-gram keys, factoring 1 and 2, no LM, fewer exits than 2M and
than M, M not a power of two, B = 1, and equal scores across the 2M-th
and the M-th place.  The reference takes its exact `lax.top_k` on every
branch (PASS1_EXACT_TOPK=1; on a TPU it may take `approx_max_k`).
Integer fields must be equal and scores within atol 1e-5, as
tests/test_pass1_fused.py holds the reference's two pass-1 paths.  A
numpy mirror of the kernel's selection (its radix select, its ordered
collection of the k-th key's ties and its ranking by counting) is held
to the stable top-k on rows full of ties, and one whole pass-1 decode on the
CPU equals the reference's.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search import pass1 as jp1
from julius_tpu.search.ngram_device import DeviceNgram as RefNgram
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch import convert
from julius_tpu_torch.ops import word_end_kernel as we
from julius_tpu_torch.search import pass1 as tp1

from torch_fixtures import LOG_ZERO, make_word_end_inputs, word_end_args

T_STEP = 7      # the step whose winner points into frame T_STEP - 1

#: name -> (make_word_end_inputs arguments, Pass1Config fields)
CASES = {
    "narrow_f1": (dict(B=3, N=3000, Ex=700, M=32), {}),
    "wide_f1": (dict(B=3, N=3000, Ex=700, M=32, wide=True), {}),
    "narrow_f2": (dict(B=3, N=3000, Ex=700, M=32), dict(factoring=2)),
    "wide_f2": (dict(B=2, N=2000, Ex=500, M=16, wide=True),
                dict(factoring=2)),
    "no_lm": (dict(B=3, N=3000, Ex=700, M=32, lm=False),
              dict(use_lm=False, lm_penalty=-2.5)),
    "weights": (dict(B=3, N=2000, Ex=600, M=24),
                dict(lm_weight=6.7, lm_penalty=-3.25)),
    "ex_below_2m": (dict(B=3, N=400, Ex=40, M=32), {}),
    "ex_below_m": (dict(B=2, N=300, Ex=20, M=32), {}),
    "b1": (dict(B=1, N=5000, Ex=1200, M=64), {}),
    "m1": (dict(B=2, N=500, Ex=100, M=1, straddle=False), {}),
}


def reference_stage(d, cfg_kw, t):
    """The reference's atoms [B, M] and winner [B] on the arrays."""
    jdev = types.SimpleNamespace(
        exit_nodes=jnp.asarray(d["exit_nodes"].astype(np.int32)),
        **{k: (None if d[k] is None else jnp.asarray(d[k]))
           for k in ("exit_nlp", "exit_w", "exit_wlm", "exit_uni",
                     "exit_transp", "ctx_info")})
    jng = None
    if d["lm"]:
        jng = RefNgram(uni=jnp.asarray(d["uni"]),
                       bo_uni=jnp.asarray(d["bo_uni"]),
                       bi_keys=jnp.zeros(1, jnp.uint32),
                       bi_vals=jnp.zeros(1, jnp.float32),
                       bi_rows=jnp.asarray(d["bi_rows"]),
                       n_words=d["n_words"], bos_id=0, eos_id=1, unk_id=2,
                       wide=d["wide"])
    cfg = jp1.Pass1Config(**cfg_kw)

    def one(s, c, p):
        return jp1._word_end_candidates(
            jdev, jng, cfg, jp1.Pass1State(s, c, p, jnp.int32(t - 1)))
    atoms = jax.vmap(one)(jnp.asarray(d["score"]), jnp.asarray(d["ctx"]),
                          jnp.asarray(d["prev"]))
    entry = jp1._scalar_entry_batched(atoms, jnp.int32(t), cfg.n_atoms)
    return ([np.asarray(a) for a in atoms],
            [np.asarray(a) for a in entry])


def assert_same_fields(got, want):
    """Integers equal, floats within atol 1e-5."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if g.dtype.kind == "f":
            assert np.allclose(g, w, atol=1e-5, rtol=0)
        else:
            assert np.array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("case", list(CASES))
def test_word_end_plain_matches_reference(case, monkeypatch):
    monkeypatch.setenv("PASS1_EXACT_TOPK", "1")
    shape, cfg_kw = CASES[case]
    d = make_word_end_inputs(len(case), **shape)
    cfg_kw = dict(cfg_kw, n_atoms=shape["M"])
    want_atoms, want_entry = reference_stage(d, cfg_kw, T_STEP)
    dev, ng, score, ctx, prev = word_end_args(d)
    atoms, entry = we.word_end_plain(
        dev, ng, tp1.Pass1Config(**cfg_kw), score, ctx, prev,
        torch.tensor([T_STEP], dtype=torch.int32))
    assert [a.dtype for a in atoms] == list(we.TRELLIS_DTYPES)
    assert_same_fields(atoms, want_atoms)
    assert_same_fields(entry, want_entry)
    # the rows hold live word ends, and row 0's are ties
    assert (atoms.word >= 0).sum() >= min(shape["Ex"], shape["M"])
    if case == "narrow_f1":
        assert (atoms.score[0] == atoms.score[0, 0]).sum() > 1


def test_word_end_on_cpu_is_the_plain_version(monkeypatch):
    """The wrapper takes the plain version for CPU tensors and counts no
    launch; without t it gives no winner."""
    d = make_word_end_inputs(3, B=2, N=2000, Ex=400, M=16)
    dev, ng, score, ctx, prev = word_end_args(d)
    cfg = tp1.Pass1Config(n_atoms=16)
    n0 = we.LAUNCHES
    got, no_entry = we.word_end(dev, ng, cfg, score, ctx, prev)
    want, _ = we.word_end_plain(dev, ng, cfg, score, ctx, prev)
    assert no_entry is None and we.LAUNCHES == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    monkeypatch.setattr(we, "build", None)      # never built for the CPU
    we.word_end(dev, ng, cfg, score, ctx, prev, torch.tensor([3]))


# ---- a numpy mirror of csrc/word_end.cu's selection

def ord_key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 key of f32 scores."""
    u = np.where(x == 0, 0, x.astype(np.float32).view(np.uint32))
    u = u.astype(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def radix_select(keys: np.ndarray, k: int):
    """Steps 1-2: the k-th largest key and how many keys equal to it are
    taken, by 8-bit passes whose bin warp 0 finds as the kernel does
    (lane l holds bins 255 - 8l ... 248 - 8l)."""
    prefix = pmask = 0
    rem = k
    for shift in (24, 16, 8, 0):
        inside = (keys & np.uint32(pmask)) == prefix
        hist = np.bincount((keys[inside] >> shift) & 255, minlength=256)
        c = hist[::-1].reshape(32, 8)
        s = c.sum(axis=1)
        incl = np.cumsum(s)
        excl = incl - s
        lanes = np.flatnonzero((excl < rem) & (rem <= incl))
        assert len(lanes) == 1
        lane = int(lanes[0])
        cum = int(excl[lane])
        for j in range(8):
            if cum + c[lane, j] >= rem:
                prefix |= (255 - 8 * lane - j) << shift
                rem -= cum
                break
            cum += int(c[lane, j])
        pmask |= 255 << shift
    return prefix, rem


def collect(keys: np.ndarray, kth: int, rem: int, select: bool,
            nwarps: int = 32) -> list:
    """Step 3: each warp's contiguous range, its equal keys ranked after
    the earlier warps' (a count a warp first); every key above kth and
    the first `rem` equal to it, in the order the warps take them."""
    Ex = len(keys)
    span = ((Ex + nwarps - 1) // nwarps + 31) & ~31
    ranges = [(min(w * span, Ex), min(min(w * span, Ex) + span, Ex))
              for w in range(nwarps)]
    weq = [int((keys[lo:hi] == kth).sum()) if select else 0
           for lo, hi in ranges]
    taken = []
    for w, (lo, hi) in enumerate(ranges):
        base = sum(weq[:w])
        for i in range(lo, hi):
            eq = select and keys[i] == kth
            if keys[i] > kth or (eq and base < rem):
                taken.append(i)
            base += eq
    return taken


def rank_scatter(v: np.ndarray, limit: int) -> np.ndarray:
    """The kernel's rank_scatter on distinct uint64 values: the value of
    descending rank p < limit leaves its low word, inverted, at p."""
    out = np.full(min(limit, len(v)), -1, np.int64)
    for x in v:
        n = int((v > x).sum())
        if n < limit:
            out[n] = int(~x & np.uint64(0xFFFFFFFF))
    return out


def mirror_top(sc: np.ndarray, k: int) -> np.ndarray:
    """Exit indices of the kernel's stage-1 order for one row."""
    keys = ord_key(sc)
    select = k < len(sc)
    kth, rem = radix_select(keys, k) if select else (0, 0)
    taken = collect(keys, kth, rem, select)
    assert len(taken) == k
    idx = np.asarray(taken, np.uint64)
    comp = (keys[taken].astype(np.uint64) << np.uint64(32)) \
        | (~idx & np.uint64(0xFFFFFFFF))
    return rank_scatter(comp, k)


@pytest.mark.parametrize("Ex,k", [(5000, 64), (20000, 256), (700, 64),
                                  (64, 64), (40, 40), (300, 48), (33, 1)])
def test_kernel_selection_mirror_matches_stable_topk(Ex, k):
    """Rows of integer scores, LOG_ZERO runs, both zeros and equal values
    across the k-th place: the mirror's order is the stable top-k's."""
    rng = np.random.default_rng(Ex + k)
    for trial in range(3):
        sc = rng.integers(-30, 5, Ex).astype(np.float32)
        sc[rng.random(Ex) < 0.6] = LOG_ZERO
        sc[Ex // 4:Ex // 2] = LOG_ZERO
        sc[rng.random(Ex) < 0.05] = -0.0
        if trial == 1:
            sc[:] = LOG_ZERO                    # every exit ties
        if trial == 2 and Ex > k + 8 and k > 3:
            sc[:] = -50.0
            sc[rng.choice(Ex, k - 3, replace=False)] = 1.5
        _, want = we.topk_stable(torch.from_numpy(sc), k)
        assert np.array_equal(mirror_top(sc, k), want.numpy())


def test_rank_mirror_is_a_stable_descending_order():
    """Re-rank keys (corrected key, ~stage-1 rank) with equal corrected
    keys: the slots take the ranks in the stable sort's order, up to
    the limit."""
    rng = np.random.default_rng(2)
    for k, limit in ((1, 1), (2, 1), (64, 32), (256, 128), (40, 32)):
        corr = rng.integers(-20, 3, k).astype(np.float32)
        corr[rng.random(k) < 0.3] = LOG_ZERO
        r = np.arange(k, dtype=np.uint64)
        comp = (ord_key(corr).astype(np.uint64) << np.uint64(32)) \
            | (~r & np.uint64(0xFFFFFFFF))
        _, want = we.topk_stable(torch.from_numpy(corr), min(limit, k))
        assert np.array_equal(rank_scatter(comp, limit), want.numpy())


# ---- a whole decode

def test_pass1_batch_matches_reference_with_exact_topk(monkeypatch):
    """pass1_batch on the CPU (the word-end stage's plain version each
    frame, through the beam-update kernel's plain version) against the
    reference's pass1_batch at M = 8, where Ex > 4k: the reference's
    exact top-k is forced, and the trellises must agree field by field
    (word ids equal everywhere; the other integers equal and scores
    within 1e-5 where a word survived)."""
    monkeypatch.setenv("PASS1_EXACT_TOPK", "1")
    eng = flagship_engine(n_words=120, n_phones=48, hidden=32, n_layers=1)
    cfg_ref = dataclasses.replace(eng.p1_cfg, n_atoms=8)
    rng = np.random.default_rng(11)
    B, T = 2, 60
    feats = rng.standard_normal((B, T, 1320)).astype(np.float32)
    out = np.array(jax.jit(eng._outprob)(jnp.asarray(feats)))
    out[1] = out[1][::-1]
    nfr = np.asarray([T, T - 13], np.int32)
    assert int(eng.dev_net.exit_nodes.shape[0]) > 4 * 2 * cfg_ref.n_atoms
    old = jp1.FUSE_PASS1
    jp1.FUSE_PASS1 = False
    try:
        ref = jp1.pass1_batch(eng.dev_net, eng.ngram_dev, cfg_ref,
                              jnp.asarray(out), jnp.asarray(nfr))
    finally:
        jp1.FUSE_PASS1 = old
    ref = jax.tree_util.tree_map(np.asarray, ref)
    dev = convert.device_network(convert.numpy_fields(eng.dev_net), "cpu")
    ng = convert.device_ngram(convert.numpy_fields(eng.ngram_dev), "cpu")
    cfg = tp1.Pass1Config(**{f.name: getattr(cfg_ref, f.name)
                             for f in dataclasses.fields(tp1.Pass1Config)})
    got = tp1.pass1_batch(dev, ng, cfg, torch.from_numpy(out),
                          torch.from_numpy(nfr))
    got = [a.numpy() for a in got]
    valid = ref.word >= 0
    assert np.array_equal(got[0], ref.word)
    assert valid.sum() > 500
    for name, g, w in zip(tp1.Trellis._fields, got, ref):
        w = np.asarray(w)
        if g.dtype.kind == "f":
            assert np.allclose(np.where(valid, g, 0), np.where(valid, w, 0),
                               atol=1e-5), name
        else:
            assert np.array_equal(np.where(valid, g, 0),
                                  np.where(valid, w, 0)), name
