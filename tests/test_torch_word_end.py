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
numpy mirror of the kernel's selection over a cluster of C blocks a
row (its radix select on the blocks' summed histograms, stopping on a
whole bin, each block's tie quota and first slot from the counts of
the ranks below it, its one ranking by counting, split over the
blocks, and its winner) is held to the stable top-k and to the plain
version's sorts on rows full of ties, with the cluster plan's rule, and
one whole pass-1 decode on the CPU equals the reference's.
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


def block_ranges(Ex: int, C: int) -> list:
    """Rank r's contiguous exits [r Ex / C, (r + 1) Ex / C)."""
    return [(r * Ex // C, (r + 1) * Ex // C) for r in range(C)]


def radix_select(keys: np.ndarray, k: int, C: int = 1):
    """Step 2 over a cluster of C blocks: per pass each block's 256-bin
    histogram of its keys inside the prefix, summed over the blocks; the
    bin found as warp 0 finds it (lane l holds bins 255 - 8l ... 248 -
    8l); after each pass each block's keys above the bin added to its
    n_gt, its keys in the bin its n_eq; a bin taken whole ends the select
    (kth = prefix - 1, rem = 0, the bin's keys counted above).  ->
    (kth, rem, n_gt [C], n_eq [C], passes run)."""
    ranges = block_ranges(len(keys), C)
    prefix = pmask = 0
    rem = k
    n_gt, n_eq = np.zeros(C, np.int64), np.zeros(C, np.int64)
    for p, shift in enumerate((24, 16, 8, 0)):
        secs = []
        for lo, hi in ranges:
            kb = keys[lo:hi]
            inside = (kb & np.uint32(pmask)) == prefix
            secs.append(np.bincount((kb[inside] >> shift) & 255,
                                    minlength=256))
        c = np.sum(secs, axis=0)[::-1].reshape(32, 8)
        s = c.sum(axis=1)
        incl = np.cumsum(s)
        excl = incl - s
        lanes = np.flatnonzero((excl < rem) & (rem <= incl))
        assert len(lanes) == 1
        lane = int(lanes[0])
        cum = int(excl[lane])
        for j in range(8):
            if cum + c[lane, j] >= rem:
                b = 255 - 8 * lane - j
                rem -= cum
                whole = c[lane, j] == rem and (prefix | (b << shift)) != 0
                break
            cum += int(c[lane, j])
        prefix |= b << shift
        pmask |= 255 << shift
        for r, sec in enumerate(secs):
            n_gt[r] += sec[b + 1:].sum() + (sec[b] if whole else 0)
            n_eq[r] = 0 if whole else sec[b]
        if whole:
            return prefix - 1, 0, n_gt, n_eq, p + 1
    return prefix, rem, n_gt, n_eq, 4


def collect(keys: np.ndarray, kth: int, rem: int, select: bool,
            n_gt, n_eq, C: int = 1, nwarps: int = 32) -> list:
    """Steps 3-4: block r's first slot and tie quota from the counts of
    the ranks below it; in the block, each warp's contiguous range, its
    equal keys ranked after the earlier warps' where the quota takes some
    but not all of the block's; every key above kth and the first `quota`
    equal to it, each at the block's first slot plus its place in the
    block (the kernel's order there is the atomics', any).  -> the exit
    index of each slot."""
    slots = {}
    eq_before = slot_base = 0
    for r, (lo, hi) in enumerate(block_ranges(len(keys), C)):
        quota = min(max(rem - eq_before, 0), int(n_eq[r]))
        kb = keys[lo:hi]
        n = hi - lo
        span = ((n + nwarps - 1) // nwarps + 31) & ~31
        warps = [(min(w * span, n), min(min(w * span, n) + span, n))
                 for w in range(nwarps)]
        partial = 0 < quota < n_eq[r]
        weq = [int((kb[a:b] == kth).sum()) if partial else 0
               for a, b in warps]
        taken = []
        for w, (a, b) in enumerate(warps):
            eqb = sum(weq[:w])
            for i in range(a, b):
                eq = select and kb[i] == kth
                if (not select or kb[i] > kth) or (eq and eqb < quota):
                    taken.append(lo + i)
                eqb += eq
        assert len(taken) == (n_gt[r] if select else n) + quota
        for j, e in enumerate(taken):
            slots[slot_base + j] = e
        slot_base += len(taken)
        eq_before += int(n_eq[r])
    return [slots[s] for s in range(len(slots))]


def rank_records(hi: np.ndarray, lo: np.ndarray, s0: int, s1: int,
                 limit: int) -> dict:
    """The kernel's rank_write on records (hi = corrected key << 32 | key,
    lo = ~exit): the record of slot s0 <= s < s1 whose rank p (the count
    of larger (hi, lo)) is below the limit goes to output slot p."""
    out = {}
    for s in range(s0, s1):
        p = int(((hi > hi[s]) | ((hi == hi[s]) & (lo > lo[s]))).sum())
        if p < limit:
            out[p] = s
    return out


def records(keys, idx, corr) -> tuple:
    """The records' rank keys of candidates (key, exit, corrected)."""
    hi = (ord_key(corr).astype(np.uint64) << np.uint64(32)) \
        | keys.astype(np.uint64)
    lo = (~np.asarray(idx, np.uint64)) & np.uint64(0xFFFFFFFF)
    return hi, lo


def mirror_top(sc: np.ndarray, k: int, C: int = 1, nwarps: int = 32):
    """Exit indices of the kernel's top k of one row in descending order
    of (score, -index), with a cluster of C blocks: the selection, then
    the ranking split over the C blocks with every corrected score equal
    (so the order is the stage-1 order)."""
    keys = ord_key(sc)
    select = k < len(sc)
    if select:
        kth, rem, n_gt, n_eq, _ = radix_select(keys, k, C)
    else:
        kth, rem = 0, 0
        n_gt = np.diff([lo for lo, _ in block_ranges(len(sc), C)]
                       + [len(sc)])
        n_eq = np.zeros(C, np.int64)
    taken = collect(keys, kth, rem, select, n_gt, n_eq, C, nwarps)
    assert len(taken) == k
    hi, lo = records(keys[taken], taken, np.zeros(k, np.float32))
    order = {}
    for r in range(C):
        part = rank_records(hi, lo, r * k // C, (r + 1) * k // C, k)
        assert not set(part) & set(order)
        order.update(part)
    return np.asarray([taken[order[p]] for p in range(k)], np.int64)


def tie_rows(rng, Ex, k):
    """Rows of integer scores, LOG_ZERO runs, both zeros and equal values
    across the k-th place; every exit tied; k - 3 exits above a flat
    rest."""
    sc = rng.integers(-30, 5, Ex).astype(np.float32)
    sc[rng.random(Ex) < 0.6] = LOG_ZERO
    sc[Ex // 4:Ex // 2] = LOG_ZERO
    sc[rng.random(Ex) < 0.05] = -0.0
    yield sc
    yield np.full(Ex, LOG_ZERO, np.float32)
    if Ex > k + 8 and k > 3:
        flat = np.full(Ex, -50.0, np.float32)
        flat[rng.choice(Ex, k - 3, replace=False)] = 1.5
        yield flat


@pytest.mark.parametrize("Ex,k", [(5000, 64), (20000, 256), (700, 64),
                                  (64, 64), (40, 40), (300, 48), (33, 1)])
def test_kernel_selection_mirror_matches_stable_topk(Ex, k):
    """One block a row: the mirror's order is the stable top-k's on rows
    full of ties."""
    rng = np.random.default_rng(Ex + k)
    for sc in tie_rows(rng, Ex, k):
        _, want = we.topk_stable(torch.from_numpy(sc), k)
        assert np.array_equal(mirror_top(sc, k), want.numpy())


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("Ex,k,nwarps", [
    (5000, 64, 16), (20000, 256, 16), (701, 64, 32), (997, 48, 8),
    (250, 64, 16), (13, 8, 8), (9, 9, 8), (100, 1, 16)])
def test_cluster_selection_mirror_matches_stable_topk(Ex, k, nwarps, C):
    """A cluster of C blocks a row (Ex not a multiple of C, fewer exits
    than C * 32, blocks of 8-32 warps): the mirror's order is the stable
    top-k's on rows of ties, rows whose ties straddle every block edge
    and the 2M-th place, and rows nearly all LOG_ZERO."""
    rng = np.random.default_rng(Ex * C + k)
    rows = list(tie_rows(rng, Ex, k))
    edges = sorted({min(max(r * Ex // C + o, 0), Ex - 1)
                    for r in range(C) for o in (-2, -1, 0, 1)})
    sparse = np.full(Ex, LOG_ZERO, np.float32)
    sparse[edges] = -3.0
    flat = np.full(Ex, -7.0, np.float32)
    flat[edges[::3]] = -1.0
    straddle = rng.integers(-9, 0, Ex).astype(np.float32)
    straddle[edges] = -4.0
    for sc in rows + [sparse, flat, straddle]:
        _, want = we.topk_stable(torch.from_numpy(sc), k)
        assert np.array_equal(mirror_top(sc, k, C, nwarps), want.numpy())


def test_radix_select_stops_on_a_whole_bin():
    """The select ends after the pass whose k-th bin is taken whole, and
    its counts still say which keys are taken: k keys in a high bin over
    a spread of low ones stop after one pass; the middle one of 3000
    neighbouring floats (keys one apart) needs all four."""
    rng = np.random.default_rng(3)
    sc = rng.integers(-900, -100, 4000).astype(np.float32)
    sc[rng.choice(4000, 64, replace=False)] = 3.0e6
    kth, rem, n_gt, n_eq, passes = radix_select(ord_key(sc), 64, 4)
    assert passes == 1 and rem == 0 and n_gt.sum() == 64
    assert np.array_equal(mirror_top(sc, 64, 4),
                          we.topk_stable(torch.from_numpy(sc), 64)[1].numpy())
    d = (np.float32(1.0) + np.arange(3000, dtype=np.float32)
         * np.float32(2.0 ** -23)).astype(np.float32)
    assert len(np.unique(ord_key(d))) == 3000
    assert radix_select(ord_key(rng.permutation(d)), 1500)[4] == 4


def test_rank_mirror_is_a_stable_descending_order():
    """One ranking by (corrected key, key, -exit) over the selected
    records gives the plain version's two stable sorts (the top k by
    score, then the top m of them by corrected score), with equal
    corrected scores, whichever C-th of the records a block ranks."""
    rng = np.random.default_rng(2)
    for Ex, k, limit in ((300, 1, 1), (300, 2, 1), (900, 64, 32),
                         (3000, 256, 128), (700, 40, 32), (60, 60, 32)):
        sc = rng.integers(-30, 3, Ex).astype(np.float32)
        sc[rng.random(Ex) < 0.3] = LOG_ZERO
        sc1, sel = we.topk_stable(torch.from_numpy(sc), k)
        corr = rng.integers(-20, 3, k).astype(np.float32)
        corr[rng.random(k) < 0.3] = LOG_ZERO
        _, order = we.topk_stable(torch.from_numpy(corr), min(limit, k))
        want = sel.numpy()[order.numpy()]
        perm = rng.permutation(k)         # the slots' order is the atomics'
        taken = sel.numpy()[perm]
        hi, lo = records(ord_key(sc1.numpy()[perm]), taken, corr[perm])
        for C in (1, 2, 4, 8):
            got = {}
            for r in range(C):
                got.update(rank_records(hi, lo, r * k // C,
                                        (r + 1) * k // C, limit))
            assert np.array_equal([taken[got[p]] for p in range(len(got))],
                                  want)


def test_winner_mirror_is_the_first_maximum():
    """The kernel's winner (the valid record of the largest rank key, if
    its rank is below m, else slot 0) equals scalar_entry_batched on the
    atoms in rank order: rows with and without valid atoms, valid atoms
    past m, and ties in the corrected score."""
    rng = np.random.default_rng(5)
    for trial in range(40):
        k, m = int(rng.integers(1, 40)), int(rng.integers(1, 24))
        m_eff = min(m, k)
        corr = rng.integers(-6, 0, k).astype(np.float32)
        corr[rng.random(k) < 0.3] = LOG_ZERO
        word = np.where(rng.random(k) < 0.3, -1, rng.integers(0, 50, k))
        if trial % 5 == 0:
            word[:] = -1
        keys = rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32)
        idx = rng.permutation(5 * k)[:k]
        hi, lo = records(keys, idx, corr)
        ranked = rank_records(hi, lo, 0, k, k)
        order = [ranked[p] for p in range(k)][:m_eff]
        valid = (corr > we.NEG_HALF) & (word >= 0)
        best = [s for s in range(k) if valid[s]]
        if best:
            bs = max(best, key=lambda s: (int(hi[s]), int(lo[s])))
            n = int(((hi > hi[bs]) | ((hi == hi[bs]) & (lo > lo[bs]))).sum())
        got = (n, corr[bs]) if best and n < m_eff else (0, LOG_ZERO)
        sc = np.full(m, LOG_ZERO, np.float32)
        sc[:m_eff] = corr[order]
        wd = np.full(m, -1, np.int64)
        wd[:m_eff] = np.where(corr[order] > we.NEG_HALF, word[order], -1)
        atoms = we.Trellis(*[torch.from_numpy(x)[None] for x in (
            wd.astype(np.int32), sc, np.zeros(m, np.float32),
            np.zeros(m, np.int32), np.zeros(m, np.int32),
            np.zeros(m, np.int32))])
        ent, _, eprev = we.scalar_entry_batched(atoms, 1, m)
        assert (int(eprev[0]), float(ent[0])) == (got[0], float(got[1]))


@pytest.mark.parametrize("B,Ex", [(16, 5000), (64, 5000), (1, 5000),
                                  (32, 20000), (8, 20000), (1, 20000),
                                  (4, 5000), (16, 118), (1, 600), (2, 40),
                                  (132, 9000), (200, 5000)])
def test_cluster_plan(B, Ex):
    """At the paths' recorded (B, Ex) and beside them: C of 1, 2, 4, 8;
    B * C at most the card's 132 SMs; every block walks at least
    MIN_BLOCK_EXITS exits (so C = 1 below C * 32 exits); 512 threads in
    a cluster, 1024 alone; the largest such C."""
    C, threads = we.cluster_plan(B, Ex)
    assert C in (1, 2, 4, 8)
    assert threads == (512 if C > 1 else 1024)
    if C > 1:
        assert B * C <= we.SMS and Ex >= C * we.MIN_BLOCK_EXITS >= C * 32
    bigger = [c for c in (2, 4, 8) if c > C and B * c <= we.SMS
              and Ex >= c * we.MIN_BLOCK_EXITS]
    assert not bigger
    if Ex < C * 32 or B * 2 > we.SMS:
        assert C == 1


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
