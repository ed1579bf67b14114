"""The pass-2 word-scan kernel's order of work, held on the CPU.

`csrc/scan_win.cu` cannot run here, so this file keeps a numpy mirror
of what it does and holds it against the port's plain version
(`scan_core_win_plain`) and the reference's `_scan_core_win` on the
same inputs.  For chains with N + KL <= 32 and KL <= 3 the mirror
follows the warp-specialised template:
  - the gather warps stage each CHUNK-frame chunk's outprob block and
    seeds;
  - the recurrence warp carries (sc, e) a lane through the chunk, e the
    window index of the path's entry and -1 for (efr 0, sv LOG_ZERO);
    lanes past the chain hold (LOG_ZERO, -1), so shuffles wrap from
    them; it stages each frame's sc and e;
  - the argmax warp, a chunk behind, turns each frame's N staged scores
    into order-preserving u32 word-end keys, keeps the first maximum,
    and recovers efr and sv from the winner's e.
Other chains follow the block template: the first maximum every frame,
efr and sv recovered from e after the window.

The inputs are integer-valued and tie-heavy, with LOG_ZERO seed runs,
dead chains, and -0.0 word ends beside +0.0 ones.  Scores must agree
within atol 1e-5 (all three only add and compare floats) and entry
frames exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julius_tpu.search.scan import _scan_core_win
from julius_tpu_torch.ops import scan_kernel as tsk

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

LOG_ZERO = np.float32(-1e10)
NEG_HALF = np.float32(-0.5e10)
C = tsk.CHUNK
B, T, R = 2, 200, 40
SIGN = np.uint32(0x80000000)
LANES = 32                      # the recurrence warp
WS_MAX_K1 = 4                   # longer arc spans take the block template


def order_key(v):
    """The kernel's order_key: + 0.0 maps -0 to +0, then negative floats
    have every bit flipped and the others their sign bit set."""
    u = (np.asarray(v, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & SIGN, ~u, u | SIGN).astype(np.uint32)


def key_value(key):
    """The kernel's key_value, order_key's inverse."""
    key = np.asarray(key, np.uint32)
    return np.where(key & SIGN, key & ~SIGN, ~key).astype(
        np.uint32).view(np.float32)


def shift(x, j, fill):
    """x[:, n-j] along the node axis, `fill` where n-j < 0."""
    out = np.full_like(x, fill)
    out[:, j:] = x[:, :max(x.shape[1] - j, 0)]
    return out


def warp_schedule(loc, ent, ext, sidx, seed, out, bidx, t0):
    """The warp-specialised template (N + KL <= 32, KL <= 3), all chains:
    a chain is a CTA, axis 1 the recurrence warp's 32 lanes."""
    K, K1, N = loc.shape
    W = seed.shape[1]
    b = np.clip(bidx, 0, out.shape[0] - 1)
    # lanes past the chain: -inf tables, so they hold (LOG_ZERO, -1)
    # and a shuffle from lane (n - j) & 31 fills below lane j
    pad = LANES - N
    inf = np.float32(np.inf)
    l = np.concatenate([loc, np.full((K, K1, pad), -inf)], 2)
    en = np.concatenate([ent, np.full((K, pad), -inf)], 1)
    src = [(np.arange(LANES) - j) & (LANES - 1) for j in range(K1)]
    sc = np.full((K, LANES), LOG_ZERO, np.float32)
    e = np.full((K, LANES), -1, np.int32)
    g = np.zeros((K, W), np.float32)
    beg = np.zeros((K, W), np.int32)
    sv = np.zeros((K, W), np.float32)
    for i0 in range(0, W, C):
        nf = min(C, W - i0)
        # gather warps: the chunk's outprob block and seeds into a stage
        t = np.clip(t0[:, None] + i0 + np.arange(nf), 0,
                    out.shape[1] - 1)
        block = np.zeros((K, nf, LANES), np.float32)
        block[..., :N] = out[b[:, None, None], t[:, :, None],
                             sidx[:, None, :]]
        seeds = seed[:, i0:i0 + nf]
        # recurrence warp: (sc, e) into the state stage, frame by frame
        st_sc = np.zeros((K, nf, LANES), np.float32)
        st_e = np.zeros((K, nf, LANES), np.int32)
        for u in range(nf):
            ent_t = seeds[:, u:u + 1] + en
            mx = sc + l[:, 0]
            top = np.maximum(mx, ent_t)
            enter = ent_t > mx
            we = e
            for j in range(1, K1):
                c = sc[:, src[j]] + l[:, j]
                hit = c > mx
                we = np.where(hit, e[:, src[j]], we)
                mx = np.where(hit, c, mx)
                top = np.maximum(top, c)
                enter = enter & (ent_t > c)
            sc = np.where(top > NEG_HALF, top + block[:, u],
                          LOG_ZERO).astype(np.float32)
            e = np.where(enter, np.int32(i0 + u), we).astype(np.int32)
            st_sc[:, u], st_e[:, u] = sc, e
        # argmax warp, a chunk behind: lane u walks frame u's N word-end
        # keys keeping the first maximum
        best = np.zeros((K, nf), np.uint32)
        bn = np.zeros((K, nf), np.int64)
        for n in range(N):
            v = st_sc[:, :, n]
            key = order_key(np.where(v > NEG_HALF, v + ext[:, n:n + 1],
                                     LOG_ZERO))
            hit = key > best
            best = np.where(hit, key, best)
            bn = np.where(hit, n, bn)
        we = np.take_along_axis(st_e, bn[..., None], 2)[..., 0]
        g[:, i0:i0 + nf] = key_value(best)
        beg[:, i0:i0 + nf] = np.where(we < 0, 0, t0[:, None] + we)
        sv[:, i0:i0 + nf] = np.where(
            we < 0, LOG_ZERO,
            np.take_along_axis(seed, np.maximum(we, 0), 1))
    return g, beg, sv


def block_schedule(loc, ent, ext, sidx, seed, out, bidx, t0):
    """The block template (the other chains): one thread a node, the
    first maximum taken every frame, entry frames and seeds recovered
    from the winners' entry indices after the window."""
    K, K1, N = loc.shape
    W = seed.shape[1]
    b = np.clip(bidx, 0, out.shape[0] - 1)
    sc = np.full((K, N), LOG_ZERO, np.float32)
    e = np.full((K, N), -1, np.int32)
    g = np.zeros((K, W), np.float32)
    win_e = np.zeros((K, W), np.int32)
    rows = np.arange(K)
    for i in range(W):
        t = np.clip(t0 + i, 0, out.shape[1] - 1)
        o = out[b[:, None], t[:, None], sidx]
        mx, we = sc + loc[:, 0], e
        for j in range(1, K1):
            c = shift(sc, j, LOG_ZERO) + loc[:, j]
            hit = c > mx
            we = np.where(hit, shift(e, j, -1), we)
            mx = np.where(hit, c, mx)
        ent_t = seed[:, i:i + 1] + ent
        enter = ent_t > mx
        base = np.maximum(ent_t, mx)
        sc = np.where(base > NEG_HALF, base + o,
                      LOG_ZERO).astype(np.float32)
        e = np.where(enter, np.int32(i), we).astype(np.int32)
        endv = np.where(sc > NEG_HALF, sc + ext, LOG_ZERO)
        bn = np.zeros(K, np.int64)
        for n in range(1, N):
            bn = np.where(endv[:, n] > endv[rows, bn], n, bn)
        g[:, i] = endv[rows, bn]
        win_e[:, i] = e[rows, bn]
    beg = np.where(win_e < 0, 0, t0[:, None] + win_e)
    sv = np.where(win_e < 0, LOG_ZERO,
                  np.take_along_axis(seed, np.maximum(win_e, 0), 1))
    return g, beg, sv


def kernel_mirror(*arrays):
    """The kernel's order of work, on the template its launcher picks."""
    K, K1, N = arrays[0].shape
    if N + K1 - 1 <= LANES and K1 <= WS_MAX_K1:
        return warp_schedule(*arrays)
    return block_schedule(*arrays)


def tie_heavy_inputs(seed, K, W, N, K1):
    """Integer-valued tables, outprobs and seeds: shifted arcs, entries
    and word ends tie.  Every fifth chain is dead (all LOG_ZERO), seeds
    hold a LOG_ZERO run, a third of the windows end at the last frame,
    and chains 1 and 2 enter at -0.0 through a -0.0 outprob column so
    that -0.0 word ends meet +0.0 ones."""
    rng = np.random.default_rng(seed)
    loc = rng.integers(-2, 1, (K, K1, N)).astype(np.float32)
    loc[rng.random(loc.shape) < 0.2] = LOG_ZERO
    ent = rng.integers(-3, 1, (K, N)).astype(np.float32)
    ent[rng.random(ent.shape) < 0.6] = LOG_ZERO
    ext = rng.integers(-1, 1, (K, N)).astype(np.float32)
    ext[rng.random(ext.shape) < 0.3] = LOG_ZERO
    sidx = rng.integers(0, R - 1, (K, N)).astype(np.int32)
    seed_w = rng.integers(-60, -20, (K, W)).astype(np.float32)
    seed_w[rng.random((K, W)) < 0.6] = LOG_ZERO
    seed_w[:, 3:9] = LOG_ZERO
    out = rng.integers(-4, 3, (B, T, R)).astype(np.float32)
    out[..., R - 1] = -0.0
    for k in (1, 2):
        seed_w[k, rng.random(W) < 0.5] = -0.0
        ent[k, 0], ext[k, 0], sidx[k, 0] = -0.0, -0.0, R - 1
        if N > 1:
            ent[k, 1], ext[k, 1], sidx[k, 1] = 0.0, -0.0, R - 1
    for a in (loc, ent, ext):
        a[::5] = LOG_ZERO
    bidx = rng.integers(0, B, K).astype(np.int32)
    t0 = rng.integers(0, T - W + 1, K).astype(np.int32)
    t0[1::3] = T - W
    return loc, ent, ext, sidx, seed_w, out, bidx, t0


@pytest.mark.parametrize("W", [1, C - 1, C + 1, 160])
@pytest.mark.parametrize("KL", [0, 1, 3])
@pytest.mark.parametrize("N", [1, 21, 32, 45])
def test_kernel_schedule_matches_plain_and_reference(N, KL, W):
    K = 12
    arrays = tie_heavy_inputs(N * 1000 + KL * 100 + W, K, W, N, KL + 1)
    loc, ent, ext, sidx, seed_w, out, bidx, t0 = arrays
    got = kernel_mirror(*arrays)
    wants = [[a.numpy() for a in tsk.scan_core_win_plain(
        *(torch.from_numpy(a) for a in arrays))]]
    # the reference's shift takes no arc span past the chain (no chain
    # table holds one); the kernel and the plain version fill LOG_ZERO
    if KL < N:
        tc = np.clip(t0[:, None] + np.arange(W), 0, T - 1)
        outw = out[bidx[:, None, None], tc[:, :, None], sidx[:, None, :]]
        wants.append([np.asarray(a) for a in _scan_core_win(
            jnp.asarray(loc), jnp.asarray(ent), jnp.asarray(ext),
            jnp.asarray(seed_w), jnp.asarray(outw), jnp.asarray(t0))])
    for want in wants:
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    assert (got[0][::5] == LOG_ZERO).all()           # dead chains
    assert (got[0] > NEG_HALF).any()                 # live word ends


def test_order_key_orders_floats():
    """order_key is monotone on ±0, -inf, LOG_ZERO, NEG_HALF, subnormals
    and normals, ties -0 with +0, and key_value inverts it."""
    tiny = np.finfo(np.float32).smallest_subnormal
    vals = np.array([-np.inf, LOG_ZERO, NEG_HALF, -1.0, -1e-30, -tiny,
                     -0.0, 0.0, tiny, 2 * tiny,
                     np.finfo(np.float32).tiny * 0.5,
                     np.finfo(np.float32).tiny, 1.0, 3e38, np.inf],
                    np.float32)
    keys = order_key(vals)
    for a, ka in zip(vals, keys):
        for b, kb in zip(vals, keys):
            assert (ka > kb) == (a > b) and (ka == kb) == (a == b), (a, b)
    back = key_value(keys)
    np.testing.assert_array_equal(back, vals)
    assert not np.signbit(back[vals == 0]).any()     # -0 comes back +0
