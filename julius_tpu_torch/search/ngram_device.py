"""Device-resident N-gram tables with O(1) hashed lookup (torch).

Port of `julius_tpu/search/ngram_device.py`.  The host-side table build
(open addressing, linear probing, every probe chain bounded by
`MAX_PROBES`) is a copy, so both packages build bit-identical tables;
the lookups run on torch tensors.  Keys pack (context, word) into 32
bits while n_words <= 65535 and switch to two-column (v, w) keys above.

The reference hashes in uint32 with wrap-around.  torch does not
implement `>>` or `%` for uint32 on the CPU, so the hash runs in int64
masked to 32 bits, with each 32x32-bit product split into 16-bit halves
so no intermediate leaves int64.  Table keys live in int32 bit
patterns (`bi_rows`): keys are read back with `& 0xFFFFFFFF` and values
by reinterpreting the bits as float32.

Probabilities stay log10 as in the ARPA file.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from julius_tpu_torch.io.arpa import NGramLM
from julius_tpu_torch.utils.logadd import LOG_ZERO

MAX_PROBES = 8      # hard bound enforced at build time (table grows until
                    # every linear-probe chain fits) so a lookup is ONE
                    # [.., P] gather + compare, not a sequential loop
EMPTY_KEY = np.uint32(0xFFFFFFFF)
U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1     # pair-mix multiplier (host and device)


def _hash_u32_np(k: np.ndarray) -> np.ndarray:
    """Murmur3-style avalanche on uint32 (numpy wrap-around)."""
    k = k.astype(np.uint32).copy()
    k ^= k >> np.uint32(16)
    k *= np.uint32(0x85EBCA6B)
    k ^= k >> np.uint32(13)
    k *= np.uint32(0xC2B2AE35)
    k ^= k >> np.uint32(16)
    return k


def _mul_u32(k: torch.Tensor, c: int) -> torch.Tensor:
    """(k * c) mod 2^32 for int64 k in [0, 2^32): the product is split
    into c's 16-bit halves so every intermediate stays below 2^49."""
    lo = k * (c & 0xFFFF)
    hi = ((k * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _hash_u32(k: torch.Tensor) -> torch.Tensor:
    """Torch mirror of `_hash_u32_np`: int64 in, int64 in [0, 2^32) out."""
    k = k.to(torch.int64) & U32
    k = k ^ (k >> 16)
    k = _mul_u32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul_u32(k, 0xC2B2AE35)
    return k ^ (k >> 16)


def _build_hash(keys: np.ndarray, vals: np.ndarray):
    """Host-side open-addressing insert (linear probing).  Grows the
    table until every probe chain fits in MAX_PROBES so device lookups
    are a single vectorised gather."""
    n = max(16, int(2 ** np.ceil(np.log2(max(1, len(keys)) * 2))))
    h0 = _hash_u32_np(keys)
    while True:
        mask = n - 1
        tk = np.full(n, EMPTY_KEY, dtype=np.uint32)
        tv = np.zeros(n, dtype=np.float32)
        ok = True
        for i in range(len(keys)):
            slot = int(h0[i]) & mask
            p = 0
            while tk[slot] != EMPTY_KEY:
                slot = (slot + 1) & mask
                p += 1
                if p >= MAX_PROBES:
                    ok = False
                    break
            if not ok:
                break
            tk[slot] = keys[i]
            tv[slot] = vals[i]
        if ok:
            return tk, tv
        n *= 2


def _build_hash_wide(kv: np.ndarray, kw: np.ndarray, vals: np.ndarray):
    """Two-column (v, w) open-addressing insert for vocabularies past
    the 16-bit packing limit; the same bounded-probe guarantee as
    `_build_hash`."""
    n = max(16, int(2 ** np.ceil(np.log2(max(1, len(kv)) * 2))))
    h0 = _hash_u32_np(_hash_u32_np(kv)
                      ^ (kw.astype(np.uint32) * np.uint32(GOLDEN)))
    while True:
        mask = n - 1
        tv_ = np.full(n, EMPTY_KEY, dtype=np.uint32)   # v key column
        tw_ = np.zeros(n, dtype=np.uint32)             # w key column
        tp = np.zeros(n, dtype=np.float32)
        ok = True
        for i in range(len(kv)):
            slot = int(h0[i]) & mask
            p = 0
            while tv_[slot] != EMPTY_KEY:
                slot = (slot + 1) & mask
                p += 1
                if p >= MAX_PROBES:
                    ok = False
                    break
            if not ok:
                break
            tv_[slot] = kv[i]
            tw_[slot] = kw[i]
            tp[slot] = vals[i]
        if ok:
            return tv_, tw_, tp
        n *= 2


@dataclass
class DeviceNgram:
    """Hashed 2-gram (pass-1) tables on one device."""

    uni: torch.Tensor        # [V] f32 log10 P1(w), LOG_ZERO for absent
    bo_uni: torch.Tensor     # [V] f32 log10 back-off weight of (w)
    # [H, 2] int32 rows (key bits, value bits); wide mode [H, 3]
    # (v key, w key, value bits): one row gather per probe
    bi_rows: torch.Tensor
    n_words: int
    bos_id: int
    eos_id: int
    unk_id: int
    wide: bool = False       # True: two-column (v, w) keys


def device_ngram_from_numpy(uni, bo_uni, bi_rows, n_words: int,
                            bos_id: int, eos_id: int, unk_id: int,
                            wide: bool, device) -> DeviceNgram:
    """DeviceNgram from host arrays (uni/bo_uni f32 [V], bi_rows int32)."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    rows = torch.from_numpy(np.asarray(bi_rows).view(np.int32).copy())
    return DeviceNgram(uni=f32(uni), bo_uni=f32(bo_uni),
                       bi_rows=rows.to(device), n_words=int(n_words),
                       bos_id=int(bos_id), eos_id=int(eos_id),
                       unk_id=int(unk_id), wide=bool(wide))


def build_device_ngram(lm: NGramLM, device, force_wide: bool = False
                       ) -> DeviceNgram:
    V = lm.n_words
    wide = force_wide or V > 65535
    uni = np.full(V, LOG_ZERO, dtype=np.float32)
    bo = np.zeros(V, dtype=np.float32)
    for (w,), (p, b) in lm.ngrams[0].items():
        uni[w] = p
        bo[w] = b
    if lm.order >= 2 and lm.ngrams[1]:
        items = list(lm.ngrams[1].items())
        ctx = np.asarray([c[0] for c, _ in items], dtype=np.uint32)
        tgt = np.asarray([c[1] for c, _ in items], dtype=np.uint32)
        vals = np.asarray([p for _, (p, _) in items], dtype=np.float32)
    else:
        ctx = np.zeros(0, dtype=np.uint32)
        tgt = np.zeros(0, dtype=np.uint32)
        vals = np.zeros(0, dtype=np.float32)
    if wide:
        tv_, tw_, tp = _build_hash_wide(ctx, tgt, vals)
        rows = np.stack([tv_.view(np.int32), tw_.view(np.int32),
                         tp.view(np.int32)], axis=1)
    else:
        keys = ctx * np.uint32(V) + tgt
        tk, tv = _build_hash(keys, vals)
        rows = np.stack([tk.view(np.int32), tv.view(np.int32)], axis=1)
    return device_ngram_from_numpy(uni, bo, rows, V, lm.bos_id, lm.eos_id,
                                   lm.unk_id, wide, device)


def _probe_rows(ng: DeviceNgram, slot: torch.Tensor) -> torch.Tensor:
    """[..., P, 2 or 3] table rows of the probe chain starting at slot."""
    H = ng.bi_rows.shape[0]
    steps = torch.arange(MAX_PROBES, device=slot.device)
    return ng.bi_rows[(slot[..., None] + steps) & (H - 1)]


def hash_lookup(ng: DeviceNgram, query: torch.Tensor):
    """Narrow-key probe: query [...] packed keys in [0, 2^32) ->
    (found mask, log10 values; 0 where not found)."""
    H = ng.bi_rows.shape[0]
    rows = _probe_rows(ng, _hash_u32(query) & (H - 1))
    keys = rows[..., 0].to(torch.int64) & U32
    hit = keys == query[..., None]
    vals = torch.where(hit, rows[..., 1].view(torch.float32), 0.0)
    return hit.any(dim=-1), vals.sum(dim=-1)


def bigram_score_fast(ng: DeviceNgram, v_lm: torch.Tensor,
                      v_bo: torch.Tensor, w_lm: torch.Tensor,
                      uni_w: torch.Tensor) -> torch.Tensor:
    """log10 P(w | v) when the caller already holds the per-query
    unigram (`uni_w` = uni[w]) and context back-off (`v_bo` =
    bo_uni[v]): one [.., P, 2] (narrow) / [.., P, 3] (wide) row gather
    and no other table lookups.  v_lm < 0 means no context (unigram)."""
    vq = v_lm.to(torch.int64).clamp(min=0)
    wq = w_lm.to(torch.int64).clamp(min=0)
    H = ng.bi_rows.shape[0]
    if ng.wide:
        h = _hash_u32(vq) ^ _mul_u32(wq, GOLDEN)
        rows = _probe_rows(ng, _hash_u32(h) & (H - 1))
        kv = rows[..., 0].to(torch.int64) & U32
        kw = rows[..., 1].to(torch.int64) & U32
        vals = rows[..., 2].view(torch.float32)
        hit = (kv == vq[..., None]) & (kw == wq[..., None])
    else:
        key = (vq * ng.n_words + wq) & U32
        rows = _probe_rows(ng, _hash_u32(key) & (H - 1))
        keys = rows[..., 0].to(torch.int64) & U32
        vals = rows[..., 1].view(torch.float32)
        hit = keys == key[..., None]
    found = hit.any(dim=-1)
    p = torch.where(hit, vals, 0.0).sum(dim=-1)
    out = torch.where(found, p, v_bo + uni_w)
    return torch.where(v_lm < 0, uni_w, out)


def bigram_score(ng: DeviceNgram, v: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """log10 P(w | v) with Katz back-off (exact 2-gram).

    v, w broadcastable integer tensors; invalid v (< 0) falls back to
    the unigram (the start-of-sentence virtual context)."""
    vq = v.to(torch.int64).clamp(min=0)
    w = w.to(torch.int64)
    if ng.wide:
        vb, wb = torch.broadcast_tensors(vq, w)
        return bigram_score_fast(ng, torch.where(v < 0, -1, vb),
                                 ng.bo_uni[vb], wb, ng.uni[wb])
    found, p = hash_lookup(ng, (vq * ng.n_words + w) & U32)
    out = torch.where(found, p, ng.bo_uni[vq] + ng.uni[w])
    return torch.where(v < 0, ng.uni[w], out)
