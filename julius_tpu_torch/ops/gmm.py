"""Pseudo-phone-set output probabilities (cross-word context sets).

Port of `julius_tpu/ops/gmm.py` `aggregate_pseudo`, XLA segment
reductions in the reference, plain PyTorch here.  A word-edge node whose
context is unknown at network build time scores a "pseudo set-state",
an aggregate of the senones of every physical triphone that fits its
partial context (models/hmm.py `PseudoPhoneSets`); the engine appends
these columns after the senone columns of the outprob cache.

The GMM scorer (`gauss_scores`, `senone_scores`) joins this module with
ROADMAP.md queue 1, GMM/GMS.
"""

from __future__ import annotations

import torch

from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2

#: bytes of gathered member scores one chunk of rows may hold
CHUNK_BYTES = 256 << 20


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """[c, L] -> [c, n] max of each row over the members of each segment
    seg [L] (-inf for an empty one, as jax.ops.segment_max gives)."""
    out = x.new_full((x.shape[0], n), float("-inf"))
    return out.scatter_reduce_(1, seg.expand_as(x), x, reduce="amax",
                               include_self=True)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = x.new_zeros((x.shape[0], n))
    return out.scatter_add_(1, seg.expand_as(x), x)


def _aggregate_rows(x: torch.Tensor, seg: torch.Tensor, n: int,
                    scheme: str, nbest: int) -> torch.Tensor:
    """Member scores [c, L] (members grouped by set-state, in order) ->
    set-state scores [c, n]."""
    if scheme == "avg":
        ok = x > NEG_HALF
        s = _segment_sum(torch.where(ok, x, 0.0), seg, n)
        c = _segment_sum(ok.to(x.dtype), seg, n)
        return torch.where(c > 0, s / c.clamp(min=1.0), LOG_ZERO)
    if scheme == "best" and nbest > 1:
        # peel-max: nbest rounds of segment max, each round removing every
        # member at or above its set-state's max (exact ties go together)
        s = x.new_zeros((x.shape[0], n))
        c = x.new_zeros((x.shape[0], n))
        for _ in range(nbest):
            m = _segment_max(x, seg, n)
            has = m > NEG_HALF
            s = s + torch.where(has, m, 0.0)
            c = c + has.to(x.dtype)
            x = torch.where(x >= m.index_select(1, seg), LOG_ZERO, x)
        return torch.where(c > 0, s / c.clamp(min=1.0), LOG_ZERO)
    return _segment_max(x, seg, n)           # "max" (and best-1)


def aggregate_pseudo(members: torch.Tensor, segids: torch.Tensor,
                     n_pseudo: int, senone: torch.Tensor,
                     scheme: str = "best", nbest: int = 3) -> torch.Tensor:
    """Aggregate senone scores into pseudo-set-state scores (reference
    outprob_cd, libsent/src/phmm/outprob.c:287-420; scheme selected by
    -iwcd1):

      max  - max over member states (outprob_cd_max)
      avg  - arithmetic mean of the finite member log probs
             (> LOG_ZERO / 2; outprob_cd_avg)
      best - arithmetic mean of the top-nbest log probs
             (outprob_cd_nbest; nbest = 1 is max)

    members [L] senone ids grouped by set-state; segids [L] the set-state
    of each member (non-decreasing); senone [..., S] -> [..., n_pseudo].

    Rows are gathered in chunks whose [c, L] member scores stay within
    CHUNK_BYTES, as the reference does: all of them at once would be
    [B*T, L] floats, gigabytes at the 20k-word configuration."""
    S = senone.shape[-1]
    flat = senone.reshape(-1, S)
    N = flat.shape[0]
    L = int(members.shape[0])
    members = members.to(device=senone.device, dtype=torch.int64)
    seg = segids.to(device=senone.device, dtype=torch.int64)
    out = flat.new_empty((N, n_pseudo))
    C = max(1, min(N, CHUNK_BYTES // max(1, 4 * L)))
    for r0 in range(0, N, C):
        blk = flat[r0:r0 + C].index_select(1, members)       # [c, L]
        out[r0:r0 + C] = _aggregate_rows(blk, seg, n_pseudo, scheme, nbest)
    return out.reshape(*senone.shape[:-1], n_pseudo)
