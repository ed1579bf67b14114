"""GMM acoustic scoring and pseudo-phone-set output probabilities.

Port of `julius_tpu/ops/gmm.py`, XLA in the reference, plain PyTorch
here.  A diagonal Gaussian's log density is

    log N(x; mu, diag sigma^2) = c_g + x . a_g - (x*x) . half_iv_g

with a_g = mu_g * iv_g, half_iv_g = iv_g / 2 and c_g = -(gconst_g +
sum(mu_g^2 iv_g)) / 2, so every Gaussian of a batch of frames is one
full-f32 product [B*T, 2D] x [2D, G] of [x, x*x] by the stacked table
[a; -half_iv], with c as its bias (`gauss_scores`; TF32 stays off).  A
senone's score is the log-sum-exp over its mixture of the gathered
Gaussian scores plus log weights, optionally over its top-k components
only (`gprune`, `senone_scores`); tied-mixture codebooks are shared
Gaussian ids.  The gather runs over row chunks, as `aggregate_pseudo`
does: the [rows, S, M] mixture scores of a whole batch would be a
gigabyte at the flagship width.

A word-edge node whose context is unknown at network build time scores
a "pseudo set-state", an aggregate of the senones of every physical
triphone that fits its partial context (models/hmm.py
`PseudoPhoneSets`); the engine appends these columns after the senone
columns of the outprob cache with `aggregate_pseudo`, whatever scored
the senones.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.utils.device import full_f32_matmul
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2

#: bytes of gathered member (or mixture) scores one chunk of rows may hold
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


def chunk_rows(n_rows: int, n_members: int) -> int:
    """Rows of one chunk of `aggregate_pseudo`: as many as keep its
    [c, L] gathered member scores within CHUNK_BYTES."""
    return max(1, min(n_rows, CHUNK_BYTES // max(1, 4 * n_members)))


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
    C = chunk_rows(N, L)
    for r0 in range(0, N, C):
        blk = flat[r0:r0 + C].index_select(1, members)       # [c, L]
        out[r0:r0 + C] = _aggregate_rows(blk, seg, n_pseudo, scheme, nbest)
    return out.reshape(*senone.shape[:-1], n_pseudo)


@dataclass
class GMMScorerTables:
    """Constant tables of dense GMM scoring, on one device."""

    w: torch.Tensor          # [2D, G] [mu * iv; -0.5 * iv], transposed
    c: torch.Tensor          # [G]    -0.5*(gconst + sum(mu^2 iv))
    state_mix: torch.Tensor  # [S, M] int64 gaussian ids (pad: 0)
    state_lw: torch.Tensor   # [S, M] f32 log weights (pad: LOG_ZERO)

    @property
    def n_states(self) -> int:
        return self.state_mix.shape[0]


def gmm_tables_from_numpy(a, half_iv, c, state_mix, state_lw,
                          device) -> GMMScorerTables:
    """GMMScorerTables on `device` from the reference's host arrays: a
    and half_iv [D, G], c [G], state_mix / state_lw [S, M] (ids may come
    as any integer type)."""
    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    w = np.concatenate([np.asarray(a, np.float32),
                        -np.asarray(half_iv, np.float32)])
    return GMMScorerTables(
        w=f32(w), c=f32(c), state_mix=torch.tensor(
            np.asarray(state_mix, np.int64), device=device),
        state_lw=f32(state_lw))


def build_gmm_tables(hmm: HMMSet, device="cuda") -> GMMScorerTables:
    """The scorer's tables of `hmm` (products folded in float64, as the
    reference does)."""
    iv = hmm.ivars.astype(np.float64)
    mu = hmm.means.astype(np.float64)
    a = (mu * iv).T.astype(np.float32)
    half_iv = (0.5 * iv).T.astype(np.float32)
    c = (-0.5 * (hmm.gconst.astype(np.float64)
                 + np.sum(mu * mu * iv, axis=1))).astype(np.float32)
    mix = np.where(hmm.state_mix >= 0, hmm.state_mix, 0)
    return gmm_tables_from_numpy(a, half_iv, c, mix, hmm.state_lw, device)


def gauss_scores(tables: GMMScorerTables, x: torch.Tensor) -> torch.Tensor:
    """[..., D] frames -> [..., G] per-Gaussian log-likelihoods (one
    full-f32 product of [x, x*x] by the stacked table, c its bias)."""
    flat = x.reshape(-1, x.shape[-1])
    with full_f32_matmul():
        g = torch.addmm(tables.c, torch.cat([flat, flat * flat], dim=-1),
                        tables.w)
    return g.reshape(*x.shape[:-1], g.shape[-1])


def mixture_scores(tables: GMMScorerTables, g: torch.Tensor,
                   topk: int = 0) -> torch.Tensor:
    """[..., G] Gaussian scores -> [..., S] senone scores: log-sum-exp of
    each state's gathered components plus log weights, floored at
    LOG_ZERO.  topk > 0 keeps only the components at or above each
    state's k-th best (gprune_beam's k-best log-add); the mask needs only
    the k-th value, which a stable descending sort gives.  Rows are
    gathered in chunks whose [c, S, M] scores stay within CHUNK_BYTES."""
    S, M = tables.state_mix.shape
    flat = g.reshape(-1, g.shape[-1])
    N = flat.shape[0]
    idx = tables.state_mix.reshape(-1)
    out = flat.new_empty((N, S))
    C = max(1, min(N, CHUNK_BYTES // max(1, 4 * S * M)))
    for r0 in range(0, N, C):
        mixed = flat[r0:r0 + C].index_select(1, idx).view(-1, S, M) \
            + tables.state_lw
        if topk and topk < M:
            kth = mixed.sort(dim=-1, descending=True,
                             stable=True).values[..., topk - 1:topk]
            mixed = torch.where(mixed >= kth, mixed, LOG_ZERO)
        out[r0:r0 + C] = torch.logsumexp(mixed, dim=-1).clamp_min(LOG_ZERO)
    return out.reshape(*g.shape[:-1], S)


def senone_scores(tables: GMMScorerTables, x: torch.Tensor,
                  topk: int = 0) -> torch.Tensor:
    """[..., D] frames -> [..., S] senone log output probabilities.
    topk > 0 emulates gprune_beam (reference gprune_beam.c); 0 sums every
    mixture component exactly."""
    return mixture_scores(tables, gauss_scores(tables, x), topk)
