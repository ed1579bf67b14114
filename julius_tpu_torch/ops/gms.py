"""Gaussian Mixture Selection (GMS) scoring (-gshmm / -gsnum).

Port of `julius_tpu/ops/gms.py` (reference `libsent/src/phmm/gms.c`,
`gms_gprune.c` and the `mkgshmm` tool).  A small monophone "GS" model
is scored every frame; senones whose GS state ranks in the frame's top
`gsnum` get their full mixture score, the others take their GS state's
score (`gms.c:34-63`; the reference compiles GS score normalisation
out, `gms.c:74`).  Both scorers are dense (ops/gmm.py) and the blend is
a gather and a `torch.where`, so GMS here is a semantics option, not a
speed-up: the output values are the reference's.

The senone -> GS-state map mirrors `build_state2gs` (`gms.c:120-162`):
each state of every (tri)phone maps to the same state position of the
GS monophone with the matching center name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from julius_tpu_torch.models.hmm import HMMSet, center_name
from julius_tpu_torch.ops.gmm import (GMMScorerTables, build_gmm_tables,
                                      senone_scores)
from julius_tpu_torch.utils.jlog import LogLevel, jlog


@dataclass
class GMSTables:
    """GS scorer + senone -> GS-state map."""

    gs: GMMScorerTables          # monophone selector model tables
    state2gs: torch.Tensor       # [S] int64 GS state id, -1 unmapped
    gsnum: int = 24

    @property
    def n_gs_states(self) -> int:
        return self.gs.n_states


def build_gms(hmm: HMMSet, gs_hmm: HMMSet, gsnum: int = 24,
              device="cuda") -> GMSTables:
    """GMS tables for `hmm` with the monophone selector model `gs_hmm`
    (the -gshmm file, produced by mkgshmm)."""
    state2gs = np.full(hmm.n_states, -1, dtype=np.int64)
    n_miss = 0
    for p, name in enumerate(hmm.phone_names):
        g = gs_hmm.phone_index.get(center_name(name))
        if g is None:
            n_miss += 1
            continue
        gs_states = gs_hmm.phone_states[g][: gs_hmm.phone_ns[g]]
        for j in range(hmm.phone_ns[p]):
            st = hmm.phone_states[p][j]
            if st < 0:
                continue
            state2gs[st] = gs_states[min(j, len(gs_states) - 1)]
    if n_miss:
        jlog(LogLevel.WARNING,
             f"GMS: {n_miss} phones have no GS monophone; their states "
             "always score fully")
    return GMSTables(gs=build_gmm_tables(gs_hmm, device=device),
                     state2gs=torch.as_tensor(state2gs, device=device),
                     gsnum=gsnum)


def gms_senone_scores(tables: GMMScorerTables, gms: GMSTables,
                      x: torch.Tensor, topk: int = 0) -> torch.Tensor:
    """[..., D] frames -> [..., S] senone scores with GMS mixing.

    Every frame: rank the GS states, score fully the senones whose GS
    state is in the top gsnum (the k-th value from a stable descending
    sort; ties at it are all selected), give the others their GS state's
    score (gms.c:42-63).  Unmapped senones always score fully.  The
    engine builds the pseudo set-state columns over these mixed scores,
    as the reference's outprob_cd runs over GMS-gated outprob_state."""
    full = senone_scores(tables, x, topk=topk)          # [..., S]
    gs_sc = senone_scores(gms.gs, x)                    # [..., Sg]
    k = min(gms.gsnum, gs_sc.shape[-1])
    kth = gs_sc.sort(dim=-1, descending=True,
                     stable=True).values[..., k - 1:k]
    selected = gs_sc >= kth                             # [..., Sg]
    s2g = gms.state2gs.clamp_min(0)
    use_full = torch.where(gms.state2gs >= 0,
                           selected.index_select(-1, s2g), True)
    return torch.where(use_full, full, gs_sc.index_select(-1, s2g))
