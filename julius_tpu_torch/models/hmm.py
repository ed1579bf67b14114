"""Flattened acoustic-model structures, device-ready.

The reference keeps HTK HMMs as linked structs with name-keyed hash trees
(`libsent/include/sent/htk_hmm.h` HTK_HMM_INFO).  The TPU-native layout is
flat, padded numpy/jnp arrays:

  * one global pool of diagonal Gaussians (means / inverse variances /
    gconst) — tied-mixture codebooks fall out naturally as shared indices
    (reference calc_tied_mix.c semantics without the per-frame cache:
    the dense scorer computes everything each frame on the MXU);
  * senone (state) mixture tables padded to a fixed max-mixture count;
  * physical phone HMMs as [n_phones, max_states] senone-id matrices plus
    dense [N+2, N+2] natural-log transition matrices (HTK convention:
    row/col 0 = entry, 1..N = emitting, N+1 = exit);
  * logical name -> physical id map (HMMList,
    reference libsent/src/hmminfo/rdhmmlist.c), and pseudo-phone
    context-dependent sets for cross-word approximation (reference
    cdset.c / outprob_cd).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from julius_tpu_torch.utils.logadd import LOG_ZERO


@dataclass
class HMMSet:
    # Gaussian pool
    means: np.ndarray          # [G, D] f32
    ivars: np.ndarray          # [G, D] f32, 1/variance (diagonal)
    gconst: np.ndarray         # [G]   f32, log((2pi)^D prod var)
    # Senones (emitting states), single stream
    state_mix: np.ndarray      # [S, M] int32 gaussian id, -1 pad
    state_lw: np.ndarray       # [S, M] f32 natural-log mixture weight, LOG_ZERO pad
    state_sid: np.ndarray      # [S] int32 DNN output row (<SID>) or sequential id
    # Physical phone HMMs
    phone_states: np.ndarray   # [P, NSmax] int32 senone id, -1 pad
    phone_ns: np.ndarray       # [P] int32 number of emitting states
    phone_trans: np.ndarray    # [P, NSmax+2, NSmax+2] f32 ln transition, LOG_ZERO pad
    phone_names: List[str]
    phone_index: Dict[str, int]
    # Logical layer (HMMList): logical name -> physical phone id
    logical_map: Dict[str, int]
    # Feature params embedded/required by this AM
    veclen: int = 0
    param_kind: Optional[str] = None
    # multipath: True when any model can skip all emitting states (tee) or
    # has entry to multiple states (reference check_hmm_restriction.c)
    names_are_triphone: bool = True

    @property
    def n_gauss(self) -> int:
        return self.means.shape[0]

    @property
    def n_states(self) -> int:
        return self.state_mix.shape[0]

    @property
    def n_phones(self) -> int:
        return self.phone_states.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def max_mix(self) -> int:
        return self.state_mix.shape[1]

    @property
    def max_ns(self) -> int:
        return self.phone_states.shape[1]

    def phone(self, logical_name: str) -> int:
        """Resolve a logical phone name to a physical phone id."""
        pid = self.logical_map.get(logical_name)
        if pid is None:
            pid = self.phone_index.get(logical_name)
        if pid is None:
            raise KeyError(f"phone not in model: {logical_name}")
        return pid


def center_name(name: str) -> str:
    """Strip triphone context: 'a-b+c' -> 'b' (reference hmminfo/cdhmm.c
    center_name)."""
    s = name
    i = s.find("-")
    if i >= 0:
        s = s[i + 1:]
    j = s.find("+")
    if j >= 0:
        s = s[:j]
    return s


def leftcenter_name(name: str) -> str:
    """'a-b+c' -> 'a-b'."""
    j = name.find("+")
    return name[:j] if j >= 0 else name


def centerright_name(name: str) -> str:
    """'a-b+c' -> 'b+c'."""
    i = name.find("-")
    return name[i + 1:] if i >= 0 else name


def compose_triphone(left: Optional[str], base: str, right: Optional[str]) -> str:
    s = base
    if left:
        s = f"{left}-{s}"
    if right:
        s = f"{s}+{right}"
    return s


@dataclass
class PseudoPhoneSets:
    """Context-dependent pseudo phone sets for cross-word boundaries.

    A pseudo phone for a partial context name (e.g. 'a-b' or 'b+c' or 'b')
    is the set of all physical triphones matching that partial context; its
    per-position output probability is an aggregate (max by default) over the
    member states (reference libsent/src/hmminfo/cdset.c and
    libsent/src/phmm/outprob.c:287-420 outprob_cd).

    Flattened: pseudo "set-state" j aggregates senones
    ``members[member_ofs[j]:member_ofs[j+1]]``.  Scoring produces an
    extended score row: ``ext = concat(senone_scores, pseudo_scores)`` so
    lexicon nodes index one flat table.
    """

    name_index: Dict[str, int] = field(default_factory=dict)   # name -> set id
    set_ns: np.ndarray = None            # [Q] n emitting positions
    set_state_ofs: np.ndarray = None     # [Q] first set-state row
    # per set-state (position) aggregation over member senones
    members: np.ndarray = None           # [total_members] int32 senone ids
    member_ofs: np.ndarray = None        # [n_set_states + 1] int32
    # representative transition matrix per set (first member's)
    set_trans_phone: np.ndarray = None   # [Q] int32 physical phone id

    @property
    def n_sets(self) -> int:
        return 0 if self.set_ns is None else len(self.set_ns)

    @property
    def n_set_states(self) -> int:
        return 0 if self.member_ofs is None else len(self.member_ofs) - 1


def build_pseudo_sets(hmm: HMMSet, names: List[str]) -> PseudoPhoneSets:
    """Build pseudo sets for the given partial-context names.

    Members of a set for name ``n`` are all physical phones reachable from a
    logical name whose left/center or center/right projection equals ``n``
    (reference cdset.c:make_cdset / regist_cdset)."""
    # index physical phones by their projections
    proj_lc: Dict[str, List[int]] = {}
    proj_cr: Dict[str, List[int]] = {}
    proj_c: Dict[str, List[int]] = {}
    seen_phys: Dict[str, int] = {}
    all_logical = list(hmm.logical_map.items()) + [
        (n, i) for n, i in hmm.phone_index.items()
    ]
    for lname, pid in all_logical:
        key = (lname, pid)
        if key in seen_phys:
            continue
        seen_phys[key] = pid
        proj_lc.setdefault(leftcenter_name(lname), []).append(pid)
        proj_cr.setdefault(centerright_name(lname), []).append(pid)
        proj_c.setdefault(center_name(lname), []).append(pid)

    ps = PseudoPhoneSets()
    set_ns, set_ofs, set_tp = [], [], []
    members, member_ofs = [], [0]
    for name in names:
        if name in ps.name_index:
            continue
        if name in hmm.logical_map or name in hmm.phone_index:
            continue  # real phone exists; no pseudo set needed
        cands = None
        for proj in (proj_lc, proj_cr, proj_c):
            if name in proj:
                cands = sorted(set(proj[name]))
                break
        if not cands:
            continue
        ns = int(max(hmm.phone_ns[p] for p in cands))
        ps.name_index[name] = len(set_ns)
        set_ns.append(ns)
        set_ofs.append(len(member_ofs) - 1)
        set_tp.append(cands[0])
        for pos in range(ns):
            mem = sorted(
                {
                    int(hmm.phone_states[p, pos])
                    for p in cands
                    if pos < hmm.phone_ns[p] and hmm.phone_states[p, pos] >= 0
                }
            )
            if not mem:  # pad position with first member's last state
                mem = [int(hmm.phone_states[cands[0], hmm.phone_ns[cands[0]] - 1])]
            members.extend(mem)
            member_ofs.append(len(members))
    ps.set_ns = np.asarray(set_ns, dtype=np.int32)
    ps.set_state_ofs = np.asarray(set_ofs, dtype=np.int32)
    ps.set_trans_phone = np.asarray(set_tp, dtype=np.int32)
    ps.members = np.asarray(members, dtype=np.int32)
    ps.member_ofs = np.asarray(member_ofs, dtype=np.int32)
    return ps
