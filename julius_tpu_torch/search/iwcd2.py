"""Strict inter-word CD for the pass-2 re-scan (v2).

Copy of `julius_tpu/search/iwcd2.py` (host numpy), with the device
tables on a torch device.  The reference's "standard" build scans
pass-2 words with the word-head triphone resolved against the
hypothesis's adjacent word (`search_bestfirst_v2.c:492` do_viterbi /
`:817` do_viterbi_next_word / `:911` scan_word, compile flag
PASS2_STRICT_IWCD), where the "fast" build (v1) keeps the
left-context-free pseudo set for word heads.

The chain scan reads outprob columns through per-node `sidx` tables
(scan.DeviceChainTables).  Strict IWCD only changes the columns of the
FIRST phone's states, and only as a function of the left-context CLASS
(the preceding word's final base phone).  So v2 is one extra device
table

    head_sidx[V + 1, C, H] int32

(C = distinct word-final base phones + 1; class 0 = no context, keeping
the v1 pseudo columns) gathered per chain by (word, left-context class)
and substituted over the head states before the scan; the rest of the
scan is identical.  Resolution policy matches the reference fallback
chain (outprob_style.c lcdset handling): an exact physical triphone
`lc-p+r` wins; anything unresolvable keeps the v1 approximation.

`build_rc_tables` is the node-level view for pass 1's `head_rc_dynamic`
(search/pass1.py's per-context head emission rows).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import HMMSet, center_name, compose_triphone
from julius_tpu_torch.search.network import DecodeNetwork, word_phone_names


class StrictIWCDTables:
    """head_sidx [V+1, C, H] and head_ns [V+1] on the device, with the
    per-word left-context class `lc_of_word` [V+1] (host)."""

    def __init__(self, net: DecodeNetwork, hmm: HMMSet, voca: Vocabulary,
                 use_triphone: Optional[bool] = None, device="cpu"):
        if use_triphone is None:
            use_triphone = hmm.names_are_triphone
        V = net.n_words
        ofs = net.word_node_ofs
        # left-context classes = distinct final base phones over the
        # vocabulary; class 0 = "no context" (sentence start / fallback)
        finals = sorted({center_name(voca.phones[w][-1])
                         for w in range(V) if voca.phones[w]})
        self.class_of_phone = {p: i + 1 for i, p in enumerate(finals)}
        C = len(finals) + 1
        lc_of_word = np.zeros(V + 1, np.int32)
        for w in range(V):
            if voca.phones[w]:
                lc_of_word[w] = self.class_of_phone[
                    center_name(voca.phones[w][-1])]
        # head-phone spans and default columns
        H = 0
        head_ns = np.zeros(V + 1, np.int32)
        for w in range(V):
            names = word_phone_names(voca.phones[w], use_triphone)
            if not names:
                continue
            # first phone's nodes are the first ns nodes of the chain
            # (network.py appends phone states in order)
            kind_pid = _resolve(hmm, names[0])
            ns = (int(hmm.phone_ns[kind_pid]) if kind_pid is not None
                  else 0)
            ns = min(ns, int(ofs[w + 1] - ofs[w]))
            head_ns[w] = ns
            H = max(H, ns)
        head_sidx = np.zeros((V + 1, C, max(H, 1)), np.int32)
        n_resolved = 0
        for w in range(V):
            ns = int(head_ns[w])
            if ns == 0:
                continue
            n0 = int(ofs[w])
            default = net.score_idx[n0:n0 + ns]
            head_sidx[w, :, :ns] = default[None, :]
            phones = voca.phones[w]
            base = center_name(phones[0])
            right = center_name(phones[1]) if len(phones) > 1 else None
            if not use_triphone:
                continue
            for cname, ci in self.class_of_phone.items():
                tri = compose_triphone(cname, base, right)
                pid = hmm.logical_map.get(tri, hmm.phone_index.get(tri))
                if pid is None or int(hmm.phone_ns[pid]) != ns:
                    continue       # keep the v1 pseudo approximation
                head_sidx[w, ci, :ns] = hmm.phone_states[pid, :ns]
                n_resolved += 1
        self._install(head_sidx, head_ns, lc_of_word, n_resolved, device)

    def _install(self, head_sidx, head_ns, lc_of_word, n_resolved: int,
                 device) -> None:
        self.head_sidx_np = np.asarray(head_sidx, np.int32)
        self.head_ns_np = np.asarray(head_ns, np.int32)
        self.lc_of_word = np.asarray(lc_of_word, np.int32)
        self.n_resolved = int(n_resolved)
        self.H = int(self.head_ns_np.max()) if self.head_ns_np.size else 0
        self.head_sidx = torch.as_tensor(self.head_sidx_np, device=device)
        self.head_ns = torch.as_tensor(self.head_ns_np, device=device)
        self.lc_of_word_dev = torch.as_tensor(self.lc_of_word,
                                              dtype=torch.int64,
                                              device=device)

    @classmethod
    def from_numpy(cls, head_sidx, head_ns, lc_of_word, n_resolved: int,
                   device) -> "StrictIWCDTables":
        """Tables from host arrays (convert.py carries the reference's)."""
        self = cls.__new__(cls)
        self._install(head_sidx, head_ns, lc_of_word, n_resolved, device)
        return self


def build_rc_tables(net: DecodeNetwork, hmm: HMMSet, voca: Vocabulary,
                    use_triphone: Optional[bool] = None):
    """Node-level view of the strict head-context tables for PASS 1
    (reference outprob_style.c:354 per-last-word RC assignment with the
    per-node cache, wchmm.h:55-83): returns

        rc_head [N]      row into rc_sidx for word-head states (-1 =
                         emission column fixed at net.score_idx)
        rc_sidx [NH, C]  override outprob columns per left-context class
                         (class 0 = no context = the v1 pseudo column)
        lc_class [V]     word id -> left-context class of its final
                         base phone"""
    tabs = StrictIWCDTables(net, hmm, voca, use_triphone=use_triphone)
    N = net.n_nodes
    V = net.n_words
    ofs = net.word_node_ofs
    rc_head = np.full(N, -1, np.int32)
    rows = []
    for w in range(V):
        ns = int(tabs.head_ns_np[w])
        for j in range(ns):
            rc_head[int(ofs[w]) + j] = len(rows)
            rows.append(tabs.head_sidx_np[w, :, j])
    C = tabs.head_sidx_np.shape[1]
    rc_sidx = (np.stack(rows) if rows
               else np.zeros((0, C), np.int32))
    return rc_head, rc_sidx, tabs.lc_of_word[:V].astype(np.int32)


def _resolve(hmm: HMMSet, name: str) -> Optional[int]:
    pid = hmm.logical_map.get(name)
    if pid is None:
        pid = hmm.phone_index.get(name)
    if pid is None:
        pid = hmm.logical_map.get(center_name(name),
                                  hmm.phone_index.get(center_name(name)))
    return pid
