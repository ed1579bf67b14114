"""Compiled decode-network caching.

Copy of `julius_tpu/cache.py` (host numpy): the same digest and the same
.npz layout, so each package loads the other's saved networks.

The reference caches model *files* (binhmm/bingram) but rebuilds the
tree lexicon on every start (build_wchmm2 takes seconds on large
vocabularies).  Here the compiled flat network — the arrays of
search/network.py — round-trips through one .npz, keyed by a digest of
its inputs, so warm starts skip the host compile entirely.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional

import numpy as np

from julius_tpu_torch.models.hmm import HMMSet, PseudoPhoneSets
from julius_tpu_torch.search.network import DecodeNetwork, build_network

CACHE_VERSION = 1


def network_digest(hmm: HMMSet, voca, **kwargs) -> str:
    h = hashlib.sha1()
    h.update(str(CACHE_VERSION).encode())
    for arr in (hmm.phone_states, hmm.phone_ns, hmm.phone_trans,
                hmm.state_mix):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update("\x00".join(hmm.phone_names).encode())
    h.update("\x00".join(
        f"{k}={v}" for k, v in sorted(hmm.logical_map.items())).encode())
    for i in range(voca.n_words):
        h.update(voca.names[i].encode())
        h.update(" ".join(voca.phones[i]).encode())
    h.update(repr(sorted(kwargs.items())).encode())
    return h.hexdigest()


def save_network(net: DecodeNetwork, path: str) -> None:
    data = {
        "score_idx": net.score_idx,
        "in_src": net.in_src,
        "in_lp": net.in_lp,
        "entry_word": net.entry_word,
        "entry_lp": net.entry_lp,
        "exit_word": net.exit_word,
        "exit_lp": net.exit_lp,
        "word_node_ofs": net.word_node_ofs,
        "n_score_rows": np.asarray(net.n_score_rows),
        "head_word": np.asarray(net.head_word),
        "tail_word": np.asarray(net.tail_word),
    }
    ps = net.pseudo
    if ps is not None and ps.n_sets > 0:
        data.update({
            "ps_names": np.asarray(list(ps.name_index.keys())),
            "ps_ids": np.asarray(list(ps.name_index.values())),
            "ps_set_ns": ps.set_ns,
            "ps_set_state_ofs": ps.set_state_ofs,
            "ps_set_trans_phone": ps.set_trans_phone,
            "ps_members": ps.members,
            "ps_member_ofs": ps.member_ofs,
        })
    tmp = path + f".tmp{os.getpid()}"
    np.savez_compressed(tmp, **data)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_network(path: str) -> DecodeNetwork:
    z = np.load(path, allow_pickle=False)
    pseudo = None
    if "ps_members" in z:
        pseudo = PseudoPhoneSets(
            name_index={str(n): int(i)
                        for n, i in zip(z["ps_names"], z["ps_ids"])},
            set_ns=z["ps_set_ns"],
            set_state_ofs=z["ps_set_state_ofs"],
            set_trans_phone=z["ps_set_trans_phone"],
            members=z["ps_members"],
            member_ofs=z["ps_member_ofs"],
        )
    return DecodeNetwork(
        score_idx=z["score_idx"],
        in_src=z["in_src"],
        in_lp=z["in_lp"],
        entry_word=z["entry_word"],
        entry_lp=z["entry_lp"],
        exit_word=z["exit_word"],
        exit_lp=z["exit_lp"],
        word_node_ofs=z["word_node_ofs"],
        n_score_rows=int(z["n_score_rows"]),
        pseudo=pseudo,
        head_word=int(z["head_word"]),
        tail_word=int(z["tail_word"]),
    )


def build_network_cached(hmm: HMMSet, voca,
                         cache_dir: Optional[str] = None,
                         **kwargs) -> DecodeNetwork:
    """build_network with an on-disk cache (set cache_dir=None to
    disable; the default honours JULIUS_TPU_CACHE or ~/.cache)."""
    if cache_dir is None:
        cache_dir = os.environ.get(
            "JULIUS_TPU_CACHE",
            os.path.join(os.environ.get("XDG_CACHE_HOME",
                                        os.path.expanduser("~/.cache")),
                         "julius_tpu"))
    os.makedirs(cache_dir, exist_ok=True)
    key = network_digest(hmm, voca, **kwargs)
    path = os.path.join(cache_dir, f"net_{key}.npz")
    if os.path.exists(path):
        try:
            return load_network(path)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass        # unreadable entry: rebuild and overwrite it
    net = build_network(hmm, voca, **kwargs)
    try:
        save_network(net, path)
    except OSError:
        pass        # a read-only cache still decodes
    return net
