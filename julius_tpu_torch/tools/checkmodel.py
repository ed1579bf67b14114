"""Model / lexicon consistency checkers.

Reference: `-check triphone` (libjulius/src/hmm_check.c:303 interactive
triphone/dictionary coverage) and `-check wchmm`
(wchmm_check.c:332 tree-lexicon inspector), plus load-time checks
(chkhmmlist.c, check_hmm_restriction.c).

Port of `julius_tpu/tools/checkmodel.py` (host code over the port's
models/hmm.py and search/network.py).  `main` builds the engines on the
card (`main(argv, device="cpu")` on the CPU).

    python -m julius_tpu_torch.tools.checkmodel -h am.hmm [-hlist l] \\
        -v d.dict
"""

from __future__ import annotations

import json
import sys
from typing import List

import numpy as np

from julius_tpu_torch.fusion import create_engines
from julius_tpu_torch.jconf import parse_jconf
from julius_tpu_torch.models.hmm import build_pseudo_sets
from julius_tpu_torch.search.network import _resolve_phone, word_phone_names


def check_triphone_coverage(hmm, voca, use_triphone=None) -> dict:
    """For every dictionary word, resolve each (tri)phone like the
    decoder would; returns coverage stats + missing names."""
    if use_triphone is None:
        use_triphone = hmm.names_are_triphone
    all_names = set()
    for phones in voca.phones:
        all_names.update(word_phone_names(phones, use_triphone))
    need = sorted(n for n in all_names
                  if n not in hmm.logical_map and n not in hmm.phone_index)
    pseudo = build_pseudo_sets(hmm, need) if need else None
    exact = pseudo_n = mono = missing = 0
    missing_names: List[str] = []
    for name in sorted(all_names):
        if name in hmm.logical_map or name in hmm.phone_index:
            exact += 1
            continue
        try:
            kind, _ = _resolve_phone(hmm, pseudo, name)
            if kind == "pseudo":
                pseudo_n += 1
            else:
                mono += 1
        except KeyError:
            missing += 1
            missing_names.append(name)
    return {
        "n_names": len(all_names),
        "exact": exact,
        "pseudo": pseudo_n,
        "monophone_fallback": mono,
        "missing": missing,
        "missing_names": missing_names,
    }


def check_hmm(hmm) -> dict:
    """Load-time model sanity (reference check_hmm_restriction.c):
    transition topology classification + basic stats."""
    n_skip = n_tee = n_nonl2r = 0
    for p in range(hmm.n_phones):
        ns = int(hmm.phone_ns[p])
        tr = hmm.phone_trans[p]
        if tr[0, ns + 1] > -1e9:
            n_tee += 1
        for i in range(ns):
            for j in range(ns):
                if tr[i + 1, j + 1] > -1e9:
                    if j < i:
                        n_nonl2r += 1
                    elif j > i + 1:
                        n_skip += 1
    return {
        "n_phones": hmm.n_phones,
        "n_states": hmm.n_states,
        "n_gauss": hmm.n_gauss,
        "dim": hmm.dim,
        "max_mixtures": hmm.max_mix,
        "n_models_with_skip": n_skip,
        "n_tee_models": n_tee,
        "n_backward_arcs": n_nonl2r,
    }


def check_network(net) -> dict:
    """Decode-network statistics (the wchmm_check equivalent)."""
    valid = net.in_lp > -1e9
    indeg = valid.sum(axis=1)
    span = np.arange(net.n_nodes)[:, None] - net.in_src
    local = span[valid]
    return {
        "n_nodes": net.n_nodes,
        "n_words": net.n_words,
        "n_arcs": int(valid.sum()),
        "max_in_degree": int(indeg.max()) if net.n_nodes else 0,
        "n_entry_nodes": int((net.entry_word >= 0).sum()),
        "n_exit_nodes": int((net.exit_word >= 0).sum()),
        "max_arc_span": int(local.max()) if local.size else 0,
        "local_fast_path": bool(local.size and local.min() >= 0
                                and local.max() <= 8),
        "n_pseudo_states": (net.pseudo.n_set_states
                            if net.pseudo is not None else 0),
    }


def check_lm_coverage(voca, lm) -> dict:
    n_in = sum(1 for n in voca.names if n in lm.word_index)
    return {
        "dict_words": voca.n_words,
        "in_lm": n_in,
        "oov": voca.n_words - n_in,
        "lm_words": lm.n_words,
        "lm_order": lm.order,
    }


def check_engine(engine, mode: str) -> None:
    """-check <mode> on a live engine (reference hmm_check.c /
    wchmm_check.c interactive checkers, run non-interactively)."""
    if mode == "triphone":
        r = check_triphone_coverage(engine.hmm, engine.voca)
    elif mode in ("wchmm", "network"):
        r = check_network(engine.net)
    elif mode == "hmm":
        r = check_hmm(engine.hmm)
    elif mode == "lm":
        r = check_lm_coverage(engine.voca, engine.lm)
    else:
        raise ValueError(f"unknown -check mode '{mode}' "
                         "(triphone|wchmm|hmm|lm)")
    print(f"-check {mode}: " + json.dumps(r, default=str))


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    cfg = parse_jconf(argv)
    engines = create_engines(cfg, device=device)
    rc = 0
    for eng in engines:
        print(f"=== instance {eng.search_cfg.name} ===")
        print("HMM:", check_hmm(eng.hmm))
        cov = check_triphone_coverage(eng.hmm, eng.voca)
        print("triphone coverage:", {k: v for k, v in cov.items()
                                     if k != "missing_names"})
        if cov["missing"]:
            print("  MISSING:", ", ".join(cov["missing_names"][:20]))
            rc = 1
        print("network:", check_network(eng.net))
        if eng.lm is not None:
            print("LM coverage:", check_lm_coverage(eng.voca, eng.lm))
    return rc


if __name__ == "__main__":
    sys.exit(main())
