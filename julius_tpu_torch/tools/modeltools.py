"""Offline model tools — the reference's standalone executables.

    python -m julius_tpu_torch.tools.modeltools COMMAND ARGS, one of
        mkbingram  in.arpa out.bingram
        binlm2arpa in.bingram out.arpa
        mkbinhmm   in.hmmdefs out.binhmm [-htkconf Config]
        mkdfa      prefix
        generate-ngram lm.arpa [-n N]
        accept-check prefix "w1 w2 ..."
        generate   prefix [-n N]

Reference: mkbingram/, binlm2arpa/, mkbinhmm/, gramtools/mkdfa,
gramtools/accept_check, gramtools/generate, generate-ngram/.

Port of `julius_tpu/tools/modeltools.py` (host code over the port's
readers and writers: io/, grammar.py, io/ss.py).
"""

from __future__ import annotations

import sys


def cmd_mkbingram(args):
    from julius_tpu_torch.io.arpa import load_arpa
    from julius_tpu_torch.io.bingram import write_bingram
    src, dst = args[0], args[1]
    lm = load_arpa(src)
    write_bingram(dst, lm)
    print(f"wrote {dst}: {lm.order}-gram, {lm.n_words} words")
    return 0


def cmd_binlm2arpa(args):
    from julius_tpu_torch.io.arpa import write_arpa
    from julius_tpu_torch.io.bingram import read_bingram
    src, dst = args[0], args[1]
    lm = read_bingram(src)
    write_arpa(lm, dst)
    print(f"wrote {dst}: {lm.order}-gram, {lm.n_words} words")
    return 0


def cmd_mkbinhmm(args):
    from julius_tpu_torch.io.binhmm import write_binhmm
    from julius_tpu_torch.io.htk_hmm import load_hmmdefs
    from julius_tpu_torch.jconf import JconfParser
    para = None
    rest = []
    i = 0
    while i < len(args):
        if args[i] == "-htkconf":
            p = JconfParser()
            p._parse_htkconf(args[i + 1])
            para = p.am().frontend
            i += 2
        else:
            rest.append(args[i])
            i += 1
    src, dst = rest[0], rest[1]
    hmm = load_hmmdefs(src)
    write_binhmm(dst, hmm, para=para)
    print(f"wrote {dst}: {hmm.n_phones} models, {hmm.n_states} states, "
          f"{hmm.n_gauss} densities")
    return 0


def cmd_mkdfa(args):
    from julius_tpu_torch.grammar import mkdfa
    mkdfa(args[0])
    print(f"generated {args[0]}.dfa / .dfa.forward / .dict / .term")
    return 0


def cmd_generate_ngram(args):
    import numpy as np
    from julius_tpu_torch.io.arpa import load_arpa
    from julius_tpu_torch.io.bingram import read_bingram
    n = 10
    if "-n" in args:
        k = args.index("-n")
        n = int(args[k + 1])
        args = args[:k] + args[k + 2:]
    path = args[0]
    with open(path, "rb") as f:
        is_bin = f.read(17) == b"julius_bingram_v5"
    lm = read_bingram(path) if is_bin else load_arpa(path)
    rng = np.random.default_rng(0)
    for _ in range(n):
        # sample w_t ~ P(.|context) until </s> (reference
        # generate-ngram.c random walk)
        ctx = (lm.bos_id,) if lm.bos_id >= 0 else ()
        words = []
        for _ in range(50):
            probs = np.array([10.0 ** lm.logprob(ctx, w)
                              for w in range(lm.n_words)])
            if lm.bos_id >= 0:
                probs[lm.bos_id] = 0.0
            z = probs.sum()
            if z <= 0:
                break
            w = int(rng.choice(lm.n_words, p=probs / z))
            if w == lm.eos_id:
                break
            words.append(lm.words[w])
            ctx = (ctx + (w,))[-(lm.order - 1):] if lm.order > 1 else ()
        print(" ".join(words))
    return 0


def _load_fwd_grammar(prefix):
    import os
    from julius_tpu_torch.io.dfa import load_dfa, load_grammar
    dfa_rev, voca, word_cat = load_grammar(prefix)
    fwd_path = prefix + ".dfa.forward"
    dfa_fwd = load_dfa(fwd_path) if os.path.exists(fwd_path) else None
    return dfa_rev, dfa_fwd, voca, word_cat


def cmd_accept_check(args):
    from julius_tpu_torch.grammar import accept_check
    prefix = args[0]
    dfa_rev, dfa_fwd, voca, word_cat = _load_fwd_grammar(prefix)
    out2cat = {}
    for i in range(voca.n_words):
        out2cat[voca.outputs[i]] = int(word_cat[i])
    rc = 0
    for sent in args[1:]:
        words = sent.split()
        try:
            cats = [out2cat[w] for w in words]
        except KeyError as e:
            print(f"{sent}: word {e} not in vocabulary")
            rc = 1
            continue
        if dfa_fwd is not None:
            ok = accept_check(dfa_fwd, cats)
        else:
            ok = dfa_rev.accepts_forward(cats)
        print(f"{sent}: {'accepted' if ok else 'rejected'}")
        rc = rc if ok else 1
    return rc


def cmd_generate(args):
    from julius_tpu_torch.grammar import generate_sentences
    import random
    n = 10
    if "-n" in args:
        k = args.index("-n")
        n = int(args[k + 1])
        args = args[:k] + args[k + 2:]
    prefix = args[0]
    dfa_rev, dfa_fwd, voca, word_cat = _load_fwd_grammar(prefix)
    rng = random.Random(0)
    cat_words = {}
    for i in range(voca.n_words):
        cat_words.setdefault(int(word_cat[i]), []).append(voca.outputs[i])
    if dfa_fwd is None:
        print("generate needs the .dfa.forward file", file=sys.stderr)
        return 1
    for cats in generate_sentences(dfa_fwd, n=n):
        print(" ".join(rng.choice(cat_words[c]) for c in cats))
    return 0


def cmd_dfa_minimize(args):
    """dfa_minimize in.dfa [out.dfa] (reference gramtools/dfa_minimize)."""
    from julius_tpu_torch.grammar import minimize_dfa, write_dfa
    from julius_tpu_torch.io.dfa import load_dfa
    src = args[0]
    dst = args[1] if len(args) > 1 else None
    dfa = load_dfa(src)
    out = minimize_dfa(dfa)
    write_dfa(out, dst if dst else sys.stdout)
    print(f"{dfa.n_states} states -> {out.n_states} states",
          file=sys.stderr)
    return 0


def cmd_dfa_determinize(args):
    """dfa_determinize in.dfa [out.dfa] (reference
    gramtools/dfa_determinize)."""
    from julius_tpu_torch.grammar import determinize_dfa, write_dfa
    from julius_tpu_torch.io.dfa import load_dfa
    src = args[0]
    dst = args[1] if len(args) > 1 else None
    dfa = load_dfa(src)
    out = determinize_dfa(dfa)
    write_dfa(out, dst if dst else sys.stdout)
    print(f"{dfa.n_states} states -> {out.n_states} states",
          file=sys.stderr)
    return 0


def cmd_nextword(args):
    """nextword prefix "w1 w2 ..." — possible following words
    (reference gramtools/nextword; empty sentence lists first words)."""
    from julius_tpu_torch.grammar import next_categories
    prefix = args[0]
    dfa_rev, dfa_fwd, voca, word_cat = _load_fwd_grammar(prefix)
    if dfa_fwd is None:
        print("nextword needs the .dfa.forward file", file=sys.stderr)
        return 1
    out2cat = {voca.outputs[i]: int(word_cat[i])
               for i in range(voca.n_words)}
    cat_words = {}
    for i in range(voca.n_words):
        cat_words.setdefault(int(word_cat[i]), []).append(voca.outputs[i])
    rc = 0
    for sent in (args[1:] or [""]):
        words = sent.split()
        try:
            cats = [out2cat[w] for w in words]
        except KeyError as e:
            print(f"{sent}: word {e} not in vocabulary")
            rc = 1
            continue
        nxt = next_categories(dfa_fwd, cats)
        cand = sorted(w for c in nxt for w in cat_words.get(c, []))
        print(f"{sent or '(begin)'}: {' '.join(cand) if cand else '(none)'}")
    return rc


def cmd_mkss(args):
    """mkss: estimate a noise spectrum from a silence recording."""
    import numpy as np
    from julius_tpu_torch.config import FrontendConfig
    from julius_tpu_torch.io.ss import (estimate_noise_spectrum,
                                  save_noise_spectrum)
    from julius_tpu_torch.io.wav import read_audio
    src, dst = args[0], args[1]
    wave = read_audio(src)
    spec = estimate_noise_spectrum(wave, FrontendConfig())
    save_noise_spectrum(dst, spec)
    print(f"wrote {dst}: {len(spec)} points "
          f"(mean magnitude {float(np.mean(spec)):.1f})")
    return 0


def cmd_mkgshmm(args):
    """monophone hmmdefs -> GMS selector model (reference
    mkgshmm/mkgshmm.in: every state of every monophone becomes a named
    ~s macro "<name><loc>m" so Julius can index GS states by name; the
    model itself is unchanged).  Our loader reads either form — the
    rewrite is for wire compatibility with the reference engine."""
    import gzip
    import re
    src = args[0]
    dst = args[1] if len(args) > 1 else None
    op = gzip.open if src.endswith(".gz") else open
    with op(src, "rt") as f:
        lines = f.readlines()
    out = []
    # pass 1: emit global options, then every state as a ~s macro
    name = None
    in_state = False
    stateloc = None
    header_done = False
    body = []
    for ln in lines:
        m = re.match(r'~h\s+"(.*)"', ln)
        if m:
            name = m.group(1)
            header_done = True
            continue
        if not header_done:
            out.append(ln)
            continue
        m = re.match(r"<STATE>\s+(\d+)", ln, re.I)
        if m:
            stateloc = m.group(1)
            in_state = True
            out.append(f'~s "{name}{stateloc}m"\n')
            continue
        if re.match(r"<TRANSP>", ln, re.I):
            in_state = False
        if in_state:
            out.append(ln)
    # pass 2: HMM definitions referencing the macros
    header_done = False
    in_state = False
    for ln in lines:
        m = re.match(r'~h\s+"(.*)"', ln)
        if m:
            name = m.group(1)
            header_done = True
            body.append(ln)
            continue
        if not header_done:
            continue
        m = re.match(r"<STATE>\s+(\d+)", ln, re.I)
        if m:
            stateloc = m.group(1)
            in_state = True
            body.append(ln)
            body.append(f'~s "{name}{stateloc}m"\n')
            continue
        if re.match(r"<TRANSP>", ln, re.I):
            in_state = False
        if not in_state:
            body.append(ln)
    text = "".join(out) + "".join(body)
    if dst:
        with open(dst, "w") as f:
            f.write(text)
        print(f"wrote {dst}")
    else:
        sys.stdout.write(text)
    return 0


COMMANDS = {
    "mkss": cmd_mkss,
    "mkgshmm": cmd_mkgshmm,
    "mkbingram": cmd_mkbingram,
    "binlm2arpa": cmd_binlm2arpa,
    "mkbinhmm": cmd_mkbinhmm,
    "mkdfa": cmd_mkdfa,
    "generate-ngram": cmd_generate_ngram,
    "accept-check": cmd_accept_check,
    "generate": cmd_generate,
    "dfa-minimize": cmd_dfa_minimize,
    "dfa-determinize": cmd_dfa_determinize,
    "nextword": cmd_nextword,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
