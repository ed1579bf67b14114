"""Model loading and engine instantiation from an EngineConfig.

Port of `julius_tpu/fusion.py` (reference `libjulius/src/m_fusion.c`:
j_load_all:750 with initialize_HMM, initialize_dict, initialize_ngram;
feature-parameter precedence, explicit options > htkconf >
binhmm-embedded, m_fusion.c:73; j_launch_recognition_instance:1028).
Model files are read on the host; each Engine puts its tables on the
device `create_engines` is given.

Three LM modes: an N-gram with its dictionary (-d / -nlr, -v), a DFA
grammar (-gram prefix, -gramlist, or -dfa with -v; several grammars are
merged into one automaton as the reference's multigram_build does) and
an isolated-word list (-w).  A -gmm model set becomes every engine's GMM
input verification and GMM-VAD front end (frontend/gmm_frontend.py,
with -gmmreject, -gmmnoise, -gmmmargin, -gmmup, -gmmdown), and
-powerthres every engine's power rejection.  A backward N-gram (-nrl)
drives pass 2, with the forward 2-gram of -nlr (or of an RL bingram's
pair) for pass 1.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional

import numpy as np

from julius_tpu_torch.config import (AMConfig, EngineConfig, LMConfig,
                                     parse_feature_type)
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.frontend.gmm_frontend import GMMFrontend
from julius_tpu_torch.io.arpa import load_arpa
from julius_tpu_torch.io.binhmm import read_binhmm
from julius_tpu_torch.io.bingram import read_bingram
from julius_tpu_torch.io.dfa import DFAGrammar, load_dfa, load_grammar
from julius_tpu_torch.io.dnn import DNNParams, load_dnn
from julius_tpu_torch.io.hmmlist import load_hmmlist
from julius_tpu_torch.io.htk_dict import (Vocabulary, load_htkdict,
                                          load_wordlist, parse_dict_line)
from julius_tpu_torch.io.htk_hmm import load_hmmdefs
from julius_tpu_torch.io.ss import load_noise_spectrum
from julius_tpu_torch.utils.jlog import LogLevel, jlog


def _is_binhmm(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x1f\x8b":
            with gzip.open(path, "rb") as g:
                return g.read(7) == b"JBINHMM"
        return head + f.read(5) == b"JBINHMM"


def _is_bingram(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(17) == b"julius_bingram_v5"


def load_am(am: AMConfig):
    """Load the acoustic model (+DNN, + GMS selector model) of an AM
    block (initialize_HMM m_fusion.c:73).  Returns (hmm, dnn, gshmm)."""
    if not am.hmmdefs_path:
        raise ValueError(f"AM '{am.name}': no hmmdefs (-h) given")
    embedded = None
    if _is_binhmm(am.hmmdefs_path):
        hmm, embedded = read_binhmm(am.hmmdefs_path)
    else:
        hmm = load_hmmdefs(am.hmmdefs_path)
    if am.hmmlist_path:
        load_hmmlist(am.hmmlist_path, hmm)
    # feature parameters: the binhmm's embedded ones are taken whole;
    # else the hmmdefs' parameter kind fills an unset feature type
    if embedded is not None:
        am.frontend = embedded
    elif hmm.param_kind and am.frontend.feature_type is None:
        am.frontend = parse_feature_type(hmm.param_kind, am.frontend)
    dnn: Optional[DNNParams] = None
    if am.dnn.enabled:
        if am.dnn.feature_type:
            am.frontend = parse_feature_type(am.dnn.feature_type,
                                             am.frontend)
        dnn = load_dnn(am.dnn, getattr(am.dnn, "base_dir", "."))
    gshmm = None
    if am.gshmm_path and dnn is None:
        # GMS selector model (-gshmm; reference initialize_GSHMM
        # m_fusion.c:183, GMM scoring only)
        gshmm = (read_binhmm(am.gshmm_path)[0]
                 if _is_binhmm(am.gshmm_path)
                 else load_hmmdefs(am.gshmm_path))
    return hmm, dnn, gshmm


def _apply_dict_extras(voca, lm: LMConfig) -> None:
    """-adddict/-addentry/-iwspword additions to a loaded dictionary
    (reference voca_load_htkdict append mode + enable_iwspword,
    m_fusion.c initialize_dict)."""
    lines = []
    for path in lm.adddict_paths:
        with open(path, "rt", encoding="utf-8", errors="replace") as f:
            lines.extend(line.rstrip("\n") for line in f if line.strip())
    entries = list(lm.addentries)
    if lm.enable_iwspword:
        entries.append(lm.iwspentry)
    lines.extend(line.replace("\\t", "\t") for line in entries)
    for line in lines:
        try:
            parse_dict_line(line, voca)
        except ValueError as e:
            if not lm.forcedict:
                raise
            jlog(LogLevel.WARNING, f"-forcedict: skipping bad entry: {e}")


def load_lm(lm: LMConfig):
    """Load the LM block's dictionary and language model.  Returns
    (lmtype, voca, ngram, dfa, word_cat, forward): the N-gram (None for
    a dictionary without -d/-nlr/-nrl) in ngram mode, with the forward
    2-gram of an -nlr + -nrl pair as `forward` (the backward model is
    then `ngram`), the automaton and each word's category in grammar
    mode, neither in word mode."""
    if lm.lmtype == "ngram":
        if not lm.dict_path:
            raise ValueError(f"LM '{lm.name}': ngram mode needs -v dict")
        voca = load_htkdict(lm.dict_path)
        _apply_dict_extras(voca, lm)
        ngram = fwd = None
        if lm.ngram_path:
            ngram = (read_bingram(lm.ngram_path)
                     if _is_bingram(lm.ngram_path)
                     else load_arpa(lm.ngram_path))
        if lm.ngram_backward_path:
            # -nlr + -nrl pair: the backward model drives pass 2, the
            # forward 2-gram pass 1 (reference initialize_ngram)
            fwd = ngram
            ngram = load_arpa(lm.ngram_backward_path, direction="RL")
        return "ngram", voca, ngram, None, None, fwd
    if lm.lmtype == "grammar":
        if lm.gram_prefix:
            dfa, voca, word_cat = load_grammar(lm.gram_prefix)
        elif lm.gramlist_path:
            base = os.path.dirname(os.path.abspath(lm.gramlist_path))
            prefixes = []
            with open(lm.gramlist_path) as f:
                for line in f:
                    s = line.strip()
                    if s and not s.startswith("#"):
                        prefixes.append(os.path.join(base, s))
            dfa, voca, word_cat = load_multiple_grammars(prefixes)
        elif lm.dfa_path and lm.dict_path:
            dfa = load_dfa(lm.dfa_path)
            voca = load_htkdict(lm.dict_path)
            # a grammar dictionary names each word by its category id
            word_cat = np.asarray([int(n) for n in voca.names],
                                  dtype=np.int32)
        else:
            raise ValueError(
                f"LM '{lm.name}': grammar mode needs -gram/-gramlist or "
                "-dfa + -v")
        return "grammar", voca, None, dfa, word_cat, None
    if lm.lmtype == "word":
        if not lm.wordlist_path:
            raise ValueError(f"LM '{lm.name}': word mode needs -w list")
        return "word", load_wordlist(lm.wordlist_path), None, None, None, \
            None
    raise ValueError(f"unknown lmtype {lm.lmtype}")


def load_multiple_grammars(prefixes: List[str]):
    """Load each prefix.dfa + prefix.dict and merge them into one
    automaton and dictionary (`merge_grammars`)."""
    return merge_grammars([load_grammar(p) for p in prefixes])


def merge_grammars(grams):
    """Merge (dfa, voca, word_cat) triples into one global DFA +
    dictionary (reference multigram_build gramlist.c/multi-gram.c:174:
    category ids and DFA states are offset per grammar and the automata
    run in parallel as one big DFA with multiple initial/accept
    states)."""
    gdfa = DFAGrammar()
    voca = Vocabulary()
    cats: List[int] = []
    for dfa, v, wc in grams:
        soff = gdfa.n_states
        coff = gdfa.n_terms
        gdfa.n_states += dfa.n_states
        gdfa.n_terms += dfa.n_terms
        gdfa.arcs.extend(
            [[(c + coff, s + soff) for (c, s) in arcs] for arcs in dfa.arcs])
        gdfa.accept.extend(dfa.accept)
        gdfa.initial.extend(dfa.initial)
        for i in range(v.n_words):
            voca.add(str(int(wc[i]) + coff), v.phones[i], v.outputs[i],
                     v.transparent[i], v.cprob[i], v.weight[i])
            cats.append(int(wc[i]) + coff)
    gdfa.term_words = [[] for _ in range(gdfa.n_terms)]
    for wid, c in enumerate(cats):
        gdfa.term_words[c].append(wid)
    return gdfa, voca, np.asarray(cats, dtype=np.int32)


def create_engines(cfg: EngineConfig, device="cuda") -> List[Engine]:
    """Build one Engine per -SR search block on `device` (multi-instance
    decoding, reference recog.h:24-37); AMs and LMs shared by blocks are
    loaded once."""
    gmm_front = None
    if cfg.gmm_path:
        # GMM verification / VAD front end (reference m_fusion.c loads
        # reject.gmm_filename into its own HMM + MFCC instance,
        # gmm_init gmm.c:429); shared by all search instances
        gmm_hmm = (read_binhmm(cfg.gmm_path)[0] if _is_binhmm(cfg.gmm_path)
                   else load_hmmdefs(cfg.gmm_path))
        gmm_front = GMMFrontend(
            gmm_hmm, reject_names=cfg.gmm_reject,
            vad_noise_names=(cfg.gmm_noise_names or cfg.gmm_reject),
            vad_margin=float(cfg.gmm_margin),
            vad_up=cfg.gmm_up, vad_down=cfg.gmm_down, device=device)
        jlog(LogLevel.STAT,
             f"GMM frontend: {gmm_hmm.n_phones} models, "
             f"reject={sorted(gmm_front.reject)}")
    am_cache, lm_cache = {}, {}
    engines = []
    for sr in cfg.searches:
        am_cfg = cfg.am(sr.am_name)
        lm_cfg = cfg.lm(sr.lm_name)
        if id(am_cfg) not in am_cache:
            am_cache[id(am_cfg)] = load_am(am_cfg)
        hmm, dnn, gshmm = am_cache[id(am_cfg)]
        if id(lm_cfg) not in lm_cache:
            lm_cache[id(lm_cfg)] = load_lm(lm_cfg)
        lmtype, voca, ngram, dfa, word_cat, lm_fwd = lm_cache[id(lm_cfg)]
        eng = Engine(hmm, voca, lm=ngram, dnn=dnn,
                     frontend=am_cfg.frontend, search=sr, am_cfg=am_cfg,
                     dfa=dfa, word_cat=word_cat, lmtype=lmtype,
                     iwsp=lm_cfg.enable_iwsp, lm_forward=lm_fwd,
                     gshmm=gshmm, device=device)
        shift = am_cfg.frontend.shift_ms or 10.0
        if am_cfg.sscalc:
            am_cfg.frontend.sscalc_frames = max(
                1, int(am_cfg.sscalc_len_ms / shift))
        if am_cfg.ssload_path:
            eng.set_noise_spectrum(load_noise_spectrum(am_cfg.ssload_path))
        # input rejection hooks (reference recogmain.c:1106-1256)
        eng.gmm_frontend = gmm_front
        if cfg.reject_short_ms:
            eng.reject_short_frames = int(cfg.reject_short_ms / shift)
        if cfg.reject_long_ms:
            eng.reject_long_frames = int(cfg.reject_long_ms / shift)
        eng.power_thres = cfg.power_thres
        engines.append(eng)
        jlog(LogLevel.STAT,
             f"instance '{sr.name}': AM={am_cfg.name} LM={lm_cfg.name} "
             f"type={lmtype} nodes={eng.net.n_nodes} device={eng.device}")
    return engines
