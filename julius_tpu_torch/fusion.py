"""Model loading and engine instantiation from an EngineConfig.

Port of `julius_tpu/fusion.py` (reference `libjulius/src/m_fusion.c`:
j_load_all:750 with initialize_HMM, initialize_dict, initialize_ngram;
feature-parameter precedence, explicit options > htkconf >
binhmm-embedded, m_fusion.c:73; j_launch_recognition_instance:1028).
Model files are read on the host; each Engine puts its tables on the
device `create_engines` is given.

Configurations the port does not decode yet raise NotImplementedError
naming the ROADMAP.md queue-1 item that brings them: grammars (-gram,
-gramlist, -dfa) and isolated-word lists (-w) with the unfused pass-1
paths, GMM input verification (-gmm) with streaming, a backward N-gram
(-nrl) with the backward N-gram.
"""

from __future__ import annotations

import gzip
from typing import List, Optional

from julius_tpu_torch.config import (AMConfig, EngineConfig, LMConfig,
                                     parse_feature_type)
from julius_tpu_torch.engine import Engine, unsupported
from julius_tpu_torch.io.arpa import load_arpa
from julius_tpu_torch.io.binhmm import read_binhmm
from julius_tpu_torch.io.bingram import read_bingram
from julius_tpu_torch.io.dnn import DNNParams, load_dnn
from julius_tpu_torch.io.hmmlist import load_hmmlist
from julius_tpu_torch.io.htk_dict import load_htkdict, parse_dict_line
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
    """Load the dictionary and N-gram of an LM block.  Returns (voca,
    ngram); ngram is None for a dictionary without -d/-nlr."""
    if lm.lmtype in ("grammar", "word"):
        raise unsupported(f"lmtype {lm.lmtype!r} (-gram/-gramlist/-dfa, "
                          "-w)", "unfused pass1_step paths")
    if lm.lmtype != "ngram":
        raise ValueError(f"unknown lmtype {lm.lmtype}")
    if lm.ngram_backward_path:
        raise unsupported("a backward (RL) N-gram (-nrl)", "backward N-gram")
    if not lm.dict_path:
        raise ValueError(f"LM '{lm.name}': ngram mode needs -v dict")
    voca = load_htkdict(lm.dict_path)
    _apply_dict_extras(voca, lm)
    ngram = None
    if lm.ngram_path:
        ngram = (read_bingram(lm.ngram_path) if _is_bingram(lm.ngram_path)
                 else load_arpa(lm.ngram_path))
    return voca, ngram


def create_engines(cfg: EngineConfig, device="cuda") -> List[Engine]:
    """Build one Engine per -SR search block on `device` (multi-instance
    decoding, reference recog.h:24-37); AMs and LMs shared by blocks are
    loaded once."""
    if cfg.gmm_path:
        raise unsupported("GMM input verification (-gmm)", "streaming")
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
        voca, ngram = lm_cache[id(lm_cfg)]
        eng = Engine(hmm, voca, lm=ngram, dnn=dnn,
                     frontend=am_cfg.frontend, search=sr, am_cfg=am_cfg,
                     lmtype="ngram", iwsp=lm_cfg.enable_iwsp, gshmm=gshmm,
                     device=device)
        shift = am_cfg.frontend.shift_ms or 10.0
        if am_cfg.sscalc:
            am_cfg.frontend.sscalc_frames = max(
                1, int(am_cfg.sscalc_len_ms / shift))
        if am_cfg.ssload_path:
            eng.set_noise_spectrum(load_noise_spectrum(am_cfg.ssload_path))
        # input rejection hooks (reference recogmain.c:1106-1256)
        if cfg.reject_short_ms:
            eng.reject_short_frames = int(cfg.reject_short_ms / shift)
        if cfg.reject_long_ms:
            eng.reject_long_frames = int(cfg.reject_long_ms / shift)
        eng.power_thres = cfg.power_thres
        engines.append(eng)
        jlog(LogLevel.STAT,
             f"instance '{sr.name}': AM={am_cfg.name} LM={lm_cfg.name} "
             f"type=ngram nodes={eng.net.n_nodes} device={eng.device}")
    return engines
