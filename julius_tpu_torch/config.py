"""Runtime configuration — the jconf equivalent.

Mirrors the reference's three-block configuration model
(`libjulius/include/julius/jconf.h:68,275,413`: JCONF_AM / JCONF_LM /
JCONF_SEARCH plus the global Jconf) but as plain dataclasses resolved at
runtime.  Everything that is a `./configure`-time build variant in the
reference (`libjulius/configure.in:28-203`: factoring mode, gprune method,
wpair, word-graph, ...) is a runtime field here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Feature extraction parameters (reference: the `Value` struct,
# libsent/include/sent/mfcc.h:76-117 and para.c defaults)
# ---------------------------------------------------------------------------

@dataclass
class FrontendConfig:
    """Acoustic front-end parameters (HTK-compatible).

    Defaults follow Julius's `make_default_para` (libsent/src/wav2mfcc/para.c)
    for a 16 kHz MFCC_E_D_N_Z setup.
    """

    sample_rate: int = 16000
    frame_ms: float = 25.0          # window length in ms  (framesize samples)
    shift_ms: float = 10.0          # frame shift in ms
    preemph: float = 0.97
    fbank_num: int = 24
    mfcc_dim: int = 12              # cepstral coeffs (excluding c0/energy)
    lifter: int = 22
    delta_win: int = 2              # delta window (frames each side)
    accel_win: int = 2
    # feature composition flags (HTK qualifiers)
    use_energy: bool = True         # _E
    use_c0: bool = False            # _0
    use_delta: bool = True          # _D
    use_accel: bool = False         # _A
    absesup: bool = False           # _N suppress absolute energy
    cmn: bool = True                # _Z cepstral mean normalisation
    cvn: bool = False               # variance normalisation
    energy_normalize: bool = False  # enormal
    escale: float = 1.0
    silfloor_db: float = 50.0
    raw_e: bool = False
    zmeanframe: bool = False
    use_power: bool = False         # power spectrum instead of magnitude
    lopass_hz: int = -1
    hipass_hz: int = -1
    vtln_alpha: float = 1.0
    vtln_lower: float = 100.0
    vtln_upper: float = -1.0
    ss_alpha: float = 2.0           # spectral subtraction factor
    ss_floor: float = 0.5
    # -sscalc: frames of head input averaged into a per-utterance noise
    # spectrum (0 = off; set from AMConfig.sscalc_len_ms by fusion)
    sscalc_frames: int = 0
    # streaming MAP-CMN (reference wav2mfcc-pipe.c:342 CMN_realtime)
    cmn_map_weight: float = 100.0
    cmn_static: bool = False
    cvn_static: bool = False        # -cvnstatic
    # feature type string, e.g. "MFCC_E_D_N_Z"; parsed into the flags above
    feature_type: Optional[str] = None

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate * self.frame_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = 2
        while n < self.frame_size:
            n *= 2
        return n

    @property
    def base_dim(self) -> int:
        """Static vector length before delta/accel (cepstra + c0/energy)."""
        d = self.mfcc_dim
        if self.use_c0:
            d += 1
        if self.use_energy:
            d += 1
        return d

    @property
    def veclen(self) -> int:
        """Full output vector length after delta/accel/energy suppression."""
        nblocks = 1 + int(self.use_delta) + int(self.use_accel)
        d = self.base_dim * nblocks
        if self.absesup:
            d -= 1
        return d


def parse_feature_type(name: str, cfg: Optional[FrontendConfig] = None) -> FrontendConfig:
    """Parse an HTK parameter-kind string like ``MFCC_E_D_N_Z`` or
    ``FBANK_D_A_Z`` into a FrontendConfig (reference:
    libsent/src/anlz/paramtypes.c qualifier codes)."""
    cfg = dataclasses.replace(cfg) if cfg is not None else FrontendConfig()
    parts = name.upper().split("_")
    base, quals = parts[0], set(parts[1:])
    if base not in ("MFCC", "FBANK", "MELSPEC", "LINEAR", "USER"):
        raise ValueError(f"unsupported feature base kind: {base}")
    cfg.feature_type = name
    cfg.use_energy = "E" in quals
    cfg.use_c0 = "0" in quals
    cfg.use_delta = "D" in quals
    cfg.use_accel = "A" in quals
    cfg.absesup = "N" in quals
    cfg.cmn = "Z" in quals
    return cfg


# ---------------------------------------------------------------------------
# AM / LM / Search configs (reference jconf.h:68,275,413)
# ---------------------------------------------------------------------------

@dataclass
class DNNConfig:
    """DNN-HMM frontend definition (.dnnconf equivalent,
    reference Sample.dnnconf + jconf.h:230-248)."""

    enabled: bool = False
    feature_type: str = "FBANK_D_A_Z"
    feature_len: int = 0
    context_len: int = 11           # splice frames (centered)
    input_nodes: int = 0
    output_nodes: int = 0
    hidden_nodes: int = 0
    hidden_layers: int = 0
    weights: list = field(default_factory=list)      # paths W1..Wn
    biases: list = field(default_factory=list)       # paths B1..Bn
    output_w: Optional[str] = None
    output_b: Optional[str] = None
    state_prior_path: Optional[str] = None
    state_prior_factor: float = 1.0
    batch_size: int = 64
    base_dir: str = "."             # directory for relative weight paths


@dataclass
class AMConfig:
    """Acoustic model block (reference JCONF_AM jconf.h:68)."""

    name: str = "_default"
    hmmdefs_path: Optional[str] = None
    hmmlist_path: Optional[str] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    dnn: DNNConfig = field(default_factory=DNNConfig)
    # Gaussian pruning (reference hmm_calc.h:71-83): none|safe|beam|heu.
    # On TPU the dense matmul scorer makes pruning usually unnecessary;
    # 'topk' keeps only the k best Gaussians per mixture like gprune_beam.
    gprune: str = "none"
    gprune_num: int = 10
    # Gaussian Mixture Selection (reference -gshmm/-gsnum, gms.c):
    # monophone selector model; senones outside the per-frame top-gsnum
    # GS states fall back to their GS state's score
    gshmm_path: Optional[str] = None
    gsnum: int = 24                 # reference default.c:141
    # inter-word context approximation for pseudo phone sets
    # (reference outprob_cd, libsent/src/phmm/outprob.c:287-420)
    iwcd_scheme: str = "best"       # best | max | avg
    iwcd_nbest: int = 3
    # per-last-word RC triphone assignment for word-head states in
    # pass 1 (reference outprob_style.c:354 dynamic AS_RSET); False =
    # iwcd1 pseudo-set approximation.  Uses the XLA pass-1 path (the
    # fused kernel does not carry the context payload into emissions)
    head_rc_dynamic: bool = False
    force_mono: bool = False        # treat dict phones as monophones
    # MAP-CMN persistence (-cmnload/-cmnsave/-cmnnoupdate)
    cmnload_path: Optional[str] = None
    cmnsave_path: Optional[str] = None
    cmn_update: bool = True
    # spectral subtraction (-ssload; reference libsent/src/wav2mfcc/ss.c)
    ssload_path: Optional[str] = None
    # -sscalc: estimate the noise spectrum from the head silence of
    # each (file) input instead of a precomputed -ssload file
    sscalc: bool = False
    sscalc_len_ms: int = 300
    # -spmodel/-sp: short-pause model name (iwsp insertion + decoder-VAD
    # pause detection, reference jconf.am spmodel_name)
    spmodel_name: str = "sp"
    # -multipath: the reference forces its multipath network variant;
    # the flat network here derives topology from the model itself, so
    # this is accepted and recorded only
    multipath_forced: bool = False


@dataclass
class LMConfig:
    """Language model block (reference JCONF_LM jconf.h:275)."""

    name: str = "_default"
    lmtype: str = "ngram"           # ngram | grammar | word
    dict_path: Optional[str] = None
    ngram_path: Optional[str] = None     # ARPA or bingram (forward)
    ngram_backward_path: Optional[str] = None   # -nrl backward ARPA
    dfa_path: Optional[str] = None
    gram_prefix: Optional[str] = None    # prefix.dfa + prefix.dict
    gramlist_path: Optional[str] = None  # -gramlist file of prefixes
    wordlist_path: Optional[str] = None  # isolated word recognition
    unk_name: str = "<unk>"              # -mapunk
    head_silname: str = "<s>"
    tail_silname: str = "</s>"
    enable_iwsp: bool = False
    iwsp_penalty: float = -1.0      # -iwsppenalty (default.c:144)
    # -adddict/-addentry/-forcedict (reference voca_load_htkdict
    # do_conv/error handling)
    adddict_paths: list = field(default_factory=list)
    addentries: list = field(default_factory=list)
    forcedict: bool = False
    # -iwspword/-iwspentry: add a short-pause word to the dictionary
    # (reference default iwspentry "<UNK> [sp] sp", default.c)
    enable_iwspword: bool = False
    iwspentry: str = "<UNK> [sp] sp"
    # -wsil: head/tail silence + context for wordlist mode
    wsil_head: str = "silB"
    wsil_tail: str = "silE"
    wsil_context: str = ""
    head_margin_word: str = "sil"   # silence model at head/tail
    tail_margin_word: str = "sil"


@dataclass
class SearchConfig:
    """Search instance block (reference JCONF_SEARCH jconf.h:413)."""

    name: str = "_default"
    am_name: str = "_default"
    lm_name: str = "_default"
    # LM weights (reference define.h:75-90 tuned defaults)
    lm_weight: float = 8.0          # pass-1 LM weight
    lm_penalty: float = -2.0        # pass-1 word insertion penalty
    lm_weight2: float = 8.0         # pass-2 LM weight
    lm_penalty2: float = -2.0
    transparent_penalty: float = 0.0
    # pass-1 beam
    beam_width: int = 0             # 0 = full (dense) Viterbi, no pruning
    trellis_topm: int = 0           # word-ends recorded per frame
                                    # (0 = auto-size with vocabulary; the
                                    # reference keeps ALL survivors,
                                    # backtrellis.c, so M must grow with V)
    crossword_topk: int = 16        # word-ends expanded cross-word per frame
    factoring: int = 1              # 1 = unigram entry (fast), 2 = exact
                                    # bigram entry (reference factor1/2)
    score_prune_width: float = 0.0  # 0 = off
    # pass-2
    enable_pass2: bool = True
    pass2_rescan: bool = True       # acoustic re-scan (scan_word parity);
                                    # False = freeze AM at pass-1 scores
    pass2_device: bool = True       # run the A* fully on device when the
                                    # config allows (pass2_device.py);
                                    # False = host-driven re-scan always
    strict_iwcd2: bool = False      # strict inter-word CD in the re-scan
                                    # (reference --enable-setup=standard,
                                    # search_bestfirst_v2.c; v1 pseudo
                                    # sets otherwise)
    nbest: int = 1                  # -n sentences to find
    output_n: int = 1               # -output sentences to emit
    max_hypo_pop: int = 2000        # -m hypothesis overflow
    stack_size: int = 500           # -s
    lookup_range: int = 5           # trellis lookup +- frames
    scan_beam: float = 0.0          # score envelope width (0 = off)
    word_envelope: int = 30         # wb per hypo length
    enveloped: bool = True
    # outputs
    align_word: bool = False
    align_phoneme: bool = False
    align_state: bool = False
    compute_confidence: bool = False
    cm_alpha: float = 0.05
    cm_search: bool = False         # CM from search-time pass-2 graph
                                    # posteriors (reference CM_SEARCH
                                    # build variant) instead of N-best
    graph_out: bool = False
    confnet_out: bool = False
    graph_min_posterior: float = 1e-4
    mbr: bool = False               # USE_MBR rescoring of the N-best
    mbr_score_scale: float = 0.1
    # graph output shaping (reference jconf.graph block; stored and
    # applied where the TPU graph pipeline has an analogue)
    graph_range: int = 0            # -graphrange merge-boundary slack
    graph_cut_depth: int = 80       # -graphcut depth cut
    graph_bound_loop: int = 20      # -graphboundloop
    graph_search_delay: bool = False  # -graphsearchdelay
    # CM thresholds (reference -cmthres keyword gating)
    cm_thres: float = 0.0
    cm_thres2: float = 0.0
    # MBR variants (reference USE_MBR options)
    mbr_use_word_weights: bool = False   # -mbr_wwer
    multigram_out: bool = False     # -multigramout
    start_inactive: bool = False    # -inactive (module can activate)
    fallback_1pass: bool = True     # -fallback1pass (always on here,
                                    # like pass2_finalize_on_no_result)
    # grammar/one-pass modes
    one_pass: bool = False


@dataclass
class EngineConfig:
    """Top-level engine config (reference global Jconf jconf.h:854).

    Holds named AM/LM/search blocks exactly like `-AM`/`-LM`/`-SR`
    sectioning in jconf files (reference m_jconf.c)."""

    ams: list = field(default_factory=lambda: [AMConfig()])
    lms: list = field(default_factory=lambda: [LMConfig()])
    searches: list = field(default_factory=lambda: [SearchConfig()])
    # input block
    input_source: str = "file"      # file | adinnet | stdin | vecnet
    filelist_path: Optional[str] = None
    # VAD / triggering (reference -lv/-zc/-headmargin/-tailmargin)
    use_vad: bool = False
    vad_level: int = 2000
    vad_zc: int = 60
    vad_head_ms: int = 300
    vad_tail_ms: int = 400
    # sub-band SNR VAD gate (the libfvad role; reference -fvad mode,
    # -fvad_param <nframes> <thres>)
    fvad_mode: int = -1
    fvad_smooth: int = 5
    fvad_thres: float = 0.0
    # preprocessing (reference jconf.preprocess block)
    zmean: bool = False             # -zmean DC offset removal
    level_coef: float = 1.0         # -lvscale input scaling
    ds48: bool = False              # -48 (48 kHz input, decimate to 16k)
    nostrip: bool = False           # -nostrip keep invalid zero frames
    typecheck: bool = True          # -notypecheck disables param check
    chunk_size: int = 1000          # -chunksize adin read samples
    force_realtime: Optional[bool] = None   # -realtime/-norealtime
    # decoder-VAD short-pause segmentation (reference -spsegment block)
    spsegment: bool = False
    sp_frame_duration: int = 10     # -spdur
    pause_models: list = field(default_factory=list)   # -pausemodels
    # -check wchmm/triphone: run interactive model checks after load
    check_modes: list = field(default_factory=list)
    # rejection
    reject_short_ms: int = 0
    reject_long_ms: int = 0
    # GMM utterance verification / GMM-VAD (reference gmm.c:429-734;
    # jconf.reject.gmm_* and detect.gmm_* blocks, default.c:82-98)
    gmm_path: Optional[str] = None      # -gmm hmmdefs of GMM set
    gmm_num: int = 10                   # -gmmnum Gaussian prune per mix
    gmm_reject: list = field(default_factory=list)  # -gmmreject names
    gmm_margin: int = 20                # -gmmmargin VAD window (frames)
    gmm_up: float = 0.7                 # -gmmup VAD up-trigger
    gmm_down: float = -0.2              # -gmmdown VAD down-trigger
    gmm_vad: bool = False               # use the GMM as a VAD gate
    gmm_noise_names: list = field(default_factory=list)
    power_thres: float = 0.0            # -powerthres (0 = off)
    # decoding
    batch_size: int = 1             # utterances decoded per device step
    realtime: bool = False
    # servers / outputs
    module_port: Optional[int] = None
    adinnet_port: Optional[int] = None
    outfile: bool = False
    outprob_out: Optional[str] = None   # -outprobout prefix
    # output / logging (reference julius/output_stdout.c, output_file.c,
    # record.c, charconv.c, main.c -logfile/-separatescore)
    logfile: Optional[str] = None
    quiet: bool = False
    debug: bool = False
    separatescore: bool = False
    record_dir: Optional[str] = None    # -record: per-utterance wav dump
    charconv: Optional[tuple] = None    # (from, to) output charset pair
    progout: bool = False               # progressive pass-1 partials
    proginterval_ms: int = 300
    plugin_dirs: list = field(default_factory=list)   # -plugindir
    unknown: list = field(default_factory=list)

    def am(self, name: str) -> AMConfig:
        for a in self.ams:
            if a.name == name:
                return a
        raise KeyError(name)

    def lm(self, name: str) -> LMConfig:
        for l in self.lms:
            if l.name == name:
                return l
        raise KeyError(name)
