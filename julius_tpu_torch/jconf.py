"""Jconf configuration parsing: files + command-line options.

Reference: `libjulius/src/m_jconf.c` (jconf file reader with recursive
include and -AM/-LM/-SR sectioning) and `m_options.c` (~170 options).
This parser covers the options that drive the engine; unknown
options log a warning and are kept in `EngineConfig.unknown` so callers
can detect typos (the reference errors out — we stay permissive because
compile-time variant options of the reference are meaningless here).
"""

from __future__ import annotations

import os
import shlex
from typing import List, Optional

from julius_tpu_torch.config import (AMConfig, DNNConfig, EngineConfig, LMConfig,
                               SearchConfig, parse_feature_type)
from julius_tpu_torch.utils.jlog import LogLevel, jlog


def load_jconf_args(path: str):
    """Read a jconf file into an argv list (reference m_jconf.c
    config_file_parse: '#' comments, shell-style quoting).  Nested -C
    includes are left in the stream; JconfParser.parse() expands them
    with the correct per-file base directory.  Returns (args, base_dir);
    relative file arguments resolve against base_dir (reference
    behaviour)."""
    args: List[str] = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            args.extend(shlex.split(line))
    return args, base


class JconfParser:
    """Builds an EngineConfig from argv."""

    def __init__(self):
        self.cfg = EngineConfig(ams=[], lms=[], searches=[])
        self.base_dir = "."
        self._am: Optional[AMConfig] = None
        self._lm: Optional[LMConfig] = None
        self._sr: Optional[SearchConfig] = None
        self.unknown: List[str] = []

    # current (auto-created) section accessors -------------------------

    def am(self) -> AMConfig:
        if self._am is None:
            self._am = AMConfig()
            self.cfg.ams.append(self._am)
        return self._am

    def lm(self) -> LMConfig:
        if self._lm is None:
            self._lm = LMConfig()
            self.cfg.lms.append(self._lm)
        return self._lm

    def sr(self) -> SearchConfig:
        if self._sr is None:
            self._sr = SearchConfig()
            self.cfg.searches.append(self._sr)
        return self._sr

    def path(self, p: str) -> str:
        if not os.path.isabs(p) and self.base_dir != ".":
            q = os.path.join(self.base_dir, p)
            if os.path.exists(q):
                return q
        return p

    def parse(self, argv: List[str]) -> EngineConfig:
        i = 0
        a = argv
        n = len(a)

        def nxt(k=1):
            nonlocal i
            vals = a[i + 1: i + 1 + k]
            if len(vals) < k:
                raise ValueError(f"option {a[i]} needs {k} argument(s)")
            i += k
            return vals[0] if k == 1 else vals

        while i < n:
            o = a[i]
            if o == "-C":
                args, base = load_jconf_args(self.path(nxt()))
                old = self.base_dir
                self.base_dir = base
                self.parse(args)
                self.base_dir = old
            # ---- section markers (m_jconf.c -AM/-LM/-SR) -------------
            elif o == "-AM":
                self._am = AMConfig(name=nxt())
                self.cfg.ams.append(self._am)
            elif o == "-LM":
                self._lm = LMConfig(name=nxt())
                self.cfg.lms.append(self._lm)
            elif o == "-SR":
                name, amn, lmn = nxt(3)
                self._sr = SearchConfig(name=name, am_name=amn, lm_name=lmn)
                self.cfg.searches.append(self._sr)
            elif o in ("-AM_GMM", "-GLOBAL", "-nosectioncheck",
                       "-sectioncheck"):
                pass
            # ---- acoustic model --------------------------------------
            elif o == "-h":
                self.am().hmmdefs_path = self.path(nxt())
            elif o == "-hlist":
                self.am().hmmlist_path = self.path(nxt())
            elif o == "-dnnconf":
                from julius_tpu_torch.io.dnn import parse_dnnconf
                p = self.path(nxt())
                self.am().dnn = parse_dnnconf(p)
                self.am().dnn.base_dir = os.path.dirname(os.path.abspath(p))
            elif o == "-gprune":
                v = nxt()
                self.am().gprune = {"none": "none", "safe": "none",
                                    "beam": "topk", "heuristic": "topk",
                                    "default": "none"}.get(v, "none")
            elif o == "-tmix":
                self.am().gprune_num = int(nxt())
            elif o in ("-gshmm", "-hgs"):
                self.am().gshmm_path = self.path(nxt())
            elif o in ("-gsnum", "-booknum"):
                self.am().gsnum = int(nxt())
            elif o == "-iwcd1":
                v = nxt()
                self.am().iwcd_scheme = {"max": "max", "avg": "avg",
                                         "best": "best"}.get(v, "best")
                if v == "best":
                    self.am().iwcd_nbest = int(nxt())
            elif o in ("-force_ccd", "-no_ccd"):
                self.am().force_mono = (o == "-no_ccd")
            elif o in ("-spmodel", "-sp"):
                self.am().spmodel_name = nxt()
            elif o == "-multipath":
                # topology is derived from the model itself here (any
                # HTK transP decodes); accepted for parity
                self.am().multipath_forced = True
            elif o == "-sscalc":
                self.am().sscalc = True
            elif o == "-sscalclen":
                self.am().sscalc_len_ms = int(nxt())
            elif o == "-cmnupdate":
                self.am().cmn_update = True
            # ---- front-end (Value para options) ----------------------
            elif o == "-smpFreq":
                self.am().frontend.sample_rate = int(nxt())
            elif o == "-smpPeriod":
                self.am().frontend.sample_rate = int(1.0e7 / int(nxt()))
            elif o == "-fsize":
                fe = self.am().frontend
                fe.frame_ms = int(nxt()) * 1000.0 / fe.sample_rate
            elif o == "-fshift":
                fe = self.am().frontend
                fe.shift_ms = int(nxt()) * 1000.0 / fe.sample_rate
            elif o == "-preemph":
                self.am().frontend.preemph = float(nxt())
            elif o == "-fbank":
                self.am().frontend.fbank_num = int(nxt())
            elif o == "-ceplif":
                self.am().frontend.lifter = int(nxt())
            elif o == "-delwin":
                self.am().frontend.delta_win = int(nxt())
            elif o == "-accwin":
                self.am().frontend.accel_win = int(nxt())
            elif o == "-silfloor":
                self.am().frontend.silfloor_db = float(nxt())
            elif o == "-escale":
                self.am().frontend.escale = float(nxt())
            elif o == "-hifreq":
                self.am().frontend.hipass_hz = int(nxt())
            elif o == "-lofreq":
                self.am().frontend.lopass_hz = int(nxt())
            elif o == "-enormal":
                self.am().frontend.energy_normalize = True
            elif o == "-noenormal":
                self.am().frontend.energy_normalize = False
            elif o == "-rawe":
                self.am().frontend.raw_e = True
            elif o == "-norawe":
                self.am().frontend.raw_e = False
            elif o == "-zmeanframe":
                self.am().frontend.zmeanframe = True
            elif o == "-nozmeanframe":
                self.am().frontend.zmeanframe = False
            elif o == "-usepower":
                self.am().frontend.use_power = True
            elif o == "-nousepower":
                self.am().frontend.use_power = False
            elif o == "-lopass":
                self.am().frontend.lopass_hz = int(nxt())
            elif o == "-hipass":
                self.am().frontend.hipass_hz = int(nxt())
            elif o == "-novtln":
                fe = self.am().frontend
                fe.vtln_alpha = 1.0
                fe.vtln_lower = 100.0
                fe.vtln_upper = -1.0
            elif o == "-nocvn":
                self.am().frontend.cvn = False
            elif o == "-cvnstatic":
                self.am().frontend.cvn = True
                self.am().frontend.cvn_static = True
            elif o == "-vtln":
                al, lo, up = nxt(3)
                fe = self.am().frontend
                fe.vtln_alpha = float(al)
                fe.vtln_lower = float(lo)
                fe.vtln_upper = float(up)
            elif o == "-cvn":
                self.am().frontend.cvn = True
            elif o == "-cmnstatic":
                self.am().frontend.cmn_static = True
            elif o == "-cmnmapweight":
                self.am().frontend.cmn_map_weight = float(nxt())
            elif o in ("-cmnload", "-cmnsave"):
                setattr(self.am(), o[1:] + "_path", self.path(nxt()))
            elif o == "-ssload":
                self.am().ssload_path = self.path(nxt())
            elif o == "-ssalpha":
                self.am().frontend.ss_alpha = float(nxt())
            elif o == "-ssfloor":
                self.am().frontend.ss_floor = float(nxt())
            elif o == "-cmnnoupdate":
                self.am().cmn_update = False
            elif o == "-htkconf":
                self._parse_htkconf(self.path(nxt()))
            # ---- language model --------------------------------------
            elif o == "-v":
                self.lm().dict_path = self.path(nxt())
                self.lm().lmtype = "ngram"
            elif o == "-d":
                self.lm().ngram_path = self.path(nxt())
                self.lm().lmtype = "ngram"
            elif o in ("-nlr", "-lr"):
                self.lm().ngram_path = self.path(nxt())
                self.lm().lmtype = "ngram"
            elif o in ("-nrl", "-rl"):
                self.lm().ngram_backward_path = self.path(nxt())
                self.lm().lmtype = "ngram"
            elif o == "-gram":
                self.lm().gram_prefix = self.path(nxt())
                self.lm().lmtype = "grammar"
            elif o == "-gramlist":
                self.lm().gramlist_path = self.path(nxt())
                self.lm().lmtype = "grammar"
            elif o == "-dfa":
                self.lm().dfa_path = self.path(nxt())
                self.lm().lmtype = "grammar"
            elif o == "-w":
                self.lm().wordlist_path = self.path(nxt())
                self.lm().lmtype = "word"
            elif o == "-silhead":
                self.lm().head_silname = nxt()
            elif o == "-siltail":
                self.lm().tail_silname = nxt()
            elif o == "-mapunk":
                self.lm().unk_name = nxt()
            elif o == "-iwsp":
                self.lm().enable_iwsp = True
            elif o == "-iwsppenalty":
                self.lm().iwsp_penalty = float(nxt())
            elif o == "-iwspword":
                self.lm().enable_iwspword = True
            elif o == "-iwspentry":
                self.lm().iwspentry = nxt()
            elif o == "-adddict":
                self.lm().adddict_paths.append(self.path(nxt()))
            elif o == "-addentry":
                self.lm().addentries.append(nxt())
            elif o == "-forcedict":
                self.lm().forcedict = True
            elif o == "-wlist":
                self.lm().wordlist_path = self.path(nxt())
                self.lm().lmtype = "word"
            elif o == "-wsil":
                h, t, c = nxt(3)
                self.lm().wsil_head = h
                self.lm().wsil_tail = t
                self.lm().wsil_context = "" if c == "NULL" else c
            elif o == "-nogram":
                self.lm().ngram_path = None
                self.lm().ngram_backward_path = None
                self.lm().gram_prefix = None
                self.lm().gramlist_path = None
            # ---- search ----------------------------------------------
            elif o == "-lmp":
                w, p = nxt(2)
                self.sr().lm_weight = float(w)
                self.sr().lm_penalty = float(p)
            elif o == "-lmp2":
                w, p = nxt(2)
                self.sr().lm_weight2 = float(w)
                self.sr().lm_penalty2 = float(p)
            elif o == "-penalty1":
                self.sr().lm_penalty = float(nxt())
            elif o == "-penalty2":
                self.sr().lm_penalty2 = float(nxt())
            elif o == "-transp":
                self.sr().transparent_penalty = float(nxt())
            elif o == "-b":
                self.sr().beam_width = int(nxt())
            elif o in ("-b2", "-bw", "-wb"):
                # word envelope width in pass 2 (reference m_options.c:
                # enveloped_bestfirst_width; wb_ok)
                self.sr().word_envelope = int(nxt())
            elif o == "-n":
                self.sr().nbest = int(nxt())
            elif o == "-output":
                self.sr().output_n = int(nxt())
            elif o == "-m":
                self.sr().max_hypo_pop = int(nxt())
            elif o == "-s":
                self.sr().stack_size = int(nxt())
            elif o == "-sb":
                self.sr().scan_beam = float(nxt())
            elif o == "-lookuprange":
                self.sr().lookup_range = int(nxt())
            elif o == "-1pass":
                self.sr().enable_pass2 = False
                self.sr().one_pass = True
            elif o == "-walign":
                self.sr().align_word = True
            elif o == "-palign":
                self.sr().align_phoneme = True
            elif o == "-salign":
                self.sr().align_state = True
            elif o == "-cmalpha":
                self.sr().cm_alpha = float(nxt())
                self.sr().compute_confidence = True
            elif o == "-lattice":
                self.sr().graph_out = True
            elif o == "-nolattice":
                self.sr().graph_out = False
            elif o == "-confnet":
                self.sr().confnet_out = True
            elif o == "-noconfnet":
                self.sr().confnet_out = False
            elif o == "-mbr":
                self.sr().mbr = True
            elif o == "-nombr":
                self.sr().mbr = False
            elif o == "-mbr_wwer":
                self.sr().mbr = True
                self.sr().mbr_use_word_weights = True
            elif o == "-mbr_weight":
                self.sr().mbr_score_scale = float(nxt())
            elif o == "-bs":
                # pass-1 score-pruning beam (reference SCORE_PRUNING)
                self.sr().score_prune_width = float(nxt())
            elif o == "-graphout":
                self.sr().graph_out = True
            elif o == "-graphrange":
                self.sr().graph_range = int(nxt())
            elif o == "-graphcut":
                self.sr().graph_cut_depth = int(nxt())
            elif o == "-graphboundloop":
                self.sr().graph_bound_loop = int(nxt())
            elif o == "-graphsearchdelay":
                self.sr().graph_search_delay = True
            elif o == "-nographsearchdelay":
                self.sr().graph_search_delay = False
            elif o == "-cmthres":
                self.sr().cm_thres = float(nxt())
                self.sr().compute_confidence = True
            elif o == "-cmthres2":
                self.sr().cm_thres2 = float(nxt())
            elif o == "-multigramout":
                self.sr().multigram_out = True
            elif o == "-nomultigramout":
                self.sr().multigram_out = False
            elif o == "-active":
                self.sr().start_inactive = False
            elif o == "-inactive":
                self.sr().start_inactive = True
            elif o == "-fallback1pass":
                # pass-2 failure already falls back to the pass-1 result
                # (engine.py _results, reference
                # pass2_finalize_on_no_result)
                self.sr().fallback_1pass = True
            elif o == "-looktrellis":
                # expansion is always restricted to trellis words here
                # (pass2_rescan candidate sets); accepted for parity
                pass
            elif o == "-nlimit":
                jlog(LogLevel.WARNING,
                     "-nlimit applies to the reference's WPAIR build "
                     "variant only; ignored (flat-lexicon pass 1 keeps "
                     "one path per node like the non-WPAIR default)")
                nxt()
            elif o == "-wed":
                # isolated-word early determination params (reference
                # DETERMINE build); recorded only
                nxt(2)
            # ---- input / global --------------------------------------
            elif o == "-input":
                self.cfg.input_source = nxt()
            elif o == "-filelist":
                self.cfg.filelist_path = self.path(nxt())
            elif o == "-rejectshort":
                self.cfg.reject_short_ms = int(nxt())
            elif o == "-rejectlong":
                self.cfg.reject_long_ms = int(nxt())
            # ---- GMM verification / VAD (m_options.c:1218-1250) ------
            elif o == "-gmm":
                self.cfg.gmm_path = self.path(nxt())
            elif o == "-gmmnum":
                self.cfg.gmm_num = int(nxt())
            elif o == "-gmmreject":
                self.cfg.gmm_reject = [s for s in nxt().split(",") if s]
            elif o == "-gmmmargin":
                self.cfg.gmm_margin = int(nxt())
                self.cfg.gmm_vad = True
            elif o == "-gmmup":
                self.cfg.gmm_up = float(nxt())
                self.cfg.gmm_vad = True
            elif o == "-gmmdown":
                self.cfg.gmm_down = float(nxt())
                self.cfg.gmm_vad = True
            elif o == "-gmmnoise":
                # VAD noise-model names (our runtime split of the
                # reference's compile-time GMM_VAD: noise models double
                # as the reject set there)
                self.cfg.gmm_noise_names = \
                    [s for s in nxt().split(",") if s]
                self.cfg.gmm_vad = True
            elif o == "-powerthres":
                self.cfg.power_thres = float(nxt())
            elif o == "-lv":
                self.cfg.vad_level = int(nxt())
            elif o == "-zc":
                self.cfg.vad_zc = int(nxt())
            elif o == "-headmargin":
                self.cfg.vad_head_ms = int(nxt())
            elif o == "-tailmargin":
                self.cfg.vad_tail_ms = int(nxt())
            elif o == "-fvad":
                # sub-band SNR VAD gate (reference HAVE_LIBFVAD -fvad)
                self.cfg.fvad_mode = int(nxt())
            elif o == "-fvad_param":
                self.cfg.fvad_smooth = int(nxt())
                self.cfg.fvad_thres = float(nxt())
            elif o == "-nocutsilence":
                self.cfg.use_vad = False
            elif o == "-cutsilence":
                self.cfg.use_vad = True
            elif o == "-batchsize":
                self.cfg.batch_size = int(nxt())
            elif o == "-module":
                self.cfg.module_port = int(nxt()) \
                    if i + 1 < n and a[i + 1].isdigit() else 10500
            elif o == "-adport":
                self.cfg.adinnet_port = int(nxt())
            elif o in ("-outfile",):
                self.cfg.outfile = True
            elif o == "-outprobout":
                self.cfg.outprob_out = self.path(nxt())
            elif o == "-logfile":
                self.cfg.logfile = self.path(nxt())
            elif o == "-separatescore":
                self.cfg.separatescore = True
            elif o == "-record":
                self.cfg.record_dir = self.path(nxt())
            elif o == "-charconv":
                frm, to = nxt(2)
                self.cfg.charconv = (frm, to)
            elif o == "-nocharconv":
                self.cfg.charconv = None
            elif o == "-kanji":
                # reference: output charset only (input assumed model charset)
                self.cfg.charconv = ("utf-8", nxt())
            elif o == "-progout":
                self.cfg.progout = True
            elif o == "-proginterval":
                self.cfg.proginterval_ms = int(nxt())
            elif o == "-zmean":
                self.cfg.zmean = True
            elif o == "-nozmean":
                self.cfg.zmean = False
            elif o == "-lvscale":
                self.cfg.level_coef = float(nxt())
            elif o == "-48":
                self.cfg.ds48 = True
            elif o == "-nostrip":
                self.cfg.nostrip = True
            elif o == "-notypecheck":
                self.cfg.typecheck = False
            elif o == "-chunksize":
                self.cfg.chunk_size = int(nxt())
            elif o in ("-realtime", "-force_realtime"):
                self.cfg.force_realtime = True
            elif o == "-norealtime":
                self.cfg.force_realtime = False
            elif o in ("-spsegment", "-pausesegment"):
                self.cfg.spsegment = True
            elif o == "-nopausesegment":
                self.cfg.spsegment = False
            elif o == "-spdur":
                self.cfg.sp_frame_duration = int(nxt())
            elif o == "-pausemodels":
                self.cfg.pause_models = [x for x in nxt().split(",") if x]
            elif o in ("-spmargin", "-spdelay"):
                # decoder-VAD rewind margin/delay (reference SPSEGMENT_
                # NAIST); the streaming rewind keeps the whole trigger
                # buffer so margins need no tuning — recorded only
                nxt()
            elif o == "-check":
                self.cfg.check_modes.append(nxt())
            elif o in ("-version", "-setting"):
                self.cfg.check_modes.append("info")
            elif o == "-userlm":
                jlog(LogLevel.STAT,
                     "-userlm: register the LM via "
                     "Engine.register_user_lm (jfunc parity)")
            elif o == "-discount":
                jlog(LogLevel.WARNING,
                     "option \"-discount\" is bogus, ignored "
                     "(reference m_options.c:593)")
            elif o in ("-oldtree", "-sepnum", "-iwcache", "-hugesize",
                       "-separatescore_off"):
                # shared-prefix-tree build internals (wchmm.c); the flat
                # lexicon has no equivalent structure
                jlog(LogLevel.WARNING,
                     f"{o} shapes the reference's tree lexicon; the "
                     "flat device lexicon has no equivalent, ignored")
                if i + 1 < n and not a[i + 1].startswith("-"):
                    i += 1
            elif o == "-NA":
                jlog(LogLevel.WARNING,
                     "-NA (DatLink NetAudio) is not supported; use "
                     "-input adinnet")
                nxt()
            elif o == "-callbackdebug":
                self.cfg.debug = True
            elif o in ("-quiet", "-demo"):
                self.cfg.quiet = True
            elif o == "-debug":
                self.cfg.debug = True
            elif o == "-nolog":
                self.cfg.logfile = os.devnull
            elif o == "-plugindir":
                # colon-separated list (reference plugin_load_dirs)
                self.cfg.plugin_dirs.extend(
                    self.path(p) for p in nxt().split(":") if p)
            else:
                self.unknown.append(o)
                jlog(LogLevel.WARNING, f"unknown option ignored: {o}")
                # skip one value if the next token is not an option
                if i + 1 < n and not a[i + 1].startswith("-"):
                    i += 1
            i += 1
        return self.cfg

    def _parse_htkconf(self, path: str):
        """HTK Config import (reference htk_config_file_parse,
        libsent/src/wav2mfcc/para.c)."""
        fe = self.am().frontend
        with open(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if "=" not in line:
                    continue
                k, v = [x.strip() for x in line.split("=", 1)]
                ku = k.upper()
                if ku == "SOURCERATE":
                    fe.sample_rate = int(1.0e7 / float(v))
                elif ku == "TARGETKIND":
                    new = parse_feature_type(v, fe)
                    for f_ in ("feature_type", "use_energy", "use_c0",
                               "use_delta", "use_accel", "absesup", "cmn"):
                        setattr(fe, f_, getattr(new, f_))
                elif ku == "TARGETRATE":
                    fe.shift_ms = float(v) / 10000.0
                elif ku == "WINDOWSIZE":
                    fe.frame_ms = float(v) / 10000.0
                elif ku == "PREEMCOEF":
                    fe.preemph = float(v)
                elif ku == "NUMCHANS":
                    fe.fbank_num = int(v)
                elif ku == "CEPLIFTER":
                    fe.lifter = int(v)
                elif ku == "NUMCEPS":
                    fe.mfcc_dim = int(v)
                elif ku == "DELTAWINDOW":
                    fe.delta_win = int(v)
                elif ku == "ACCWINDOW":
                    fe.accel_win = int(v)
                elif ku == "LOFREQ":
                    fe.lopass_hz = int(float(v))
                elif ku == "HIFREQ":
                    fe.hipass_hz = int(float(v))
                elif ku == "SILFLOOR":
                    fe.silfloor_db = float(v)
                elif ku == "ESCALE":
                    fe.escale = float(v)
                elif ku == "ZMEANSOURCE":
                    fe.zmeanframe = v.upper() in ("T", "TRUE")
                elif ku == "USEPOWER":
                    fe.use_power = v.upper() in ("T", "TRUE")
                elif ku == "ENORMALISE":
                    fe.energy_normalize = v.upper() in ("T", "TRUE")
                elif ku == "RAWENERGY":
                    fe.raw_e = v.upper() in ("T", "TRUE")


def parse_jconf(argv: List[str], base_dir: str = ".") -> EngineConfig:
    p = JconfParser()
    p.base_dir = base_dir
    cfg = p.parse(argv)
    cfg.unknown = p.unknown
    if not cfg.ams:
        cfg.ams.append(AMConfig())
    if not cfg.lms:
        cfg.lms.append(LMConfig())
    if not cfg.searches:
        cfg.searches.append(SearchConfig())
    return cfg
