"""Recognition engine: model fusion + batched decoding (torch).

Port of `julius_tpu/engine.py`: waveform -> front end (frontend/mfcc.py)
-> senone scores, from a DNN (ops/dnn.py) or from Gaussian mixtures
(ops/gmm.py, with Gaussian mixture selection by ops/gms.py), plus the
pseudo-phone-set columns of triphone networks (ops/gmm.py) -> pass 1
(search/pass1.py: the ops/pass1_kernel.py beam-update kernel where the
reference takes its fused kernel, its unfused step elsewhere) -> pass 2
-> N-best, with the word graph, confusion network, MBR re-ranking and
search-time confidence of search/graphout.py, and forced word, phoneme
and state alignments of the result (search/align.py, -walign / -palign
/ -salign); decoding may also start from features or from outprobs.
Input rejection by length, by average power (-powerthres) and by GMM
verification (`gmm_frontend`, frontend/gmm_frontend.py) runs before
pass 2.  Three LM modes: an N-gram, a DFA grammar (io/dfa.py; category
pairs constrain pass 1, the automaton pass 2) and isolated words (no
cross-word entry, no pass 2).  Pass 2 is the
reference's default, the acoustic re-scan A* on the device
(search/pass2_device.py, whose word scans run the ops/scan_kernel.py
kernel) with its retry/spot-check net through the host-driven re-scan
(search/pass2_rescan.py), which is also the grammar mode's re-scan;
`pass2_device=False` takes the host-driven re-scan alone, and
`pass2_rescan=False` the frozen-score stack search (search/pass2.py);
`strict_iwcd2` resolves word-head triphones against the previous word
in both re-scans (search/iwcd2.py).  A backward (RL) N-gram drives pass
2 through the frozen backward stack search (`pass2_search_backward`)
while pass 1 runs its forward 2-gram (`lm_forward`, or the pair inside
an RL bingram); `register_user_lm` replaces the pass-2 LM with an
application function.  One Engine = one AM + one LM (pass 2) with its
pass-1 view + one search config; it owns the device tables.  Live
input decodes through streaming.py's StreamSession over an Engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from julius_tpu_torch.cache import build_network_cached
from julius_tpu_torch.config import AMConfig, FrontendConfig, SearchConfig
from julius_tpu_torch.frontend import mfcc as fe
from julius_tpu_torch.frontend.gmm_frontend import power_reject
from julius_tpu_torch.io.arpa import NGramLM, forward_view
from julius_tpu_torch.io.dfa import DFAGrammar
from julius_tpu_torch.io.dnn import DNNParams
from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.ops import pseudo_kernel
from julius_tpu_torch.ops.dnn import DNNScorer, build_dnn_scorer
from julius_tpu_torch.ops.gmm import (GMMScorerTables, aggregate_pseudo,
                                      build_gmm_tables, chunk_rows,
                                      senone_scores)
from julius_tpu_torch.ops.gms import GMSTables, build_gms, gms_senone_scores
from julius_tpu_torch.search import graphout as go
from julius_tpu_torch.search.align import Alignment, forced_align
from julius_tpu_torch.search import pass1 as p1
from julius_tpu_torch.search import pass2 as p2
from julius_tpu_torch.search import pass2_device as p2d
from julius_tpu_torch.search import pass2_rescan as p2r
from julius_tpu_torch.search.iwcd2 import StrictIWCDTables, build_rc_tables
from julius_tpu_torch.search.network import DecodeNetwork, build_network
from julius_tpu_torch.search.scan import ChainCache, DeviceChainTables
from julius_tpu_torch.search.ngram_device import (DeviceNgram,
                                                  build_device_ngram)
from julius_tpu_torch.utils import trace
from julius_tpu_torch.utils.callback import CallbackRegistry
from julius_tpu_torch.utils.device import resolve_device
from julius_tpu_torch.utils.jlog import LogLevel, jlog


@dataclass
class Result:
    """One utterance's recognition output (reference Sentence / RecogProcess
    result block)."""

    words: List[str] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)   # output strings (woutput)
    word_ids: List[int] = field(default_factory=list)
    score: float = 0.0
    am_score: float = 0.0
    lm_score: float = 0.0
    segments: List[dict] = field(default_factory=list)
    alignment: Optional[Alignment] = None   # -walign/-palign/-salign
    cm: Optional[List[float]] = None      # per-word confidence
    nbest: List["Result"] = field(default_factory=list)
    graph: Optional[go.WordGraph] = None      # graph_out
    confnet: Optional[List[go.CNCluster]] = None   # confnet_out
    from_pass: int = 1
    valid: bool = True
    reject_reason: Optional[str] = None


class Engine:
    """One recognition instance (DNN or GMM AM + N-gram, DFA grammar or
    word list + search)."""

    def __init__(
        self,
        hmm: HMMSet,
        voca: Vocabulary,
        lm: Optional[NGramLM] = None,
        dnn: Optional[DNNParams] = None,
        frontend: Optional[FrontendConfig] = None,
        search: Optional[SearchConfig] = None,
        am_cfg: Optional[AMConfig] = None,
        dfa: Optional[DFAGrammar] = None,
        word_cat: Optional[np.ndarray] = None,
        lmtype: Optional[str] = None,
        iwsp: bool = False,
        sp_name: str = "sp",
        iwsp_penalty: float = -1.0,
        lm_forward: Optional[NGramLM] = None,
        use_cache: bool = False,
        gshmm: Optional[HMMSet] = None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # the alignment Viterbi's captured graphs (search/align.py),
        # made at the first alignment on a CUDA card
        self.align_graphs = None
        if dfa is not None and word_cat is None:
            raise ValueError("a DFA grammar needs word_cat, the category "
                             "of each dictionary word")
        if lmtype is None:
            lmtype = ("ngram" if lm is not None
                      else "grammar" if dfa is not None else "word")
        self.am_cfg = am_cfg or AMConfig()
        self.hmm = hmm
        self.voca = voca
        self.lm = lm            # pass-2 LM (forward or backward/RL)
        # pass 1 always runs a forward 2-gram: the reference pairs one
        # with the backward N-gram (m_fusion.c initialize_ngram)
        self.lm_p1 = (forward_view(lm, lm_forward)
                      if lm is not None and lm.direction == "RL" else lm)
        self.dfa = dfa
        self.word_cat = word_cat
        self.lmtype = lmtype
        self.search_cfg = search or SearchConfig()
        self.fe_cfg = frontend or FrontendConfig()
        self.fe_tables = fe.build_tables(self.fe_cfg)
        self.noise_spectrum: Optional[torch.Tensor] = None   # -ssload
        sc = self.search_cfg

        self._resolve_silwords()
        self._wid2lm = self._map_vocab_to_lm(self.lm_p1)
        # pass 2 may use another id space (separate -nlr / -nrl ARPAs)
        self._wid2lm_p2 = (self._wid2lm if self.lm is self.lm_p1
                           else self._map_vocab_to_lm(self.lm))

        use_tri = hmm.names_are_triphone and not self.am_cfg.force_mono
        net_kwargs = dict(use_triphone=use_tri, iwsp=iwsp, sp_name=sp_name,
                          iwsp_penalty=iwsp_penalty)
        self.net: DecodeNetwork = (
            build_network_cached(hmm, voca, **net_kwargs) if use_cache
            else build_network(hmm, voca, **net_kwargs))
        self.ngram_dev: Optional[DeviceNgram] = (
            build_device_ngram(self.lm_p1, self.device)
            if self.lm_p1 is not None else None)
        self.final_mask: Optional[np.ndarray] = None
        cpair = cat_init = cat_final = None
        if dfa is not None:
            cpair, cat_init, cat_final = dfa.category_pair_matrix()
            # the .dfa is the reversed automaton: cp_end marks the
            # categories that may END the spoken sentence
            self.final_mask = cat_final[word_cat]
        elif lmtype == "word":
            # isolated-word recognition: any word may end the input
            self.final_mask = np.ones(voca.n_words, dtype=bool)
        transparent = np.asarray(voca.transparent, dtype=bool) \
            if voca.transparent else None
        rc_tables = None
        if self.am_cfg.head_rc_dynamic and use_tri:
            rc_tables = build_rc_tables(self.net, hmm, voca,
                                        use_triphone=True)
        self.dev_net = p1.build_device_network(
            self.net, self.device, self.ngram_dev, self._wid2lm,
            lm_weight=sc.lm_weight, lm_penalty=sc.lm_penalty,
            word_cat=word_cat, cpair=cpair, cat_init=cat_init,
            cat_final=cat_final, transparent=transparent,
            transparent_penalty=sc.transparent_penalty,
            cprob=self._cprob_arr(), rc_tables=rc_tables)
        trellis_topm = sc.trellis_topm
        if trellis_topm <= 0:
            # auto-size M with the vocabulary: the reference's
            # backtrellis keeps every survivor word-end per frame, so a
            # fixed per-frame cap must grow with how many words can
            # plausibly end at once (computed into a local, not written
            # back to a SearchConfig that engines may share)
            trellis_topm = int(
                min(256, max(64, -(-voca.n_words // 160) // 32 * 32 + 32)))
        self.p1_cfg = p1.Pass1Config(
            n_atoms=trellis_topm,
            lm_weight=sc.lm_weight,
            lm_penalty=sc.lm_penalty,
            beam_width=float(sc.beam_width) if sc.beam_width else 0.0,
            use_lm=lm is not None,
            use_dfa=dfa is not None,
            crossword=(lmtype != "word"),
            factoring=sc.factoring,
            expand_k=sc.crossword_topk,
        )

        self.callbacks = CallbackRegistry()
        # input-rejection hooks (reference recogmain.c:1106-1256, gmm.c
        # rejection; set as attributes or by the fusion layer)
        self.gmm_frontend = None          # frontend.gmm_frontend.GMMFrontend
        self.reject_short_frames: int = 0
        self.reject_long_frames: int = 0
        self.power_thres: float = 0.0     # -powerthres (0 = off)

        # acoustic scorer: the DNN, else the GMM of the HMM set (with the
        # -gshmm selector model)
        self.dnn_params = dnn
        self.dnn_scorer: Optional[DNNScorer] = None
        self.gmm_tables: Optional[GMMScorerTables] = None
        self.gms: Optional[GMSTables] = None
        if dnn is not None:
            self.dnn_scorer = build_dnn_scorer(dnn, self.device)
            # senone s reads DNN output column state_sid[s]
            self._state_sid = torch.as_tensor(
                np.asarray(hmm.state_sid), dtype=torch.int64,
                device=self.device)
        else:
            self.gmm_tables = build_gmm_tables(hmm, self.device)
            if gshmm is not None:
                self.gms = build_gms(hmm, gshmm, self.am_cfg.gsnum,
                                     self.device)
        self._setup_pseudo_arrays()
        self._device_chains = None  # lazy search.scan.DeviceChainTables
        self._chain_cache = None    # lazy search.scan.ChainCache
        self._iwcd2_tables = None   # lazy search.iwcd2.StrictIWCDTables
        self._rescan_warned = False
        self._p2d_best_in = None    # cached pass2_device._best_lm_in
        self._p2d_spot_ok = 0       # device-A* spot-checks passed
        # the wall of the last batch's retry net, and how many
        # utterances the net re-ran on the host path
        self.last_pass2 = {"retry_s": 0.0, "retried": 0}

    # -- setup helpers ----------------------------------------------------

    def _resolve_silwords(self):
        names = {n: i for i, n in enumerate(self.voca.names)}
        self.voca.head_silword = names.get("<s>", names.get("silB", 0))
        self.voca.tail_silword = names.get("</s>", names.get("silE", 0))

    def _map_vocab_to_lm(self, lm) -> Optional[np.ndarray]:
        if lm is None:
            return None
        out = np.full(self.voca.n_words, -1, dtype=np.int32)
        n_miss = 0
        for i, name in enumerate(self.voca.names):
            wid = lm.word_index.get(name, lm.unk_id)
            if wid < 0:
                n_miss += 1
            out[i] = wid
        if n_miss:
            jlog(LogLevel.WARNING,
                 f"{n_miss} dictionary words not in N-gram and no <unk> "
                 "entry; they get zero LM probability")
        return out

    def _setup_pseudo_arrays(self) -> None:
        """(members, segids, Q') of the network's pseudo set-states on
        the device, or None: their scores are the outprob cache's
        columns after the senones'.  The plain version reads members
        and segids (int64); the card's kernel its sliced int32 member
        table, `_pseudo_kernel`, built here once."""
        ps = self.net.pseudo
        if ps is not None and ps.n_set_states > 0:
            segids = np.repeat(np.arange(ps.n_set_states, dtype=np.int64),
                               np.diff(ps.member_ofs))
            self._pseudo = (
                torch.as_tensor(np.asarray(ps.members), dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(segids, device=self.device),
                int(ps.n_set_states))
            self._pseudo_kernel = pseudo_kernel.build_tables(
                ps.members, ps.member_ofs, self.device)
        else:
            self._pseudo = self._pseudo_kernel = None

    def _cprob_arr(self) -> Optional[np.ndarray]:
        return (np.asarray(self.voca.cprob, dtype=np.float32)
                if self.voca.cprob and any(self.voca.cprob) else None)

    def _want_p2_graph(self) -> bool:
        """Configurations that collect the pass-2 word graph during the
        rescanned search (reference graphout.c during-search
        generation; also feeds CM_SEARCH-style confidence)."""
        sc = self.search_cfg
        return sc.graph_out or sc.confnet_out or sc.cm_search

    def _rescan_ok(self) -> bool:
        """True when pass 2 should re-derive acoustics with scan_word
        (reference search_bestfirst_v1.c:589): N-gram and grammar modes;
        a backward (RL) N-gram keeps the frozen-score search.  AMs whose
        in-word topology is not left-to-right (backward arcs, which the
        shift-structured chain scan cannot express) fall back to the
        frozen-score search instead of raising mid-decode."""
        if not self.search_cfg.pass2_rescan:
            return False
        if self.lmtype == "grammar":
            if self.dfa is None:
                return False
        elif self.lmtype == "ngram":
            if self.lm is not None and self.lm.direction == "RL":
                return False
        else:
            return False
        try:
            self.device_chains
        except ValueError as e:
            if not self._rescan_warned:
                jlog(LogLevel.WARNING,
                     f"pass-2 re-scan disabled for this AM ({e}); "
                     "using frozen pass-1 acoustic scores")
                self._rescan_warned = True
            return False
        return True

    @property
    def device_chains(self) -> DeviceChainTables:
        """Whole-vocabulary scan_word chain tables on the engine's device
        (built once).  A topology rejection is cached and re-raised
        without rebuilding."""
        if isinstance(self._device_chains, ValueError):
            raise self._device_chains
        if self._device_chains is None:
            try:
                self._device_chains = DeviceChainTables(self.net,
                                                        self.device)
            except ValueError as e:
                self._device_chains = e
                raise
        return self._device_chains

    @property
    def chain_cache(self) -> ChainCache:
        """Per-word chain tables on the host, built lazily word by word
        (search.scan.ChainCache, for the full-utterance scan)."""
        if self._chain_cache is None:
            self._chain_cache = ChainCache(self.net)
        return self._chain_cache

    @property
    def iwcd2_tables(self) -> Optional[StrictIWCDTables]:
        """Strict inter-word CD head tables for the re-scans
        (search/iwcd2.py), built on first use when
        SearchConfig.strict_iwcd2 is set; None until then."""
        if self._iwcd2_tables is None and self.search_cfg.strict_iwcd2:
            use_tri = (self.hmm.names_are_triphone
                       and not self.am_cfg.force_mono)
            self._iwcd2_tables = StrictIWCDTables(
                self.net, self.hmm, self.voca, use_triphone=use_tri,
                device=self.device)
        return self._iwcd2_tables

    def _device_astar_ok(self) -> bool:
        """True when the second pass can run fully on the device
        (search/pass2_device.py): a forward N-gram of order <= 2 shared
        with pass 1, no transparent-word LM context skipping, at most
        NB_SLOTS sentences, and no during-search graph collection.  Everything
        else keeps the host-driven re-scan (pass2_rescan.py), which
        implements the full semantics."""
        sc = self.search_cfg
        if not sc.pass2_device or self.lmtype != "ngram":
            return False
        if self.lm is None or self.lm is not self.lm_p1 \
                or self.ngram_dev is None:
            return False
        if getattr(self.lm, "order", 99) > 2:
            return False
        if self._want_p2_graph():
            return False
        if self.voca.transparent and any(self.voca.transparent):
            return False
        return sc.nbest <= p2d.NB_SLOTS

    def _rescan_strategy(self):
        """The host re-scan's LM: the DFA's reverse-NFA state sets for a
        grammar, else the N-gram."""
        if self.lmtype == "grammar":
            return p2r.DfaStrategy(self.dfa, self.word_cat, self.search_cfg)
        transparent = np.asarray(self.voca.transparent, dtype=bool) \
            if self.voca.transparent else None
        return p2r.NgramStrategy(self.lm, self._wid2lm_p2, self.search_cfg,
                                 self.net.tail_word, transparent,
                                 self._cprob_arr())

    def _dispatcher(self, out_ext: torch.Tensor) -> p2r.ScanDispatcher:
        return p2r.ScanDispatcher(self.device_chains, out_ext,
                                  self.search_cfg.scan_beam,
                                  iwcd2=self.iwcd2_tables)

    # -- device compute path ----------------------------------------------

    def _senones(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] features -> [B, T, S] senone score rows."""
        if self.dnn_scorer is not None:
            out = self.dnn_scorer(feats)                 # [B, T, n_out]
            return out.index_select(-1, self._state_sid)
        am = self.am_cfg
        topk = am.gprune_num if am.gprune == "topk" else 0
        if self.gms is not None:
            return gms_senone_scores(self.gmm_tables, self.gms, feats,
                                     topk=topk)
        return senone_scores(self.gmm_tables, feats, topk=topk)

    def _outprob(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] features -> [B, T, R] extended outprob rows."""
        with trace.span("dnn"):
            return self._extend(self._senones(feats))

    def _extend(self, rows: torch.Tensor) -> torch.Tensor:
        """[B, T, S] senone rows -> [B, T, S + Q'] with the pseudo
        set-states' scores appended (iwcd1 scheme of the AM config): on
        a card one kernel launch writes the extended rows, on the CPU
        the plain version's chunks and a concatenation."""
        if self._pseudo is None:
            return rows
        mem, seg, nq = self._pseudo
        launches = pseudo_kernel.LAUNCHES
        with trace.span("dnn.pseudo"):
            out = aggregate_pseudo(mem, seg, nq, rows,
                                   self.am_cfg.iwcd_scheme,
                                   self.am_cfg.iwcd_nbest,
                                   tables=self._pseudo_kernel, extend=True)
        if trace.enabled():
            n = rows[..., 0].numel()
            launched = pseudo_kernel.LAUNCHES - launches
            trace.count("pseudo.rows", n)
            trace.count("pseudo.kernel", launched)
            trace.count("pseudo.chunks", launched if rows.is_cuda else
                        -(-n // chunk_rows(n, int(mem.shape[0]))))
        return out

    def _features(self, wave: torch.Tensor, lengths: torch.Tensor):
        """[B, L] waveforms -> (scorer input [B, T, D], spliced to D *
        context for a DNN, and the [B, T] frame mask)."""
        feats, mask = fe.extract_features(
            wave, lengths, self.fe_tables,
            noise_spectrum=self.noise_spectrum)
        if self.dnn_scorer is not None:
            feats = fe.splice_frames(feats, mask,
                                     self.dnn_params.context_len)
        return feats, mask

    def _decode_device(self, wave: torch.Tensor, lengths: torch.Tensor):
        """Front end -> splice -> outprobs -> pass 1 on the device:
        (trellis, [B] frame counts, [B, T, R] outprob cache, which
        doubles as pass 2's)."""
        feats, mask = self._features(wave, lengths)
        nfr = mask.to(torch.int32).sum(dim=-1)
        out_ext = self._outprob(feats)
        return self._pass1(out_ext, nfr), nfr, out_ext

    def _reject(self, feats_b: Optional[np.ndarray], n: int) -> Optional[str]:
        """Input rejection checks on one utterance's [T, D] base features
        (None when there are none to check); returns a reason or None
        (reference recogmain.c short/long rejection + gmm_valid_input)."""
        if self.reject_short_frames and n < self.reject_short_frames:
            return "too short"
        if self.reject_long_frames and n > self.reject_long_frames:
            return "too long"
        if self.power_thres > 0.0 and feats_b is not None \
                and self.fe_cfg.use_energy:
            # absolute energy sits last in the static block (mfcc.py
            # layout; reference POWER_REJECT avg_power, pass1.c:321);
            # clamped for externally supplied feature widths
            idx = min(self.fe_cfg.base_dim, feats_b.shape[-1]) - 1
            if power_reject(feats_b[:n], idx, self.power_thres):
                return "low power"
        if self.gmm_frontend is not None and feats_b is not None:
            g = self.gmm_frontend.verify(feats_b[:n])
            if not g.accepted:
                return f"GMM rejected ({g.best_name})"
        return None

    def _want_rejection_features(self) -> bool:
        return self.gmm_frontend is not None or self.power_thres > 0.0

    def _pass1(self, out_ext: torch.Tensor, n_frames) -> p1.Trellis:
        with trace.span("pass1"):
            nfr = torch.as_tensor(n_frames, dtype=torch.int32,
                                  device=self.device)
            return p1.pass1_batch(self.dev_net, self.ngram_dev, self.p1_cfg,
                                  out_ext, nfr)

    def decode_features(self, feats, n_frames) -> List[Result]:
        """Decode pre-extracted features [B, T, D] (numpy or torch) with
        [B] valid frame counts (reference mfcfile / vecnet feature input
        paths)."""
        with trace.span("decode"):
            with trace.span("features.h2d"):
                feats = torch.as_tensor(feats, dtype=torch.float32,
                                        device=self.device)
            nfr = np.asarray(torch.as_tensor(n_frames).cpu())
            # rejection hooks see the base features (mfcfile input passes
            # through GMM verification in the reference too); DNN-spliced
            # rows have the wrong width for the GMM's own models
            feats_rej = None
            if self._want_rejection_features() and self.dnn_scorer is None:
                feats_rej = feats.cpu().numpy()
            with torch.no_grad():
                # out_ext doubles as the pass-2 outprob cache
                out_ext = self._outprob(feats)
                trellis = self._pass1(out_ext, n_frames)
                results = self._results(trellis, nfr, feats_rej,
                                        out_ext=out_ext)
            self._maybe_align(results, feats, nfr)
            return results

    def _maybe_align(self, results: List[Result], feats,
                     nfr: np.ndarray) -> None:
        """Attach forced alignments when -walign/-palign/-salign are set
        (reference do_alignment_all, word_align.c:547; the alignment
        also refines word boundaries beyond the pass-1 Viterbi ones).
        A failed alignment is logged and the result kept without one, as
        the reference does."""
        sc = self.search_cfg
        if not (sc.align_word or sc.align_phoneme or sc.align_state):
            return
        for b, r in enumerate(results):
            if r.valid and r.word_ids:
                try:
                    r.alignment = self.align(feats[b], int(nfr[b]),
                                             r.word_ids)
                except Exception as e:
                    jlog(LogLevel.WARNING, f"alignment failed: {e}")

    def align(self, feats, n_frames: int, word_ids: List[int]) -> Alignment:
        """Forced alignment of one utterance's [T, D] scorer input
        against a transcript (reference -walign/-palign/-salign,
        word_align.c:547)."""
        return forced_align(self, feats, n_frames, word_ids)

    def compute_outprob(self, feats) -> np.ndarray:
        """[B, T, D] features -> [B, T, S] senone score rows on the host
        (the -outprobout dump, reference recogmain.c:1225-1242)."""
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        with torch.no_grad():
            return self._senones(feats).cpu().numpy()

    def decode_outprob(self, rows, n_frames) -> List[Result]:
        """Decode directly from state output probabilities [B, T, S]
        (reference SP_OUTPROBFILE input / vecnet outprob_p mode)."""
        with trace.span("decode"), torch.no_grad():
            rows = torch.as_tensor(rows, dtype=torch.float32,
                                   device=self.device)
            out_ext = self._extend(rows)
            trellis = self._pass1(out_ext, n_frames)
            return self._results(trellis, np.asarray(torch.as_tensor(
                n_frames).cpu()), out_ext=out_ext)

    def set_noise_spectrum(self, spec) -> None:
        """Install a -ssload noise spectrum for spectral subtraction in
        the front end (None removes it)."""
        self.noise_spectrum = None if spec is None else torch.as_tensor(
            spec, dtype=torch.float32, device=self.device)

    def recognize_batch(self, wave, lengths) -> List[Result]:
        """Batched file-input recognition: [B, L] int16/float waveforms
        with [B] sample counts."""
        with trace.span("decode"), torch.no_grad():
            wave = torch.as_tensor(wave, device=self.device).to(
                torch.float32)
            lengths = torch.as_tensor(lengths, device=self.device)
            trellis, nfr, out_ext = self._decode_device(wave, lengths)
            feats = None
            if self._want_rejection_features():
                # the rejection hooks see unspliced features without
                # spectral subtraction, as the reference's do
                feats = fe.extract_features(
                    wave, lengths, self.fe_tables)[0].cpu().numpy()
            nfr = nfr.cpu().numpy()
            results = self._results(trellis, nfr, feats, out_ext=out_ext)
            sc = self.search_cfg
            if sc.align_word or sc.align_phoneme or sc.align_state:
                self._maybe_align(results, self._features(wave, lengths)[0],
                                  nfr)
            return results

    def _results(self, trellis: p1.Trellis, nfr: np.ndarray,
                 feats: Optional[np.ndarray] = None,
                 out_ext: Optional[torch.Tensor] = None) -> List[Result]:
        B = nfr.shape[0]
        with trace.span("pass1.readback"):
            host = p1.Trellis(*[a.cpu().numpy() for a in trellis])
        out: List[Optional[Result]] = [None] * B
        tbs: List[Optional[p1.Trellis]] = [None] * B
        want_p2 = self.search_cfg.enable_pass2 and self.lmtype != "word"
        rescan = want_p2 and out_ext is not None and self._rescan_ok()
        lattices: List[Optional[p2.TrellisLattice]] = [None] * B
        for b in range(B):
            tb = p1.Trellis(*[a[b] for a in host])
            n = int(nfr[b])
            if n <= 0:
                out[b] = Result(valid=False)
                continue
            reason = self._reject(
                feats[b] if feats is not None else None, n)
            if reason is not None:
                out[b] = Result(valid=False, reject_reason=reason)
                continue
            tbs[b] = tb
            if rescan:
                lattices[b] = p2.TrellisLattice(tb, n)
            elif want_p2:
                out[b] = self._pass2_result(tb, n)
        if rescan and any(lat is not None for lat in lattices):
            graphs = None
            if self._device_astar_ok():
                nbest_lists = self._device_astar(lattices, out_ext, trellis)
            else:
                graphs = [] if self._want_p2_graph() else None
                nbest_lists = p2r.rescan_nbest_batch(
                    lattices, self._dispatcher(out_ext),
                    self._rescan_strategy(), self.search_cfg, graphs=graphs)
            for b in range(B):
                if lattices[b] is not None and nbest_lists[b]:
                    out[b] = self._assemble_pass2(
                        nbest_lists[b], lattices[b],
                        gwords=graphs[b] if graphs else None)
        for b in range(B):
            if out[b] is None:
                # pass-2 empty -> pass-1 fallback (reference
                # pass2_finalize_on_no_result)
                out[b] = (self._pass1_result(tbs[b], int(nfr[b]))
                          if tbs[b] is not None else Result(valid=False))
        for res in out:
            self.callbacks.exec("result", res)
        return out

    def _device_astar(self, lattices, out_ext, trellis=None
                      ) -> List[List[p2.NBestResult]]:
        """Device A* over the batch, then the per-utterance robustness
        net: utterances that came back empty, or clearly below the
        pass-1 path's own total (same score scale when the pass weights
        match and no pseudo sets inflate pass-1 edges), re-run through
        the host re-scan.  Where that margin test is not sound (pseudo-
        set nets, differing pass weights) the worst-margin utterance of
        the first few batches is SPOT-CHECKED on the host instead, and a
        clear host win fails the whole batch over to the host path.
        `trellis` is the batch's pass-1 trellis on the engine's device,
        which the A*'s suffix DP reads on a card."""
        sc = self.search_cfg
        with trace.span("astar"):
            if self._p2d_best_in is None:
                # LM-dependent, batch-independent: computed once per engine
                self._p2d_best_in = p2d._best_lm_in(
                    self._rescan_strategy(), self.device_chains.loc.shape[0])
            nbest_lists = p2d.run_batch(
                lattices, self.device_chains, self.ngram_dev,
                self._wid2lm_p2, self._cprob_arr(), out_ext,
                self._rescan_strategy(), sc, best_in=self._p2d_best_in,
                iwcd2=self.iwcd2_tables, trellis=trellis)
            t1 = time.perf_counter()
            with trace.span("astar.retry"):
                retried = self._retry_net(lattices, nbest_lists, out_ext)
            self.last_pass2 = {"retry_s": time.perf_counter() - t1,
                               "retried": retried}
            return nbest_lists

    def _retry_net(self, lattices, nbest_lists, out_ext) -> int:
        """`_device_astar`'s robustness net over the device A*'s N-best
        lists, replaced in place where the host re-scan wins; returns
        the number of utterances re-run."""
        sc = self.search_cfg
        B = len(lattices)
        retry = [None] * B
        comparable = (sc.lm_weight == sc.lm_weight2
                      and sc.lm_penalty == sc.lm_penalty2
                      and self.net.pseudo is None)
        spot_b, spot_margin = -1, np.inf
        for b, lat in enumerate(lattices):
            if lat is None:
                continue
            if not nbest_lists[b]:
                retry[b] = lat
                continue
            p1best = float(np.max(np.where(
                lat.word[lat.T - 1] >= 0, lat.score[lat.T - 1], -np.inf)))
            if not np.isfinite(p1best):
                continue
            margin = nbest_lists[b][0].score - p1best
            if comparable:
                if margin < -10.0:
                    retry[b] = lat
            elif margin < spot_margin:
                spot_b, spot_margin = b, margin
        spot = not comparable and spot_b >= 0 and self._p2d_spot_ok < 2
        if spot and retry[spot_b] is None:
            retry[spot_b] = lattices[spot_b]
        if any(lat is not None for lat in retry):
            disp = self._dispatcher(out_ext)
            host_lists = p2r.rescan_nbest_batch(
                retry, disp, self._rescan_strategy(), sc)
            if spot and host_lists[spot_b]:
                dev_s = nbest_lists[spot_b][0].score \
                    if nbest_lists[spot_b] else -np.inf
                if host_lists[spot_b][0].score > dev_s + 2.0:
                    # device search lost on this config: fail the whole
                    # batch over to the host path
                    jlog(LogLevel.WARNING,
                         "device pass-2 lost spot-check "
                         f"({host_lists[spot_b][0].score:.2f} vs "
                         f"{dev_s:.2f}); host re-scan for batch")
                    self._p2d_spot_ok = 0
                    host_lists = p2r.rescan_nbest_batch(
                        lattices, disp, self._rescan_strategy(), sc)
                    retry = list(lattices)
                else:
                    self._p2d_spot_ok += 1
            for b in range(B):
                if retry[b] is not None and host_lists[b]:
                    if (not nbest_lists[b]
                            or host_lists[b][0].score
                            > nbest_lists[b][0].score):
                        nbest_lists[b] = host_lists[b]
        return sum(lat is not None for lat in retry)

    def _pass1_result(self, tb, n_frames: int) -> Result:
        r = p1.backtrace(tb, n_frames, self.net.tail_word,
                         final_mask=self.final_mask)
        if r is None:
            return Result(valid=False)
        return Result(
            words=[self.voca.names[w] for w in r["words"]],
            texts=[self.voca.outputs[w] for w in r["words"]],
            word_ids=r["words"],
            score=r["score"],
            segments=r["segments"],
            from_pass=1,
        )

    def _pass2_result(self, tb, n_frames: int,
                      out_ext: Optional[torch.Tensor] = None
                      ) -> Optional[Result]:
        """Stack-decoding rescore of one utterance; None when it finds no
        sentence (the caller falls back to pass 1, reference
        pass2_finalize_on_no_result).  With out_ext ([1, T, R] outprob
        cache) and a re-scan config, the device A* with its retry net or
        the host re-scan; otherwise the frozen-score search (reference
        search_bestfirst_main.c with pass-1 acoustic scores)."""
        lattice = p2.TrellisLattice(tb, n_frames)
        sc = self.search_cfg
        gwords = None
        if out_ext is not None and self._rescan_ok() \
                and self._device_astar_ok():
            nbest = p2d.run_batch(
                [lattice], self.device_chains, self.ngram_dev,
                self._wid2lm_p2, self._cprob_arr(), out_ext,
                self._rescan_strategy(), sc, iwcd2=self.iwcd2_tables)[0]
            comparable = (sc.lm_weight == sc.lm_weight2
                          and sc.lm_penalty == sc.lm_penalty2
                          and self.net.pseudo is None)
            weak = not nbest
            if nbest and comparable:
                p1best = float(np.max(np.where(
                    lattice.word[lattice.T - 1] >= 0,
                    lattice.score[lattice.T - 1], -np.inf)))
                weak = np.isfinite(p1best) and \
                    nbest[0].score < p1best - 10.0
            elif nbest and not comparable:
                # the margin vs pass 1 is not sound here: spot-check the
                # first few decodes against the host path instead
                weak = self._p2d_spot_ok < 2
            if weak:
                host = p2r.rescan_nbest_batch(
                    [lattice], self._dispatcher(out_ext),
                    self._rescan_strategy(), sc)[0]
                if host and nbest and not comparable:
                    if host[0].score > nbest[0].score + 2.0:
                        self._p2d_spot_ok = 0
                    else:
                        self._p2d_spot_ok += 1
                if host and (not nbest or host[0].score > nbest[0].score):
                    nbest = host
        elif out_ext is not None and self._rescan_ok():
            graphs = [] if self._want_p2_graph() else None
            nbest = p2r.rescan_nbest_batch(
                [lattice], self._dispatcher(out_ext),
                self._rescan_strategy(), sc, graphs=graphs)[0]
            gwords = graphs[0] if graphs else None
        elif self.lmtype == "grammar":
            nbest = p2.pass2_search_dfa(lattice, self.dfa, self.word_cat, sc)
        else:
            transparent = np.asarray(self.voca.transparent, dtype=bool) \
                if self.voca.transparent else None
            if self.lm is not None and self.lm.direction == "RL":
                nbest = p2.pass2_search_backward(
                    lattice, self.lm, self._wid2lm_p2, sc,
                    self.net.tail_word, self.net.head_word, transparent)
            else:
                nbest = p2.pass2_search(lattice, self.lm, self._wid2lm_p2,
                                        sc, self.net.tail_word, transparent,
                                        self._cprob_arr())
        if not nbest:
            return None
        return self._assemble_pass2(nbest, lattice, gwords=gwords)

    def _assemble_pass2(self, nbest: List[p2.NBestResult],
                        lattice: p2.TrellisLattice,
                        gwords: Optional[dict] = None) -> Result:
        """N-best list -> Result with confidence, MBR order and graph
        attachments (reference result output block,
        search_bestfirst_main.c:1090)."""
        sc = self.search_cfg
        if sc.compute_confidence:
            p2.confidence_scores(nbest, sc.cm_alpha)
        if sc.mbr:
            nbest = go.mbr_rerank(
                nbest, sc.mbr_score_scale,
                weights=np.asarray(self.voca.weight, dtype=np.float32))

        def mk(r: p2.NBestResult) -> Result:
            return Result(
                words=[self.voca.names[w] for w in r.word_ids],
                texts=[self.voca.outputs[w] for w in r.word_ids],
                word_ids=list(r.word_ids),
                score=r.score,
                am_score=r.am_score,
                lm_score=r.lm_score,
                segments=[{"word": w, "begin": b, "end": e}
                          for w, (b, e) in zip(r.word_ids, r.bounds)],
                cm=r.cm,
                from_pass=2,
            )

        best = mk(nbest[0])
        best.nbest = [mk(r) for r in nbest]
        if sc.graph_out or sc.confnet_out:
            # posterior-bearing outputs use the dense pass-1 lattice
            # graph: every recorded word-end atom contributes mass
            graph = go.prune_graph(go.build_word_graph(lattice),
                                   sc.graph_min_posterior)
            if sc.graph_out:
                best.graph = graph
            if sc.confnet_out:
                best.confnet = go.confusion_network(graph)
        if sc.cm_search and gwords:
            # search-time confidence: each word's posterior in the graph
            # of the words the re-scan attached, keyed by its refined
            # (word, begin, end) span (reference wordgraph_assign,
            # graphout.c:1901, 2020)
            graph = go.prune_graph(
                go.build_word_graph_pass2(gwords, lattice.T, sc.cm_alpha),
                sc.graph_min_posterior)
            post = {(w.word, w.begin, w.end): w.posterior
                    for w in graph.words}
            for res in [best] + best.nbest:
                res.cm = [post.get((w, s["begin"], s["end"]), 0.0)
                          for w, s in zip(res.word_ids, res.segments)]
        return best

    def describe(self) -> str:
        """Engine/system info dump (reference print_engine_info,
        libjulius/src/m_info.c; printed by -version/-setting)."""
        sc, am, fe_cfg = self.search_cfg, self.am_cfg, self.fe_cfg
        L = ["---------- engine information ----------",
             "julius_tpu_torch (PyTorch/CUDA port of julius_tpu, julius "
             "4.6 capability parity)"]
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += f" ({torch.cuda.get_device_name(self.device)})"
        L.append(f"compute: torch {torch.__version__} device={dev}")
        L.append("---------- acoustic model ----------")
        h = self.hmm
        L.append(f" phones: {h.n_phones} physical, "
                 f"{len(h.logical_map)} logical (HMMList)")
        L.append(f" states: {h.n_states} senones; "
                 f"triphone names: {h.names_are_triphone}")
        if self.dnn_scorer is not None:
            ws = self.dnn_scorer.weights
            L.append(f" scorer: DNN {ws[0].shape[0]}-"
                     + "x".join(str(w.shape[1]) for w in ws)
                     + f"-{self.dnn_scorer.n_out} (log10 outprob)")
        else:
            L.append(f" scorer: GMM (gprune={am.gprune} "
                     f"num={am.gprune_num}"
                     + (", GMS" if self.gms is not None else "") + ")")
        L.append(f" cross-word CD: iwcd1={am.iwcd_scheme}"
                 + (f" best{am.iwcd_nbest}" if am.iwcd_scheme == "best"
                    else "")
                 + (", pass1 RC dynamic" if am.head_rc_dynamic else "")
                 + (", pass2 strict IWCD (v2)" if sc.strict_iwcd2
                    else ", pass2 v1"))
        L.append("---------- front-end ----------")
        L.append(f" {fe_cfg.feature_type or 'MFCC'}: "
                 f"sr={fe_cfg.sample_rate} frame={fe_cfg.frame_ms}ms "
                 f"shift={fe_cfg.shift_ms}ms fbank={fe_cfg.fbank_num} "
                 f"veclen={fe_cfg.veclen}")
        L.append(f" CMN={'on' if fe_cfg.cmn else 'off'} CVN="
                 f"{'on' if fe_cfg.cvn else 'off'} "
                 f"map_weight={fe_cfg.cmn_map_weight}")
        L.append("---------- language model ----------")
        L.append(f" type={self.lmtype} vocabulary={self.voca.n_words} "
                 "words")
        if self.lm is not None:
            L.append(f" N-gram: order={getattr(self.lm, 'order', '?')} "
                     f"direction={getattr(self.lm, 'direction', 'LR')}")
        if self.dfa is not None:
            L.append(f" DFA: {self.dfa.n_states} states")
        L.append("---------- search ----------")
        L.append(f" lexicon: flat, {self.net.n_nodes} nodes "
                 f"(local_k={self.dev_net.local_k}); trellis M="
                 f"{self.p1_cfg.n_atoms}")
        L.append(f" pass1: lm_weight={sc.lm_weight} "
                 f"penalty={sc.lm_penalty} beam="
                 f"{sc.beam_width or 'full'} factoring={sc.factoring}")
        L.append(f" pass2: {'rescan' if sc.pass2_rescan else 'frozen'} "
                 f"lm_weight2={sc.lm_weight2} penalty2={sc.lm_penalty2} "
                 f"stack={sc.stack_size} m={sc.max_hypo_pop} "
                 f"n={sc.nbest} envelope={sc.word_envelope} "
                 f"lookup={sc.lookup_range}")
        outs = [k for k, v in [("lattice", sc.graph_out),
                               ("confnet", sc.confnet_out),
                               ("cm", sc.compute_confidence),
                               ("mbr", sc.mbr),
                               ("walign", sc.align_word),
                               ("palign", sc.align_phoneme),
                               ("salign", sc.align_state)] if v]
        L.append(f" outputs: n-best={sc.output_n}"
                 + (" + " + "/".join(outs) if outs else ""))
        return "\n".join(L)

    def register_user_lm(self, fn, order: int = 2) -> None:
        """Install an application-provided LM for pass-2 rescoring
        (reference j_regist_user_lm_func, jfunc.c / LM_NGRAM_USER).

        ``fn(context_word_ids, word_id) -> log10 prob`` receives
        *dictionary* word ids (most recent context last).  Pass-1
        factoring scores still come from the loaded N-gram: as in the
        reference, pass 1 only approximates and pass 2 decides."""

        class _UserLM:
            direction = "LR"

            def __init__(self, f, k):
                self.order = k
                self._f = f

            def logprob(self, ctx, w):
                return float(self._f(tuple(int(c) for c in ctx), int(w)))

        self.lm = _UserLM(fn, order)
        self._wid2lm_p2 = np.arange(self.voca.n_words, dtype=np.int64)
