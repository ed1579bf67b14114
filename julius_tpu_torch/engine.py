"""Recognition engine: model fusion + batched decoding (torch).

Port of `julius_tpu/engine.py` for the flagship DNN-HMM N-gram decode:
DNN senone scores -> pass 1 (ops/pass1_kernel.py beam-update kernel) ->
pass-2 frozen-score stack search -> N-best.  One Engine = one AM + one
LM + one search config; it owns the device tables.

Configurations outside this slice raise NotImplementedError naming the
ROADMAP.md item that brings them; nothing falls back silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from julius_tpu_torch.config import AMConfig, FrontendConfig, SearchConfig
from julius_tpu_torch.io.arpa import NGramLM
from julius_tpu_torch.io.dnn import DNNParams
from julius_tpu_torch.io.htk_dict import Vocabulary
from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.ops.dnn import DNNScorer, build_dnn_scorer, dnn_scores
from julius_tpu_torch.search import pass1 as p1
from julius_tpu_torch.search import pass2 as p2
from julius_tpu_torch.search.network import DecodeNetwork, build_network
from julius_tpu_torch.search.ngram_device import (DeviceNgram,
                                                  build_device_ngram)
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
    cm: Optional[List[float]] = None      # per-word confidence
    nbest: List["Result"] = field(default_factory=list)
    from_pass: int = 1
    valid: bool = True
    reject_reason: Optional[str] = None


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the torch port yet: ROADMAP.md queue 1, {item}")


class Engine:
    """One recognition instance (DNN AM + N-gram LM + search)."""

    def __init__(
        self,
        hmm: HMMSet,
        voca: Vocabulary,
        lm: Optional[NGramLM] = None,
        dnn: Optional[DNNParams] = None,
        frontend: Optional[FrontendConfig] = None,
        search: Optional[SearchConfig] = None,
        am_cfg: Optional[AMConfig] = None,
        dfa=None,
        lmtype: Optional[str] = None,
        iwsp: bool = False,
        sp_name: str = "sp",
        iwsp_penalty: float = -1.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # the reference pins full-f32 products; TF32 would round ids and
        # scores (CUDA defaults differ between matmul and cuDNN)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if lmtype is None:
            lmtype = ("ngram" if lm is not None
                      else "grammar" if dfa is not None else "word")
        if dnn is None:
            raise _unsupported("the GMM scorer", "GMM/GMS")
        if lmtype != "ngram" or dfa is not None:
            raise _unsupported(f"lmtype {lmtype!r} (DFA/grammar, isolated "
                               "words)", "unfused pass1_step paths")
        if lm is not None and getattr(lm, "direction", "LR") == "RL":
            raise _unsupported("a backward (RL) N-gram", "device A*")
        self.am_cfg = am_cfg or AMConfig()
        if self.am_cfg.head_rc_dynamic:
            raise _unsupported("head_rc_dynamic", "unfused pass1_step paths")
        self.hmm = hmm
        self.voca = voca
        self.lm = lm
        self.lmtype = lmtype
        self.search_cfg = search or SearchConfig()
        self.fe_cfg = frontend or FrontendConfig()
        sc = self.search_cfg
        if sc.factoring >= 2:
            raise _unsupported("factoring=2", "unfused pass1_step paths")
        if sc.beam_width:
            raise _unsupported("beam_width > 0", "unfused pass1_step paths")

        self._resolve_silwords()
        self._wid2lm = self._map_vocab_to_lm(lm)

        use_tri = hmm.names_are_triphone and not self.am_cfg.force_mono
        self.net: DecodeNetwork = build_network(
            hmm, voca, use_triphone=use_tri, iwsp=iwsp, sp_name=sp_name,
            iwsp_penalty=iwsp_penalty)
        if self.net.pseudo is not None and self.net.pseudo.n_set_states > 0:
            raise _unsupported("pseudo-phone (iwcd1) sets", "GMM/GMS")
        self.ngram_dev: Optional[DeviceNgram] = (
            build_device_ngram(lm, self.device) if lm is not None else None)
        transparent = np.asarray(voca.transparent, dtype=bool) \
            if voca.transparent else None
        self.dev_net = p1.build_device_network(
            self.net, self.device, self.ngram_dev, self._wid2lm,
            lm_weight=sc.lm_weight, lm_penalty=sc.lm_penalty,
            transparent=transparent,
            transparent_penalty=sc.transparent_penalty,
            cprob=self._cprob_arr())
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
            use_lm=lm is not None,
            factoring=sc.factoring,
        )
        p1.check_supported(self.dev_net, self.p1_cfg)

        self.callbacks = CallbackRegistry()
        # input-rejection hooks (reference recogmain.c short/long)
        self.reject_short_frames: int = 0
        self.reject_long_frames: int = 0

        self.dnn_params = dnn
        self.dnn_scorer: DNNScorer = build_dnn_scorer(dnn, self.device)
        # senone s reads DNN output column state_sid[s]
        self._state_sid = torch.as_tensor(
            np.asarray(hmm.state_sid), dtype=torch.int64, device=self.device)

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

    def _cprob_arr(self) -> Optional[np.ndarray]:
        return (np.asarray(self.voca.cprob, dtype=np.float32)
                if self.voca.cprob and any(self.voca.cprob) else None)

    def _check_outputs(self) -> None:
        sc = self.search_cfg
        if sc.enable_pass2 and sc.pass2_rescan:
            raise _unsupported("pass2_rescan=True (acoustic re-scan)",
                               "device A* (search/scan.py, "
                               "search/pass2_device.py, pass2_rescan.py)")
        if sc.align_word or sc.align_phoneme or sc.align_state:
            raise _unsupported("forced alignment", "align")
        if sc.graph_out or sc.confnet_out or sc.cm_search or sc.mbr:
            raise _unsupported("word graph / confnet / MBR output",
                               "device A*")

    # -- device compute path ----------------------------------------------

    def _outprob(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] features -> [B, T, R] extended outprob rows."""
        out = dnn_scores(self.dnn_scorer, feats)         # [B, T, n_out]
        return out.index_select(-1, self._state_sid)

    def _reject(self, n: int) -> Optional[str]:
        """Input rejection by length (reference recogmain.c)."""
        if self.reject_short_frames and n < self.reject_short_frames:
            return "too short"
        if self.reject_long_frames and n > self.reject_long_frames:
            return "too long"
        return None

    def _pass1(self, out_ext: torch.Tensor, n_frames) -> p1.Trellis:
        nfr = torch.as_tensor(n_frames, dtype=torch.int32,
                              device=self.device)
        return p1.pass1_batch(self.dev_net, self.ngram_dev, self.p1_cfg,
                              out_ext, nfr)

    def decode_features(self, feats, n_frames) -> List[Result]:
        """Decode pre-extracted features [B, T, D] (numpy or torch) with
        [B] valid frame counts (reference mfcfile / vecnet feature input
        paths)."""
        self._check_outputs()
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        with torch.no_grad():
            trellis = self._pass1(self._outprob(feats), n_frames)
        return self._results(trellis, np.asarray(torch.as_tensor(
            n_frames).cpu()))

    def decode_outprob(self, rows, n_frames) -> List[Result]:
        """Decode directly from state output probabilities [B, T, S]
        (reference SP_OUTPROBFILE input / vecnet outprob_p mode)."""
        self._check_outputs()
        out_ext = torch.as_tensor(rows, dtype=torch.float32,
                                  device=self.device)
        with torch.no_grad():
            trellis = self._pass1(out_ext, n_frames)
        return self._results(trellis, np.asarray(torch.as_tensor(
            n_frames).cpu()))

    def recognize_batch(self, wave, lengths) -> List[Result]:
        """Waveform input needs the front end, which is not ported."""
        raise _unsupported("the waveform front end", "front end")

    def _results(self, trellis: p1.Trellis, nfr: np.ndarray) -> List[Result]:
        B = nfr.shape[0]
        host = p1.Trellis(*[a.cpu().numpy() for a in trellis])
        want_p2 = self.search_cfg.enable_pass2
        out: List[Result] = []
        for b in range(B):
            tb = p1.Trellis(*[a[b] for a in host])
            n = int(nfr[b])
            if n <= 0:
                res = Result(valid=False)
            elif (reason := self._reject(n)) is not None:
                res = Result(valid=False, reject_reason=reason)
            else:
                res = self._pass2_result(tb, n) if want_p2 else None
                if res is None:
                    # pass-2 empty -> pass-1 fallback (reference
                    # pass2_finalize_on_no_result)
                    res = self._pass1_result(tb, n)
            out.append(res)
        for res in out:
            self.callbacks.exec("result", res)
        return out

    def _pass1_result(self, tb, n_frames: int) -> Result:
        r = p1.backtrace(tb, n_frames, self.net.tail_word)
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

    def _pass2_result(self, tb, n_frames: int) -> Optional[Result]:
        """Frozen-score stack decoding of one utterance (reference
        search_bestfirst_main.c with pass-1 acoustic scores); None when
        it finds no sentence."""
        lattice = p2.TrellisLattice(tb, n_frames)
        transparent = np.asarray(self.voca.transparent, dtype=bool) \
            if self.voca.transparent else None
        nbest = p2.pass2_search(lattice, self.lm, self._wid2lm,
                                self.search_cfg, self.net.tail_word,
                                transparent, self._cprob_arr())
        if not nbest:
            return None
        return self._assemble_pass2(nbest)

    def _assemble_pass2(self, nbest: List[p2.NBestResult]) -> Result:
        """N-best list -> Result (reference result output block,
        search_bestfirst_main.c:1090)."""
        if self.search_cfg.compute_confidence:
            p2.confidence_scores(nbest, self.search_cfg.cm_alpha)

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
        return best
