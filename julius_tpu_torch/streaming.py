"""Streaming recognition session: the `j_recognize_stream` equivalent.

Port of `julius_tpu/streaming.py` (reference recogmain.c:714
j_recognize_stream_core: adin_go drives the VAD-triggered capture loop,
each triggered chunk runs RealTimePipeLine, realtime-1stpass.c:813,
per-frame MFCC + one decode_proceed step, and segment end finalises
pass 1 then runs pass 2).

Audio chunks -> host VAD + streaming front end (frontend/stream.py) ->
frames batched into fixed-size blocks -> one outprob call and one pass-1
chunk per block on the engine's device (search/pass1.py
`pass1_stream_chunk`, the unfused step at B = 1, as the reference's
stream runs its XLA step; on a CUDA card one replay of a captured frame
graph a frame, as the reference runs its jitted scan) -> the block's
trellis atoms come to the host in one copy, the block's only host
synchronisation -> segment end finalises pass 1 and runs the engine's pass 2
on the segment's outprob cache (the device A* or the host re-scan, whose
word scans launch the scan_win kernel).  The pass-1 state lives on the
device across blocks, so latency is one block (default 16 frames =
160 ms).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from julius_tpu_torch.frontend.stream import (SpeechDetector,
                                              StreamingFrontend, VADConfig)
from julius_tpu_torch.search import pass1 as p1
from julius_tpu_torch.search.pass1 import Trellis


def _atoms_to_host(atoms: Trellis) -> Trellis:
    """[C, M] device atoms -> numpy, in one copy: the float fields ride
    as their int32 bit patterns in one stacked tensor."""
    floats = {"score", "lm"}
    stacked = torch.stack([
        a.view(torch.int32) if f in floats else a.to(torch.int32)
        for f, a in zip(Trellis._fields, atoms)]).cpu().numpy()
    return Trellis(*[stacked[i].view(np.float32) if f in floats
                     else stacked[i] for i, f in enumerate(Trellis._fields)])


class StreamSession:
    """One audio stream over an Engine (on the engine's device); yields
    a Result per detected speech segment.

    spsegment enables decoder-driven segmentation (reference
    spsegment.c / SPSEGMENT_NAIST): when the pass-1 best word has been
    a silence word for sp_frames consecutive frames, the current
    segment is finalised and decoding restarts from the silence-run
    onset (the reference's short-pause segmentation with MFCC
    rewind)."""

    def __init__(self, engine, vad: Optional[VADConfig] = None,
                 use_vad: bool = True, block_frames: int = 16,
                 spsegment: bool = False, sp_frames: int = 10,
                 progout: bool = False, prog_frames: int = 30,
                 gmm_vad: bool = False, gmm_margin: int = 20):
        self.engine = engine
        self.block = block_frames
        self.use_vad = use_vad
        self.spsegment = spsegment
        self.sp_frames = sp_frames
        # GMM-VAD gate (reference gmm.c GMM_VAD: sliding margin window
        # with up/down triggers + backstep margin); requires
        # engine.gmm_frontend with noise models configured
        self.gmm_vad = gmm_vad and engine.gmm_frontend is not None
        self.gmm_margin = gmm_margin
        self._gv_ring: List[np.ndarray] = []   # pre-trigger frame ring
        self._gv_hist: List[float] = []        # margin smoothing window
        self._gv_speech = False
        # -progout: fire result_pass1_interim every prog_frames frames
        # (reference output_stdout.c progout callback, -proginterval)
        self.progout = progout
        self.prog_frames = max(1, prog_frames)
        self._last_prog = 0
        self._sil_words = {engine.net.head_word, engine.net.tail_word}
        for i in range(engine.voca.n_words):
            if all(p in ("sil", "sp") for p in engine.voca.phones[i]):
                self._sil_words.add(i)
        self.detector = SpeechDetector(vad or VADConfig(
            sample_rate=engine.fe_cfg.sample_rate)) if use_vad else None
        self.frontend = StreamingFrontend(engine.fe_cfg,
                                          device=engine.device)
        dnn = engine.dnn_scorer is not None
        self.splice = engine.dnn_params.context_len if dnn else 1

        # absolute stream-frame ranges of finished segments (exact for
        # the no-VAD / spsegment paths; used by rewind parity tests)
        self.segment_ranges: List[tuple] = []
        self._abs0 = 0
        self._reset_segment()

    # -- segment state ----------------------------------------------------

    def _reset_segment(self):
        self._state: Optional[p1.Pass1State] = None
        self._atoms: List[Trellis] = []
        self._feat_pending: List[np.ndarray] = []   # frames awaiting splice
        self._out_rows: List[torch.Tensor] = []     # pass-2 outprob cache
        self._nframes = 0
        self._in_segment = False
        self._last_prog = 0

    def _stacked(self, rows: List[Trellis]) -> Trellis:
        return Trellis(*[np.stack([getattr(r, f) for r in rows])
                         for f in Trellis._fields])

    def _emit_progout(self):
        """Progressive pass-1 partial result (reference RESULT_PASS1_INTERIM
        via -progout; beam.c:2985-2992)."""
        if not self.progout or \
                self._nframes - self._last_prog < self.prog_frames or \
                len(self._atoms) < 2:
            return
        self._last_prog = self._nframes
        res = self.engine._pass1_result(self._stacked(self._atoms),
                                        len(self._atoms))
        if res is not None and res.valid:
            self.engine.callbacks.exec("result_pass1_interim", res)

    # -- public API -------------------------------------------------------

    def feed(self, samples: np.ndarray) -> List:
        """Feed raw audio samples; returns Results for any segments that
        completed inside this call."""
        results = []
        if self.detector is None:
            frames = self.frontend.process(samples)
            if self.gmm_vad:
                return self._feed_gmm_vad(frames)
            if not self._in_segment:
                self._in_segment = True
            self._feed_frames(frames)
            if self.spsegment:
                r = self._check_sp_segment()
                if r is not None:
                    results.append(r)
            return results
        for ev in self.detector.feed(samples):
            if ev["type"] == "start":
                self._in_segment = True
                self.frontend.reset()
                self.engine.callbacks.exec("event_speech_start")
            elif ev["type"] == "samples" and self._in_segment:
                self._feed_frames(self.frontend.process(ev["data"]))
            elif ev["type"] == "end" and self._in_segment:
                r = self._finish_segment()
                if r is not None:
                    results.append(r)
        return results

    def _feed_gmm_vad(self, frames: np.ndarray) -> List:
        """GMM-VAD frame gate (reference gmm.c GMM_VAD block): frames
        pass to the decoder only while the smoothed voice-vs-noise
        margin is up-triggered; a ring of gmm_margin pre-trigger frames
        is replayed at speech onset (the reference's backstep margin)."""
        results = []
        gf = self.engine.gmm_frontend
        if frames.shape[0] == 0:
            return results
        margins = gf.frame_margins(frames)
        for i in range(frames.shape[0]):
            self._gv_hist.append(float(margins[i]))
            if len(self._gv_hist) > 5:
                self._gv_hist.pop(0)
            avg = sum(self._gv_hist) / len(self._gv_hist)
            if not self._gv_speech:
                self._gv_ring.append(frames[i])
                if len(self._gv_ring) > self.gmm_margin:
                    self._gv_ring.pop(0)
                if avg > gf.vad_up:
                    self._gv_speech = True
                    self._in_segment = True
                    self.engine.callbacks.exec("event_speech_start")
                    self._feed_frames(np.asarray(self._gv_ring))
                    self._gv_ring = []
            else:
                self._feed_frames(frames[i:i + 1])
                if avg < gf.vad_down:
                    self._gv_speech = False
                    r = self._finish_segment()
                    if r is not None:
                        results.append(r)
        return results

    def _best_word(self, row: Trellis) -> int:
        return int(row.word[np.argmax(row.score)]) \
            if (row.word >= 0).any() else -1

    def _check_sp_segment(self):
        """Segment when the decoder's best word-end has been silence
        for sp_frames consecutive frames after real speech (reference
        spsegment_need_restart, spsegment.c:839)."""
        n = len(self._atoms)
        if n < self.sp_frames + 2:
            return None
        run = 0
        for row in reversed(self._atoms):
            if self._best_word(row) in self._sil_words:
                run += 1
                if run >= self.sp_frames:
                    break
            else:
                break
        if run < self.sp_frames:
            return None
        # was there non-silence content before the run?
        had_speech = any(
            (row.word >= 0).any()
            and self._best_word(row) not in self._sil_words
            for row in self._atoms[: n - run])
        if not had_speech:
            return None
        # finalise the current segment at the trigger point, then
        # REWIND: the next segment re-decodes from the silence-run
        # onset (the reference's decoder-VAD rewind,
        # spsegment_restart_mfccs spsegment.c:912 + rest_param
        # carry-over recogmain.c:1415-1431) so the trigger-back region
        # is decoded under the new segment's own context
        onset = max(0, self._nframes - run)
        carry = self._feat_pending[onset:]
        r = self._finish_segment(flush=False)
        self._abs0 += onset
        self._in_segment = True
        if carry:
            self._feed_frames(np.asarray(carry))
        return r

    def close(self) -> List:
        """End of stream: flush any open segment."""
        results = []
        if self._in_segment:
            r = self._finish_segment()
            if r is not None:
                results.append(r)
        return results

    # -- internals --------------------------------------------------------

    def _feed_frames(self, frames: np.ndarray, final: bool = False):
        """Queue normalised feature frames; run device blocks when the
        splice context allows."""
        if frames.shape[0]:
            self._feat_pending.extend(np.asarray(frames))
        half = self.splice // 2
        avail = len(self._feat_pending) - (0 if final else half)
        while avail - self._nframes >= self.block or \
                (final and avail > self._nframes):
            self._run_block(final)
            avail = len(self._feat_pending) - (0 if final else half)

    def _run_block(self, final: bool):
        half = self.splice // 2
        start = self._nframes
        limit = len(self._feat_pending) if final \
            else len(self._feat_pending) - half
        count = min(self.block, limit - start)
        if count <= 0:
            return
        # splice with context (edge-replicated at stream edges)
        rows = []
        T = len(self._feat_pending)
        for t in range(start, start + count):
            if self.splice > 1:
                ctx = [self._feat_pending[min(max(t + o, 0), T - 1)]
                       for o in range(-half, self.splice - half)]
                rows.append(np.concatenate(ctx))
            else:
                rows.append(self._feat_pending[t])
        block = np.zeros((self.block, len(rows[0])), dtype=np.float32)
        block[:count] = rows
        eng = self.engine
        with torch.no_grad():
            x = torch.as_tensor(block, device=eng.device)
            out = eng._outprob(x[None])[0]
            # grow the whole-segment outprob cache for the pass-2 re-scan
            # (reference outprob_cache growth, outprob.c:184)
            self._out_rows.append(out[:count])
            if self._state is None:
                self._state = p1.pass1_stream_start(eng.dev_net, eng.p1_cfg,
                                                    out[:1])
                rest, n_valid = out[1:], count - 1
            else:
                rest, n_valid = out, count
            self._nframes = start + count
            if n_valid > 0:
                self._state, atoms = p1.pass1_stream_chunk(
                    eng.dev_net, eng.ngram_dev, eng.p1_cfg, self._state,
                    rest, n_valid)
                host = _atoms_to_host(atoms)
                # row i = word-ends at absolute frame (frames_before + i)
                for i in range(n_valid):
                    self._atoms.append(Trellis(*[a[i] for a in host]))
        self._emit_progout()

    def _finish_segment(self, flush: bool = True):
        """flush=False ends the segment at the frames already decoded
        (mid-stream decoder-VAD cut: the front end keeps running, the
        splice-margin tail is re-fed by the caller's rewind carry)."""
        if flush:
            self._feed_frames(self.frontend.finalize(), final=True)
        if self._state is None or self._nframes < 2:
            self._reset_segment()
            self._in_segment = False
            return None
        self.segment_ranges.append((self._abs0, self._abs0 + self._nframes))
        eng = self.engine
        with torch.no_grad():
            final = p1.pass1_stream_finalize(
                eng.dev_net, eng.ngram_dev, eng.p1_cfg, self._state)
            host = _atoms_to_host(Trellis(*[a[None] for a in final]))
        final_atoms = Trellis(*[a[0] for a in host])
        # assemble the [T, M] trellis: collected rows are word-ends at
        # frames 0..T-2, the finalize atoms are frame T-1
        T = self._nframes
        stacked = list(self._atoms[: T - 1]) + [final_atoms]
        assert len(stacked) == T, (len(self._atoms), T)
        tr = self._stacked(stacked)
        res = None
        eng.callbacks.exec("event_speech_stop")
        if eng.callbacks.exists("result_pass1"):
            eng.callbacks.exec("result_pass1", eng._pass1_result(tr, T))
        if eng.search_cfg.enable_pass2 and eng.lmtype != "word":
            eng.callbacks.exec("event_pass2_begin")
            out_ext = None
            if self._out_rows and eng._rescan_ok():
                out_ext = torch.cat(self._out_rows)[:T][None]
            with torch.no_grad():
                res = eng._pass2_result(tr, T, out_ext=out_ext)
        if res is None:
            res = eng._pass1_result(tr, T)
        self._reset_segment()
        self._in_segment = False
        eng.callbacks.exec("result", res)
        return res
