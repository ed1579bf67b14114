"""Streaming front end: chunked features, MAP-CMN, VAD triggering (torch).

Port of `julius_tpu/frontend/stream.py`.  Reference: the on-the-fly
pipeline of `libjulius/src/realtime-1stpass.c`
(RealTimeMFCC:496 per-frame window -> base MFCC -> delta -> accel ->
MAP-CMN) with the delta ring buffers `WMP_deltabuf_*` and realtime CMN
`CMN_realtime` (libsent/src/wav2mfcc/wav2mfcc-pipe.c:342), plus the
level/zero-cross input trigger of `libjulius/src/adin-cut.c` + `zc-e.c`.

Division of labour: base spectral features for a chunk are one small
batched call on the front end's device (frontend/mfcc.py extract_basic,
whose mel and DCT products it pins to full f32 under
utils.device.full_f32_matmul, as for the batch front end); the
per-frame recurrences (delta ring, MAP-CMN running mean, VAD trigger)
are O(frames) scalar work and stay on the host, the same split as the
reference's CPU front end feeding an accelerator scorer.  Output frames lag input by
delta_win + accel_win frames (the reference's deltabuf latency), flushed
with edge replication at segment end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.config import FrontendConfig
from julius_tpu_torch.frontend import mfcc as fe
from julius_tpu_torch.utils.device import resolve_device

CPMAX = 500     # max frames of CMN history (reference wav2mfcc-pipe.c)
CPSTEP = 5


class MapCMN:
    """MAP-CMN with inter-utterance prior update (reference CMNWork,
    CMN_realtime / CMN_realtime_update)."""

    def __init__(self, veclen: int, static_dim: int, weight: float = 100.0,
                 do_map: bool = True, do_mean: bool = True,
                 do_var: bool = False):
        self.veclen = veclen
        self.static_dim = static_dim
        self.weight = weight
        self.do_map = do_map
        self.do_mean = do_mean
        self.do_var = do_var
        self.prior: Optional[np.ndarray] = None      # cmean_init
        self.prior_var: Optional[np.ndarray] = None  # cvar_init
        self.sum = np.zeros(veclen, dtype=np.float64)
        self.frames = 0
        self.history: List[Tuple[np.ndarray, int]] = []   # clist

    def process(self, frames: np.ndarray) -> np.ndarray:
        """Normalise a chunk of frames [C, veclen] in order."""
        out = frames.astype(np.float32).copy()
        for i in range(out.shape[0]):
            self.frames += 1
            self.sum += out[i]
            if self.prior is not None and self.do_map:
                mean = ((self.sum + self.weight * self.prior)
                        / (self.frames + self.weight))
            elif self.prior is not None:
                mean = self.prior
            else:
                mean = self.sum / self.frames
            if self.do_mean:
                out[i, : self.static_dim] -= \
                    mean[: self.static_dim].astype(np.float32)
            if self.do_var and self.prior_var is not None:
                out[i] /= np.sqrt(np.maximum(self.prior_var, 1e-10))
        return out

    def update(self) -> None:
        """End-of-utterance prior update over up to CPMAX recent frames
        (reference CMN_realtime_update)."""
        if self.frames == 0:
            return
        total = self.sum.copy()
        frames = self.frames
        for s, n in self.history:
            if frames >= CPMAX:
                break
            total += s
            frames += n
        self.prior = (total / frames).astype(np.float64)
        self.history.insert(0, (self.sum.copy(), self.frames))
        del self.history[CPMAX // CPSTEP:]
        self.sum = np.zeros(self.veclen, dtype=np.float64)
        self.frames = 0

    def reset_utterance(self) -> None:
        self.sum = np.zeros(self.veclen, dtype=np.float64)
        self.frames = 0

    def load(self, mean: np.ndarray, var: Optional[np.ndarray] = None):
        """-cmnload equivalent."""
        self.prior = np.asarray(mean, dtype=np.float64)
        if var is not None:
            self.prior_var = np.asarray(var, dtype=np.float64)

    def load_file(self, path: str):
        mean, var = load_cmn_file(path)
        self.load(mean, var)

    def save_file(self, path: str):
        if self.prior is None:
            raise ValueError("no CMN statistics to save yet")
        save_cmn_file(path, self.prior, self.prior_var)


def load_cmn_file(path: str):
    """Read a -cmnload file: HTK-ascii '<CEPSNORM> <MEAN> n ...
    [<VARIANCE> n ...]' (4.3+) or the old binary int32 veclen + f32
    means (reference CMN_load_from_file wav2mfcc-pipe.c:508)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head[:1] == b"<" and head[1:5].upper() == b"CEPS":
        toks = []
        with open(path, "rt") as f:
            for line in f:
                toks.extend(line.replace("<", " <").replace(">", "> ")
                            .split())
        mean = var = None
        i = 0
        while i < len(toks):
            t = toks[i].strip("<>").upper()
            if t in ("MEAN", "VARIANCE"):
                n = int(float(toks[i + 1]))
                vals = np.asarray([float(x) for x in
                                   toks[i + 2: i + 2 + n]], np.float64)
                if t == "MEAN":
                    mean = vals
                else:
                    var = vals
                i += 2 + n
            else:
                i += 1
        if mean is None:
            raise ValueError(f"no <MEAN> in CMN file {path}")
        return mean, var
    # old binary format
    raw = np.fromfile(path, dtype="<i4", count=1)
    veclen = int(raw[0])
    mean = np.fromfile(path, dtype="<f4", offset=4)[:veclen]
    return mean.astype(np.float64), None


def save_cmn_file(path: str, mean: np.ndarray,
                  var: Optional[np.ndarray] = None) -> None:
    """Write -cmnsave format (reference CMN_save_to_file)."""
    with open(path, "wt") as f:
        f.write("<CEPSNORM> <>\n")
        f.write(f"<MEAN> {len(mean)}\n")
        for v in mean:
            f.write(f" {v:e}\n")
        if var is not None:
            f.write(f"<VARIANCE> {len(var)}\n")
            for v in var:
                f.write(f" {v:e}\n")


class LiveEnergyNorm:
    """Live -enormal: normalize log energy with the PREVIOUS segment's
    maximum (reference wav2mfcc-pipe.c:711 energy_max_init /
    energy_max_prepare / energy_max_normalize): the utterance max is
    unknowable mid-stream, so each segment uses max_last, clamped at
    max_last - silFloor*ln10/10, rescaled 1 - (max_last - E)*escale."""

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        self.max = 5.0              # energy_max_init
        # the first prepare() (from StreamingFrontend.reset) makes this
        # the first segment's max_last

    def prepare(self) -> None:
        import math
        self.max_last = self.max
        self.min_last = self.max_last \
            - (self.cfg.silfloor_db * math.log(10.0)) / 10.0
        self.max = 0.0

    def normalize(self, e: np.ndarray) -> np.ndarray:
        if len(e):
            self.max = max(self.max, float(np.max(e)))
        e = np.maximum(e, self.min_last)
        return (1.0 - (self.max_last - e) * self.cfg.escale) \
            .astype(np.float32)


class StreamingFrontend:
    """Chunked feature extraction with delta lag and MAP-CMN; the base
    features of each chunk are computed on `device` (CUDA unless the
    CPU is asked for)."""

    def __init__(self, cfg: FrontendConfig,
                 tables: Optional[fe.FrontendTables] = None,
                 cmn: Optional[MapCMN] = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.energy = (LiveEnergyNorm(cfg)
                       if cfg.energy_normalize and cfg.use_energy
                       else None)
        self.cfg = cfg
        self.tables = tables or fe.build_tables(cfg)
        self.cmn = cmn
        if cmn is None and (cfg.cmn or cfg.cvn):
            self.cmn = MapCMN(cfg.veclen,
                              cfg.mfcc_dim + (1 if cfg.use_c0 else 0),
                              weight=cfg.cmn_map_weight,
                              do_map=not cfg.cmn_static,
                              do_mean=cfg.cmn, do_var=cfg.cvn)
        self.reset()

    def reset(self):
        self._audio = np.zeros(0, dtype=np.float32)
        self._base: List[np.ndarray] = []     # pending base frames
        self._delta: List[np.ndarray] = []    # pending delta frames
        self._emitted = 0
        if self.cmn is not None:
            self.cmn.reset_utterance()
        if getattr(self, "energy", None) is not None:
            # per-segment: last segment's max becomes the normalizer
            # (reference energy_max_prepare, realtime-1stpass.c:336)
            self.energy.prepare()

    @property
    def lag(self) -> int:
        dw = self.cfg.delta_win if self.cfg.use_delta else 0
        aw = self.cfg.accel_win if self.cfg.use_accel else 0
        return dw + aw

    def _base_frames(self, audio: np.ndarray) -> np.ndarray:
        """Extract base features for all complete windows in `audio`."""
        n = fe.num_frames(len(audio), self.cfg)
        if n == 0:
            return np.zeros((0, self.cfg.base_dim), dtype=np.float32)
        wave = torch.as_tensor(audio[None], dtype=torch.float32,
                               device=self.device)
        with torch.no_grad():
            return fe.extract_basic(wave, self.tables)[0].cpu().numpy()

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw samples; returns newly completed feature frames
        [C', veclen] (lagging by `lag` frames)."""
        cfg = self.cfg
        self._audio = np.concatenate([self._audio,
                                      np.asarray(samples, np.float32)])
        n = fe.num_frames(len(self._audio), cfg)
        if n > 0:
            base = self._base_frames(self._audio)
            if self.energy is not None and len(base):
                ei = cfg.base_dim - 1      # energy is the last static col
                base = base.copy()
                base[:, ei] = self.energy.normalize(base[:, ei])
            self._base.extend(base)
            keep_from = n * cfg.frame_shift
            self._audio = self._audio[keep_from:]
        return self._emit(final=False)

    def finalize(self) -> np.ndarray:
        """Flush lagged frames at segment end (reference WMP_deltabuf
        flush with edge replication) and update the CMN prior."""
        out = self._emit(final=True)
        if self.cmn is not None:
            self.cmn.update()
        return out

    def _emit(self, final: bool) -> np.ndarray:
        cfg = self.cfg
        dw = cfg.delta_win if cfg.use_delta else 0
        aw = cfg.accel_win if cfg.use_accel else 0
        base = self._base
        T = len(base)
        if T == 0:
            return np.zeros((0, cfg.veclen), dtype=np.float32)
        # frames whose full ±lag context is available (or all, if final)
        upto = T if final else max(self._emitted, T - self.lag)
        if upto <= self._emitted:
            return np.zeros((0, cfg.veclen), dtype=np.float32)
        rows = []
        barr = np.asarray(base)
        for t in range(self._emitted, upto):
            vec = [barr[t]]
            if dw:
                d = _regress(barr, t, dw, T)
                if cfg.absesup:
                    vec = [barr[t][:-1], d]
                else:
                    vec = [barr[t], d]
                if aw:
                    # accel from deltas with the same regression
                    dstack = np.stack([
                        _regress(barr, min(max(t + k, 0), T - 1), dw, T)
                        for k in range(-aw, aw + 1)])
                    a = _regress(dstack, aw, aw, dstack.shape[0])
                    vec.append(a)
            rows.append(np.concatenate(vec))
        self._emitted = upto
        out = np.asarray(rows, dtype=np.float32)
        if self.cmn is not None:
            out = self.cmn.process(out)
        return out


def _regress(x: np.ndarray, t: int, win: int, T: int) -> np.ndarray:
    """HTK delta regression at frame t with edge clamping."""
    num = np.zeros_like(x[0])
    denom = 2.0 * sum(th * th for th in range(1, win + 1))
    for th in range(1, win + 1):
        ip = min(t + th, T - 1)
        im = max(t - th, 0)
        num = num + th * (x[ip] - x[im])
    return num / denom


# ---------------------------------------------------------------------------
# Level / zero-cross input trigger (reference adin-cut.c + zc-e.c)
# ---------------------------------------------------------------------------

@dataclass
class VADConfig:
    """Reference defaults: -lv 2000, -zc 60, -headmargin 300,
    -tailmargin 400, window 300 ms (adin-cut.c / jconf defaults)."""

    level: int = 2000
    zc_thres: int = 60
    window_ms: int = 300
    head_margin_ms: int = 300
    tail_margin_ms: int = 400
    sample_rate: int = 16000
    # sub-band SNR VAD gate (the libfvad role, adin-cut.c HAVE_LIBFVAD
    # blocks): -1 = off, 0..3 = aggressiveness (reference -fvad);
    # fvad_smooth/fvad_thres mirror -fvad_param <nframes> <thres>
    fvad_mode: int = -1
    fvad_smooth: int = 5
    fvad_thres: float = 0.0


def vad_config_from(cfg, sample_rate: int) -> "VADConfig":
    """Build a VADConfig from an EngineConfig's detect block
    (reference jconf.detect -lv/-zc/-headmargin/-tailmargin/-fvad)."""
    return VADConfig(
        level=cfg.vad_level, zc_thres=cfg.vad_zc,
        head_margin_ms=cfg.vad_head_ms, tail_margin_ms=cfg.vad_tail_ms,
        sample_rate=sample_rate, fvad_mode=cfg.fvad_mode,
        fvad_smooth=cfg.fvad_smooth, fvad_thres=cfg.fvad_thres)


class ZeroCrossVAD:
    """Streaming speech trigger: counts level-crossing sign flips in a
    sliding window (reference zc-e.c count_zc_e)."""

    def __init__(self, cfg: VADConfig):
        self.cfg = cfg
        self.win = int(cfg.sample_rate * cfg.window_ms / 1000)
        self.reset()

    def reset(self):
        self._ring = np.zeros(self.win, dtype=np.int8)   # +1/-1/0 marks
        self._pos = 0
        self._zc = 0
        self._sign = 0
        self._filled = 0

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Returns a bool array per sample: in-speech trigger state of
        the zero-cross counter (before margin logic)."""
        lv = self.cfg.level
        out = np.zeros(len(samples), dtype=bool)
        s = np.asarray(samples)
        for i, x in enumerate(s):
            mark = 0
            if x > lv and self._sign <= 0:
                mark = 1
                self._sign = 1
            elif x < -lv and self._sign >= 0:
                mark = -1
                self._sign = -1
            old = self._ring[self._pos]
            if old != 0:
                self._zc -= 1
            if mark != 0:
                self._zc += 1
            self._ring[self._pos] = mark
            self._pos = (self._pos + 1) % self.win
            out[i] = self._zc >= self.cfg.zc_thres
        return out


class SubbandVAD:
    """Python mirror of the native sub-band SNR VAD gate
    (adin/native/adin.cpp fvad_*; the libfvad role).  Six biquad
    band-pass energies, minimum-tracking noise floors, clipped log-SNR
    score vs an aggressiveness threshold, majority smoothing and
    hangover.  Per-sample IIR filtering in Python is slow — this is the
    no-compiler fallback; semantics match the native code."""

    FC = (150.0, 350.0, 750.0, 1500.0, 2500.0, 3400.0)
    TH = (1.2, 1.8, 2.6, 3.5)

    def __init__(self, mode: int, sample_rate: int,
                 smooth_frames: int = 5, thres_offset: float = 0.0):
        import math
        self.coefs = []
        for fc in self.FC:
            w0 = 2.0 * math.pi * fc / sample_rate
            alpha = math.sin(w0) / (2.0 * 1.2)
            a0 = 1.0 + alpha
            self.coefs.append((alpha / a0, 0.0, -alpha / a0,
                               -2.0 * math.cos(w0) / a0,
                               (1.0 - alpha) / a0))
        self.frame_len = sample_rate // 100
        m = min(max(mode, 0), 3)
        self.thres = self.TH[m] + thres_offset
        self.smooth_n = min(max(smooth_frames, 1), 15)
        self.hang_max = 8
        self.reset()

    def reset(self):
        nb = len(self.FC)
        self.z = np.zeros((nb, 2))
        self.e = np.zeros(nb)
        self.noise = np.full(nb, -1.0)
        self.pos = 0
        self.n_frames = 0
        self.hist = [0] * self.smooth_n
        self.hist_pos = 0
        self.hang = 0
        self.cur = 0

    def _frame_decision(self) -> None:
        score = 0.0
        for b in range(len(self.FC)):
            e = self.e[b] / self.frame_len + 1e-12
            if self.noise[b] < 0.0 or self.n_frames < 3:
                self.noise[b] = e if self.noise[b] < 0.0 \
                    else min(e, self.noise[b])
            elif e < self.noise[b]:
                self.noise[b] = 0.6 * self.noise[b] + 0.4 * e
            else:
                self.noise[b] *= 1.006
            snr = np.log10(e / (self.noise[b] + 1e-12))
            if snr > 0.0:
                score += min(snr, 1.5)
            self.e[b] = 0.0
        self.n_frames += 1
        raw = 1 if score > self.thres else 0
        self.hist[self.hist_pos] = raw
        self.hist_pos = (self.hist_pos + 1) % self.smooth_n
        if 2 * sum(self.hist) > self.smooth_n:
            self.cur = 1
            self.hang = self.hang_max
        elif self.hang > 0:
            self.hang -= 1
            self.cur = 1
        else:
            self.cur = 0

    def feed(self, samples: np.ndarray) -> np.ndarray:
        out = np.zeros(len(samples), dtype=bool)
        s = np.asarray(samples, dtype=np.float64) / 32768.0
        for i, x in enumerate(s):
            for b, (b0, b1, b2, a1, a2) in enumerate(self.coefs):
                z1, z2 = self.z[b]
                y = b0 * x + z1
                self.z[b, 0] = b1 * x - a1 * y + z2
                self.z[b, 1] = b2 * x - a2 * y
                self.e[b] += y * y
            self.pos += 1
            if self.pos >= self.frame_len:
                self._frame_decision()
                self.pos = 0
            out[i] = bool(self.cur)
        return out


class SpeechDetector:
    """Segmenter with head/tail margins over the VAD trigger
    (reference adin_cut: triggering, margins, segment callbacks)."""

    def __init__(self, cfg: VADConfig):
        self.cfg = cfg
        self.vad = ZeroCrossVAD(cfg)
        self.fvad = (SubbandVAD(cfg.fvad_mode, cfg.sample_rate,
                                cfg.fvad_smooth, cfg.fvad_thres)
                     if getattr(cfg, "fvad_mode", -1) >= 0 else None)
        sr = cfg.sample_rate
        self.head = int(sr * cfg.head_margin_ms / 1000)
        self.tail = int(sr * cfg.tail_margin_ms / 1000)
        self.reset()

    def reset(self):
        self.vad.reset()
        if self.fvad is not None:
            self.fvad.reset()
        self._buf = np.zeros(0, dtype=np.float32)
        self._in_speech = False
        self._silence_run = 0
        self._consumed = 0

    def feed(self, samples: np.ndarray) -> List[dict]:
        """Feed samples; returns events: {"type": "start"} /
        {"type": "samples", "data": ...} / {"type": "end"}."""
        events: List[dict] = []
        trig = self.vad.feed(samples)
        if self.fvad is not None:
            trig = trig & self.fvad.feed(samples)
        s = np.asarray(samples, dtype=np.float32)
        self._buf = np.concatenate([self._buf, s])
        base = len(self._buf) - len(s)
        for i in range(len(s)):
            pos = base + i
            if not self._in_speech:
                if trig[i]:
                    start = max(0, pos - self.head)
                    events.append({"type": "start"})
                    events.append({"type": "samples",
                                   "data": self._buf[start: pos + 1]})
                    self._in_speech = True
                    self._silence_run = 0
            else:
                events.append({"type": "samples",
                               "data": self._buf[pos: pos + 1]})
                if trig[i]:
                    self._silence_run = 0
                else:
                    self._silence_run += 1
                    if self._silence_run >= self.tail:
                        events.append({"type": "end"})
                        self._in_speech = False
                        self._silence_run = 0
        # keep only the head-margin window of history
        if not self._in_speech and len(self._buf) > self.head:
            self._buf = self._buf[-self.head:]
        # coalesce adjacent sample events
        merged: List[dict] = []
        for e in events:
            if (e["type"] == "samples" and merged
                    and merged[-1]["type"] == "samples"):
                merged[-1]["data"] = np.concatenate(
                    [merged[-1]["data"], e["data"]])
            else:
                merged.append(e)
        return merged
