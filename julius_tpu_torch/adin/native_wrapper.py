"""ctypes wrapper for the native adin runtime (builds on first use).

Port of `julius_tpu/adin/native_wrapper.py`.  The shared library
compiles from the package's own adin/native/adin.cpp (host code, not a
device kernel) with g++ at first use into the git-ignored
`julius_tpu_torch/_build/`, named by a hash of the source and the
flags, so a changed source builds anew.  Where no compiler is found,
`make_speech_detector` falls back to the Python segmenter in
frontend/stream.py (same semantics, about 100x slower per sample), as
the reference does; `native_available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from julius_tpu_torch.utils.jlog import LogLevel, jlog

_LIB = None
_LIB_TRIED = False

SOURCE = Path(__file__).resolve().parent / "native" / "adin.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def library_path() -> Path:
    """Where the library of SOURCE lives, keyed by source and flags."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libadin_{tag[:16]}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp),
                            "-ldl"], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, res in [
            ("zc_create", ctypes.c_void_p), ("seg_create", ctypes.c_void_p),
            ("seg_create2", ctypes.c_void_p),
            ("fvad_create", ctypes.c_void_p),
            ("zmean_create", ctypes.c_void_p),
            ("dec_create", ctypes.c_void_p), ("dec_feed", ctypes.c_int),
        ]:
            getattr(lib, name).restype = res
        lib.zc_create.argtypes = [ctypes.c_int] * 3
        lib.seg_create.argtypes = [ctypes.c_int] * 5
        lib.seg_create2.argtypes = [ctypes.c_int] * 8 + [ctypes.c_float]
        lib.fvad_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float]
        lib.dec_create.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int]
        for name in ("zc_free", "zc_reset", "seg_free", "seg_reset",
                     "zmean_free", "dec_free", "fvad_free", "fvad_reset"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.zc_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p]
        lib.seg_feed.argtypes = lib.zc_feed.argtypes
        lib.fvad_feed.argtypes = lib.zc_feed.argtypes
        lib.zmean_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int]
        lib.dec_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
        lib.cap_open.restype = ctypes.c_void_p
        lib.cap_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int]
        lib.cap_read.restype = ctypes.c_int
        lib.cap_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
        lib.cap_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception as e:  # no compiler, or the build failed
        jlog(LogLevel.WARNING,
             f"native adin unavailable ({e}); using Python fallback")
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _build_lib() is not None


class NativeSpeechDetector:
    """Drop-in for frontend.stream.SpeechDetector backed by the C++
    segmenter; same event dicts."""

    def __init__(self, cfg):
        from julius_tpu_torch.frontend.stream import VADConfig
        self.cfg: VADConfig = cfg
        lib = _build_lib()
        if lib is None:
            raise RuntimeError("native adin not available")
        self._lib = lib
        sr = cfg.sample_rate
        self._h = lib.seg_create2(
            cfg.level, cfg.zc_thres, int(sr * cfg.window_ms / 1000),
            int(sr * cfg.head_margin_ms / 1000),
            int(sr * cfg.tail_margin_ms / 1000),
            getattr(cfg, "fvad_mode", -1), sr,
            getattr(cfg, "fvad_smooth", 5),
            float(getattr(cfg, "fvad_thres", 0.0)))
        self.head = int(sr * cfg.head_margin_ms / 1000)
        self._buf = np.zeros(0, dtype=np.float32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.seg_free(self._h)
            self._h = None

    def reset(self):
        self._lib.seg_reset(self._h)
        self._buf = np.zeros(0, dtype=np.float32)

    def feed(self, samples: np.ndarray) -> List[dict]:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        ev = np.zeros(len(s), dtype=np.uint8)
        self._lib.seg_feed(self._h, s.ctypes.data, len(s), ev.ctypes.data)
        events: List[dict] = []
        self._buf = np.concatenate([self._buf, s])
        base = len(self._buf) - len(s)
        run_start = None
        for i in range(len(s)):
            pos = base + i
            code = ev[i]
            if code == 1:
                start = max(0, pos - self.head)
                events.append({"type": "start"})
                events.append({"type": "samples",
                               "data": self._buf[start: pos + 1]})
                run_start = pos + 1
            elif code == 2 and run_start is None:
                run_start = pos
            elif code == 3:
                end = pos + 1
                if run_start is not None:
                    events.append({"type": "samples",
                                   "data": self._buf[run_start: end]})
                events.append({"type": "end"})
                run_start = None
        if run_start is not None:
            events.append({"type": "samples", "data": self._buf[run_start:]})
        if ev[-1] in (0, 3) if len(ev) else True:
            if len(self._buf) > self.head:
                self._buf = self._buf[-self.head:]
        return events


class NativeDecimator:
    """Integer-factor FIR decimator (the ds48to16.c role); taps designed
    on the Python side with a Kaiser-windowed sinc."""

    def __init__(self, factor: int = 3, n_taps: int = 96,
                 cutoff: float = 0.45):
        lib = _build_lib()
        if lib is None:
            raise RuntimeError("native adin not available")
        self._lib = lib
        t = np.arange(n_taps) - (n_taps - 1) / 2.0
        fc = cutoff / factor
        h = np.sinc(2 * fc * t) * 2 * fc
        h *= np.kaiser(n_taps, 9.0)
        h /= np.sum(h)
        taps = np.ascontiguousarray(h, dtype=np.float32)
        self._h = lib.dec_create(taps.ctypes.data, n_taps, factor)
        self.factor = factor

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dec_free(self._h)
            self._h = None

    def feed(self, samples: np.ndarray) -> np.ndarray:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.zeros(len(s) // self.factor + 2, dtype=np.float32)
        n = self._lib.dec_feed(self._h, s.ctypes.data, len(s),
                               out.ctypes.data)
        return out[:n]


class NativeCapture:
    """Live microphone capture (reference adin_mic_linux_alsa.c /
    adin_pulseaudio.c / adin_oss.c).  The sound libraries are dlopen'd
    by the native layer at runtime; construction raises with the
    backend's reason when no device is usable."""

    def __init__(self, backend: str = "auto", device: str = "",
                 rate: int = 16000):
        lib = _build_lib()
        if lib is None:
            raise RuntimeError("native adin not available (no compiler)")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._h = lib.cap_open(backend.encode(), device.encode(),
                               rate, err, len(err))
        if not self._h:
            raise RuntimeError(
                f"no capture device: {err.value.decode() or backend}")
        self.rate = rate

    def read(self, max_samples: int = 4000) -> Optional[np.ndarray]:
        """Blocking read; None on device error / end of stream."""
        out = np.zeros(max_samples, dtype=np.float32)
        n = self._lib.cap_read(self._h, out.ctypes.data, max_samples)
        if n < 0:
            return None
        return out[:n]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.cap_close(self._h)
            self._h = None

    __del__ = close


class FakeCapture:
    """File-replay capture with the NativeCapture interface - lets the
    whole mic pipeline (trigger, margins, streaming decode) run in
    environments without audio hardware, and doubles as the test
    harness for the -input mic path."""

    def __init__(self, path: str, rate: int = 16000,
                 chunk: int = 4000):
        from julius_tpu_torch.io.wav import read_audio
        self._audio = np.asarray(read_audio(path), dtype=np.float32)
        self._pos = 0
        self._chunk = chunk
        self.rate = rate

    def read(self, max_samples: int = 4000) -> Optional[np.ndarray]:
        if self._pos >= len(self._audio):
            return None
        n = min(max_samples, self._chunk, len(self._audio) - self._pos)
        out = self._audio[self._pos: self._pos + n]
        self._pos += n
        return out

    def close(self):
        pass


def make_capture(source: str = "auto", device: str = "",
                 rate: int = 16000):
    """Capture factory: 'mic'/'auto'/'alsa'/'pulseaudio'/'oss' open a
    real device; 'fake:<wavfile>' replays a file through the same
    interface."""
    if source.startswith("fake:"):
        return FakeCapture(source[5:], rate=rate)
    return NativeCapture(source, device, rate)


def make_speech_detector(cfg):
    """Best available segmenter: native C++ if buildable, else Python."""
    try:
        return NativeSpeechDetector(cfg)
    except Exception:
        from julius_tpu_torch.frontend.stream import SpeechDetector
        return SpeechDetector(cfg)
