"""Audio file input — WAV / RAW readers and writers.

Reference: libsent/src/adin/adin_file.c (16-bit PCM WAV + big-endian RAW +
stdin), libsent/src/anlz/wrwav.c (writer).  Only 16-bit mono PCM is
supported, like the reference."""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (int16 samples as float32 array, sample_rate)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV supported")
        n = w.getnframes()
        rate = w.getframerate()
        raw = w.readframes(n)
        data = np.frombuffer(raw, dtype="<i2")
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
    return data.astype(np.float32), rate


def read_raw(path: str, big_endian: bool = True) -> np.ndarray:
    """RAW file: 16 bit, big endian by default (reference adin_file.c docs)."""
    dt = ">i2" if big_endian else "<i2"
    return np.fromfile(path, dtype=dt).astype(np.float32)


def read_audio(path: str) -> np.ndarray:
    """Dispatch on extension: .wav via the RIFF reader, anything else as
    big-endian RAW (reference adin_file.c adin_file_begin)."""
    if path.lower().endswith(".wav"):
        return read_wav(path)[0]
    return read_raw(path)


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    s = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(s.tobytes())
