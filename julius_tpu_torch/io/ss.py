"""Noise spectrum files for spectral subtraction (-ssload / mkss).

Reference: `mkss/mkss.c` (record silence, write mean magnitude
spectrum) and `libsent/src/wav2mfcc/ss.c:66` new_SS_load_from_file
(int32 length + float32 array).  Byte order follows the file (length
sanity-checked both ways, since mkss writes native order).
"""

from __future__ import annotations

import struct

import numpy as np


def load_noise_spectrum(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    for order in ("<", ">"):
        (n,) = struct.unpack(order + "i", raw[:4])
        if 0 < n <= 65536 and len(raw) >= 4 + 4 * n:
            return np.frombuffer(raw[4: 4 + 4 * n],
                                 dtype=order + "f4").astype(np.float32)
    raise ValueError(f"not a noise spectrum file: {path}")


def save_noise_spectrum(path: str, spec: np.ndarray) -> None:
    spec = np.asarray(spec, dtype="<f4")
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(spec)))
        f.write(spec.tobytes())


def estimate_noise_spectrum(wave: np.ndarray, cfg) -> np.ndarray:
    """Mean magnitude spectrum over all frames of a (silence) recording
    (reference new_SS_calculate, ss.c:111), on the host: the recording
    is framed as the front end frames it (frontend/mfcc.py
    `_frame_signal`), pre-emphasised and windowed as the analysis path
    does."""
    import torch

    from julius_tpu_torch.frontend import mfcc as fe

    frames = fe._frame_signal(torch.as_tensor(
        np.asarray(wave, np.float32)[None]), cfg)[0].numpy()
    k = cfg.preemph
    pre = np.concatenate(
        [frames[:, :1] * (1.0 - k), frames[:, 1:] - k * frames[:, :-1]],
        axis=1)
    win = (0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(cfg.frame_size) / (cfg.frame_size - 1)))
    spec = np.abs(np.fft.rfft(pre * win, n=cfg.fft_size, axis=1))
    return spec.mean(axis=0).astype(np.float32)[: cfg.fft_size // 2 + 1]
