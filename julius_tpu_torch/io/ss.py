"""Noise spectrum files for spectral subtraction (-ssload).

Reference: `libsent/src/wav2mfcc/ss.c:66` new_SS_load_from_file (int32
length + float32 array).  Byte order follows the file (length
sanity-checked both ways, since mkss writes native order).  The mkss
estimator comes with the streaming input (ROADMAP.md queue 1).
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
