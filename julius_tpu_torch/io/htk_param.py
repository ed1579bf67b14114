"""HTK parameter (feature) file read/write.

Reference: libsent/src/anlz/rdparam.c:198 (read), wrsamp.c (write),
paramtypes.c (param-kind codes).  Binary format: 12-byte header
(nSamples int32, sampPeriod int32 [100ns], sampSize int16 [bytes],
parmKind int16) big-endian, followed by float32 vectors (big-endian).

A copy of `julius_tpu/io/htk_param.py` but for one deliberate
difference: a big-endian file of vectors wider than 5000 bytes that
holds exactly its vectors is read as such (julius_tpu's reader takes it
for little-endian and raises).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# base kind codes (reference paramtypes.c desc_base)
BASE_KINDS = ["WAVEFORM", "LPC", "LPREFC", "LPCEPSTRA", "LPDELCEP", "IREFC",
              "MFCC", "FBANK", "MELSPEC", "USER", "DISCRETE", "PLP"]
# qualifier bits (reference htk_param.h F_ flags)
QUAL_BITS = {
    "E": 0o000100, "N": 0o000200, "D": 0o000400, "A": 0o001000,
    "C": 0o002000, "Z": 0o004000, "K": 0o010000, "0": 0o020000,
}


def kind_str_to_code(kind: str) -> int:
    parts = kind.upper().split("_")
    try:
        code = BASE_KINDS.index(parts[0])
    except ValueError:
        raise ValueError(f"unknown param base kind {parts[0]}")
    for q in parts[1:]:
        if q in QUAL_BITS:
            code |= QUAL_BITS[q]
        else:
            raise ValueError(f"unknown param qualifier _{q}")
    return code


def kind_code_to_str(code: int) -> str:
    base = BASE_KINDS[code & 0o77]
    quals = "".join(f"_{q}" for q, bit in QUAL_BITS.items() if code & bit)
    return base + quals


@dataclass
class HTKParam:
    data: np.ndarray      # [T, D] float32
    samp_period: int      # in 100ns units
    kind: str

    @property
    def veclen(self) -> int:
        return self.data.shape[1]


def read_htk_param(path: str) -> HTKParam:
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        hdr = f.read(12)
        n, period, size, kind = struct.unpack(">iihh", hdr)
        little_endian = False
        # heuristically detect little-endian files (reference rdparam.c
        # retries with byte swap when the header is implausible).  A
        # big-endian header of a vector wider than 5000 bytes (the
        # reference's DNN input rows: 1320 floats are 5280) is taken
        # when the file holds exactly its n vectors, where
        # julius_tpu's reader would swap it and fail
        wide_ok = 12 + n * size == file_size
        if n <= 0 or size <= 0 or (size > 5000 and not wide_ok):
            n, period, size, kind = struct.unpack("<iihh", hdr)
            little_endian = True
            if n <= 0 or size <= 0:
                raise ValueError(f"corrupted HTK param header in {path}")
        if (kind & 0o77) in (0, 5):   # WAVEFORM / IREFC: int16 samples
            dt = "<i2" if little_endian else ">i2"
            dim = size // 2
        else:
            dt = "<f4" if little_endian else ">f4"
            dim = size // 4
        raw = np.frombuffer(f.read(n * size), dtype=dt)
        data = raw.reshape(n, dim).astype(np.float32)
    return HTKParam(data=data, samp_period=period, kind=kind_code_to_str(kind))


def write_htk_param(path: str, param: HTKParam) -> None:
    data = np.asarray(param.data, dtype=np.float32)
    n, dim = data.shape
    kind = kind_str_to_code(param.kind)
    with open(path, "wb") as f:
        f.write(struct.pack(">iihh", n, param.samp_period, dim * 4, kind))
        f.write(data.astype(">f4").tobytes())
