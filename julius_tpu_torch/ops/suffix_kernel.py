"""The device A*'s suffix estimate: the hand-written CUDA kernel and its
plain version.

No TPU kernel stands behind it: the reference computes the estimate on
the host (`julius_tpu/search/pass2_device.py` `_suffix_estimate_np`), as
`search/pass2_device.py` `prepare` still does on the CPU.  On a CUDA card
`prepare` computes it here instead, for every utterance of the batch at
once, from the pass-1 trellis that already lies on the card.

`suffix(trellis, n_frames, fmax, lr, ratio)` gives the [B, T] f64 rest of
each row: bit-equal to `_suffix_estimate_np` over the row's first
n_frames[b] frames, on the atom tables and re-weighted increments that
`prepare` builds from them, and -inf from n_frames[b] on (every frame of
a row of 0 frames).  CPU tensors take the plain version, `suffix_plain`;
CUDA tensors launch the kernel (csrc/suffix.cu, built with nvcc at first
use, ops/cuda_build.py) on their card or raise.  `LAUNCHES` counts
launches.

The plain version follows the kernel's order of work, not numpy's: the
per-atom increments of the whole trellis first, the two f32 running sums
one frame at a time, then the rows from the last frame back, each row
pushing its atoms' values into the frames it can follow once its own
value is final (the numpy loop pulls each frame's value from the atoms
that begin after it).  The candidates and every rounding are the same,
and a maximum is exact in any order, so both give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from julius_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "suffix.cu"

SMEM_MAX = 232448       # shared memory a block may take on an H100
#: most atoms a lane of the kernel weighs for one target frame
LANE_ATOMS = 8
#: threads of a block (an utterance)
THREADS = 1024

#: kernel launches made through `suffix` in this process
LAUNCHES = 0
_lib = None


def suffix_plain(trellis, n_frames: Sequence[int],
                 fmax: Optional[torch.Tensor], lr: int,
                 ratio: float) -> torch.Tensor:
    """The suffix estimate of each trellis row in numpy, in the kernel's
    order (the module docstring): [B, T] f64, on the CPU."""
    word, score, lm, prev, begin = (np.asarray(x.cpu()) for x in trellis[:5])
    fm = None if fmax is None else np.asarray(fmax.cpu())
    B, T, M = word.shape
    out = np.full((B, T), -np.inf)
    for b, Tb in enumerate(int(n) for n in n_frames):
        if Tb <= 0:
            continue
        w, bg = word[b, :Tb], begin[b, :Tb]
        # each atom's increment, the predecessor's score gathered
        asc = score[b, :Tb].astype(np.float64)
        alm = lm[b, :Tb].astype(np.float64)
        pv = prev[b, :Tb]
        ps = np.where(pv >= 0, score[b].reshape(-1)[np.maximum(pv, 0)],
                      np.float32(0.0)).astype(np.float64)
        inc = np.where(w >= 0, ((asc - ps) - alm) + alm * ratio, -np.inf)
        # the running sums: one f32 add a frame
        cfm, cfm0 = np.zeros(Tb + 1), np.zeros(Tb + 1)
        if fm is not None:
            s = s0 = np.float32(0.0)
            for t in range(Tb):
                x = fm[b, t]
                x0 = x if x < 0 else np.float32(0.0)
                s, s0 = (s + x, s0 + x0) if t else (x, x0)
                cfm[t + 1], cfm0[t + 1] = s, s0
        # the rows from the last frame back, each pushing into its targets
        acc = np.full(Tb, -np.inf)
        for e in range(Tb - 1, 0, -1):
            r = 0.0 if e == Tb - 1 else acc[e]
            valid = w[e] >= 0
            if r == -np.inf or not valid.any():
                continue
            first = max(int((bg[e][valid] - 1 - lr).min()), 0)
            t = np.arange(first, e)[:, None]
            bm = bg[e][None, :]
            bc = np.clip(bm, 0, Tb)
            adj = np.where(bc >= t + 1, cfm0[bc] - cfm0[t + 1],
                           cfm[bc] - cfm[t + 1])
            v = np.where((bm - 1 - lr <= t) & (t <= bm - 1 + lr),
                         (adj + inc[e][None, :]) + r, -np.inf)
            acc[first:e] = np.maximum(acc[first:e], v.max(axis=1))
        out[b, :Tb - 1] = acc[:Tb - 1]
        out[b, Tb - 1] = 0.0
    return torch.from_numpy(out)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, its C
    interface declared."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.suffix_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, ctypes.c_double,
            i32, i32, i32, i64, vp, vp, vp, vp, vp]
        lib.suffix_launch.restype = i32
        _lib = lib
    return _lib


def plan(M: int):
    """(G, threads) of a launch over trellis rows of M atoms: G lanes a
    target frame, the smallest power of two that leaves each lane at most
    LANE_ATOMS atoms (at most a warp's 32 lanes), and THREADS threads, so
    THREADS / G target frames a pass (256 at M = 32, 64 at M = 128)."""
    G = 1
    while G < 32 and G * LANE_ATOMS < M:
        G *= 2
    return G, THREADS


def smem_bytes(T: int, M: int, in_shared: bool) -> int:
    """Shared memory of one block, as csrc/suffix.cu lays it out: the two
    staged rows (40 bytes an atom: two running sums, the increment, the
    window and clamped begin as an int4), and where they fit there the
    frame arrays (acc, the two running sums, the lowest targets: 28
    bytes a frame)."""
    return 80 * M + ((8 * T + 16 * (T + 1) + 4 * T) if in_shared else 0)


def suffix(trellis, n_frames: Sequence[int], fmax: Optional[torch.Tensor],
           lr: int, ratio: float) -> torch.Tensor:
    """The suffix estimate of each row of the [B, T, M] trellis (word,
    score, lm, prev, begin, as `search/pass1.py` `pass1_batch` gives
    them) over its first n_frames[b] frames (host ints, each at most T),
    charging the [B, T] f32 frame maxima `fmax` (None: no charge), with
    lookup range `lr` and the pass-2 / pass-1 LM weight ratio: [B, T]
    f64 on the trellis's device.  CPU tensors take `suffix_plain`; CUDA
    tensors launch the kernel, which the caller reads after it ends."""
    global LAUNCHES
    d = trellis.word.device
    if d.type == "cpu":
        return suffix_plain(trellis, n_frames, fmax, lr, ratio)
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d}")
    f32, i32, f64 = torch.float32, torch.int32, torch.float64
    B, T, M = trellis.word.shape
    for name, dt in (("word", i32), ("score", f32), ("lm", f32),
                     ("prev", i32), ("begin", i32)):
        x = getattr(trellis, name)
        cuda_build.check_arg(name, x, dt, (B, T, M), d)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if fmax is not None:
        cuda_build.check_arg("fmax", fmax, f32, (B, T), d)
        if not fmax.is_contiguous():
            raise ValueError("fmax must be contiguous")
    n = [int(x) for x in n_frames]
    if len(n) != B or any(x < 0 or x > T for x in n):
        raise ValueError(f"n_frames {n} for {B} rows of {T} frames")
    lr = int(lr)
    if lr < 0:
        raise ValueError(f"lookup range {lr} < 0")
    G, threads = plan(M)
    if threads < M:
        raise ValueError(f"suffix takes at most {threads} atoms a frame, "
                         f"not M = {M}")
    in_shared = smem_bytes(T, M, True) <= SMEM_MAX
    smem = smem_bytes(T, M, in_shared)
    lib = build()
    n_dev = torch.tensor(n, dtype=i32, device=d)
    inc = torch.empty((B, T, M), dtype=f64, device=d)
    rest = torch.empty((B, T), dtype=f64, device=d)
    sums = lows = None
    if not in_shared:
        sums = torch.empty((B, 3 * T + 2), dtype=f64, device=d)
        lows = torch.empty((B, T), dtype=i32, device=d)

    def ptr(x):
        return None if x is None else x.data_ptr()
    with cuda_build.on_device(d):
        rc = lib.suffix_launch(
            *[getattr(trellis, f).data_ptr()
              for f in ("word", "score", "lm", "prev", "begin")],
            n_dev.data_ptr(), ptr(fmax), B, T, M, lr, float(ratio), G,
            threads, int(in_shared), smem, inc.data_ptr(), ptr(sums),
            ptr(lows), rest.data_ptr(),
            torch.cuda.current_stream(d).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"suffix kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return rest
