"""Windowed seeded word Viterbi (pass-2 scan_word): the hand-written CUDA
kernel and its plain PyTorch version.

Port of `julius_tpu/search/scan.py:317` `_scan_core_win`, an XLA scan,
together with the outprob fetch its callers do in front of it.  K word
chains each walk a W-frame window starting at frame t0[k] of utterance
bidx[k]; every frame does the in-word shifted-arc max, the seeded word
entry, the emission and the word-end argmax (csrc/scan_win.cu has the
rules).  The kernel reads the outprob values `out_ext[bidx[k], t0[k] +
i, sidx[k, n]]` itself, so the callers pass the [B, T, R] outprob cache
and the chains' senone maps instead of a gathered [K, W, N] block; the
plain version takes the same arguments so the two stay comparable.

`scan_core_win` runs the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel on their card or raises; `LAUNCHES`
counts launches.  Called while its stream captures a CUDA graph (the
device A*'s round, search/pass2_device.py), it records the launch into
the graph instead, counted in `CAPTURED`; whoever replays the graph
counts the launches there.
The kernel is built with nvcc at first use (ops/cuda_build.py).  For
chains with N + KL <= 32 and KL <= 3 (every flagship word) it is
warp-specialised: a recurrence warp carries each node's score and entry
index through CHUNK-frame chunks, gather warps copy the chunks' outprob
values ahead of it, and an argmax warp takes each frame's first best
word end a chunk behind.
"""

from __future__ import annotations

import ctypes

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
MAX_K1 = 9              # in-word arc span + 1 the kernel holds
MAX_NODES = 1024        # one thread a node past the warp template
CHUNK = 32              # frames a stage of the warp-specialised kernel

SOURCE = cuda_build.CSRC / "scan_win.cu"

#: kernel launches made through `scan_core_win` in this process
LAUNCHES = 0
#: launches `scan_core_win` recorded into CUDA graphs under capture
CAPTURED = 0
_lib = None


def _shift(x: torch.Tensor, j: int, fill) -> torch.Tensor:
    """x[:, n-j] along the node axis, `fill` where n-j < 0 (everywhere
    when j reaches past the chain, as in the kernel)."""
    K, N = x.shape
    return torch.cat([x.new_full((K, min(j, N)), fill),
                      x[:, :max(N - j, 0)]], dim=1)


def scan_core_win_plain(loc, ent, ext, sidx, seed, out_ext, bidx, t0):
    """K windowed word-chain scans in plain PyTorch (the kernel's oracle).

    loc [K, KL+1, N] shifted in-word arc ln p; ent / ext [K, N] word entry
    / exit ln p; sidx [K, N] i32 outprob columns; seed [K, W] score for
    entering at window frame i; out_ext [B, T, R] outprob cache; bidx /
    t0 [K] i32 utterance and absolute start frame of each window.
    Returns (g, beg, sv), each [K, W]: the best word-end score at each
    frame, that path's entry frame (absolute) and its seed at entry."""
    K, K1, N = loc.shape
    W = seed.shape[1]
    B, T, _ = out_ext.shape
    t_abs = (t0.long()[:, None]
             + torch.arange(W, device=seed.device)).to(torch.int32)
    tc = t_abs.long().clamp(0, T - 1)
    b = bidx.long().clamp(0, B - 1)
    outw = out_ext[b[:, None, None], tc[:, :, None],
                   sidx.long()[:, None, :]]                      # [K, W, N]
    sc = torch.full((K, N), LOG_ZERO, dtype=torch.float32,
                    device=seed.device)
    efr = torch.zeros((K, N), dtype=torch.int32, device=seed.device)
    sv = torch.full_like(sc, LOG_ZERO)
    g, beg, svo = [], [], []
    for i in range(W):
        # running strict-> max from j = 0: ties keep the smallest j
        mx, we, ws = sc + loc[:, 0], efr, sv
        for j in range(1, K1):
            c = _shift(sc, j, LOG_ZERO) + loc[:, j]
            hit = c > mx
            mx = torch.where(hit, c, mx)
            we = torch.where(hit, _shift(efr, j, 0), we)
            ws = torch.where(hit, _shift(sv, j, LOG_ZERO), ws)
        st = seed[:, i:i + 1]
        ent_t = st + ent
        enter = ent_t > mx
        base = torch.maximum(ent_t, mx)
        sc = torch.where(base > NEG_HALF, base + outw[:, i], LOG_ZERO)
        efr = torch.where(enter, t_abs[:, i:i + 1], we)
        sv = torch.where(enter, st, ws)
        endv = torch.where(sc > NEG_HALF, sc + ext, LOG_ZERO)
        an = endv.argmax(dim=1, keepdim=True)        # first maximum
        g.append(endv.gather(1, an))
        beg.append(efr.gather(1, an))
        svo.append(sv.gather(1, an))
    return torch.cat(g, 1), torch.cat(beg, 1), torch.cat(svo, 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare `scan_win_launch`'s C signature on a loaded library."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.scan_win_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
        vp, vp, vp, vp]
    lib.scan_win_launch.restype = i32
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(cuda_build.load(SOURCE))
    return _lib


def scan_core_win(loc, ent, ext, sidx, seed, out_ext, bidx, t0):
    """K windowed word-chain scans (arguments as `scan_core_win_plain`).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Callers keep t0 + W <= T and sidx inside R."""
    global LAUNCHES, CAPTURED
    dev = seed.device
    if dev.type == "cpu":
        return scan_core_win_plain(loc, ent, ext, sidx, seed, out_ext, bidx,
                                   t0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    K, K1, N = loc.shape
    W = seed.shape[1]
    B, T, R = out_ext.shape
    if not 1 <= K1 <= MAX_K1:
        raise ValueError(f"loc has {K1} shifts, expected 1..{MAX_K1}")
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"chains of {N} nodes, expected 1..{MAX_NODES}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("loc", loc, f32, (K, K1, N)), ("ent", ent, f32, (K, N)),
            ("ext", ext, f32, (K, N)), ("sidx", sidx, i32, (K, N)),
            ("seed", seed, f32, (K, W)), ("out_ext", out_ext, f32, (B, T, R)),
            ("bidx", bidx, i32, (K,)), ("t0", t0, i32, (K,))):
        cuda_build.check_arg(name, t, dt, shape, dev)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build()
    g = seed.new_empty((K, W))
    beg = seed.new_empty((K, W), dtype=i32)
    sv = seed.new_empty((K, W))
    with cuda_build.on_device(dev):
        rc = lib.scan_win_launch(
            loc.data_ptr(), ent.data_ptr(), ext.data_ptr(), sidx.data_ptr(),
            seed.data_ptr(), out_ext.data_ptr(), bidx.data_ptr(),
            t0.data_ptr(), K, K1, N, W, B, T, R, g.data_ptr(),
            beg.data_ptr(), sv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"scan_win kernel launch failed: CUDA error {rc}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return g, beg, sv
