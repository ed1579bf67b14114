"""Fused pass-1 beam update: the hand-written CUDA kernel and its plain
PyTorch version.

Port of `julius_tpu/ops/pass1_kernel.py` (`_step_kernel` / `fused_step`,
the reference package's only TPU kernel).  One call advances every node
of B utterances by one frame: in-word shifted-arc max, cross-word entry
merge, emission and freeze, in one pass over the [B, N] state.  The
kernel (csrc/pass1_step.cu) also fuses the outprob gather
`row[b, score_idx[n]]`, so the caller passes the frame row and the
node->senone map instead of a [B, N] out_node tensor; the plain version
takes the same arguments so the two stay comparable.

`fused_step` runs the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises; `LAUNCHES` counts launches.
The kernel is built with nvcc at first use, from the source in this
package, into `julius_tpu_torch/_build/` keyed by a hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
MAX_K1 = 9              # K + 1 with K <= search.pass1.MAX_LOCAL_K

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pass1_step.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches made through `fused_step` in this process
LAUNCHES = 0
_lib = None


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[:, n-k] along the node axis, `fill` where n-k < 0."""
    return torch.cat([x.new_full((x.shape[0], k), fill), x[:, :-k]], dim=1)


def fused_step_plain(score, ctx, prev, loc_lp, entry_total, row, score_idx,
                     ent_s, ectx_s, eprev_s, frame_valid):
    """One beam-update frame in plain PyTorch (the kernel's oracle).

    score/ctx/prev: [B, N] f32/i32/i32 state; loc_lp: [K+1, N] shifted-
    arc ln p; entry_total: [N] (LOG_ZERO = no word entry); row: [B, R]
    this frame's outprob row; score_idx: [N] i32 node -> row column;
    ent_s/ectx_s/eprev_s: [B] best corrected word-end score / LM context
    / trellis pointer; frame_valid: [B] bool.
    Returns (new_score, new_ctx, new_prev)."""
    inw = score + loc_lp[0]
    c, p = ctx, prev
    # running strict-> max over shifted arcs: ties keep the smallest k
    for k in range(1, loc_lp.shape[0]):
        cand = _shift(score, k, LOG_ZERO) + loc_lp[k]
        hit = cand > inw
        c = torch.where(hit, _shift(ctx, k, -1), c)
        p = torch.where(hit, _shift(prev, k, -1), p)
        inw = torch.maximum(inw, cand)
    cand_e = torch.where(entry_total > NEG_HALF,
                         ent_s[:, None] + entry_total, LOG_ZERO)
    use_e = cand_e > inw
    merged = torch.where(use_e, cand_e, inw)
    c = torch.where(use_e, ectx_s[:, None], c)
    p = torch.where(use_e, eprev_s[:, None], p)
    out_node = row[:, score_idx.long()]
    ns = torch.where(merged > NEG_HALF, merged + out_node, LOG_ZERO)
    fv = frame_valid[:, None]
    return (torch.where(fv, ns, score), torch.where(fv, c, ctx),
            torch.where(fv, p, prev))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.  The
    ptxas report (registers, spills) lands beside it as `.log`."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libpass1_step_{tag[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pass1_step_launch.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, i64, vp, vp, vp, vp, vp,
        vp, vp, vp, i32, i32, vp]
    lib.pass1_step_launch.restype = i32
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def fused_step(score, ctx, prev, loc_lp, entry_total, row, score_idx,
               ent_s, ectx_s, eprev_s, frame_valid):
    """One beam-update frame (arguments as `fused_step_plain`).  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    Returns fresh (new_score, new_ctx, new_prev) tensors.  score_idx
    must index inside row's width (the network build guarantees it)."""
    global LAUNCHES
    dev = score.device
    if dev.type == "cpu":
        return fused_step_plain(score, ctx, prev, loc_lp, entry_total, row,
                                score_idx, ent_s, ectx_s, eprev_s,
                                frame_valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N = score.shape
    k1 = loc_lp.shape[0]
    if not 1 <= k1 <= MAX_K1:
        raise ValueError(f"loc_lp has {k1} shifts, expected 1..{MAX_K1}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("score", score, f32, (B, N)), ("ctx", ctx, i32, (B, N)),
            ("prev", prev, i32, (B, N)), ("loc_lp", loc_lp, f32, (k1, N)),
            ("entry_total", entry_total, f32, (N,)),
            ("row", row, f32, (B, row.shape[-1])),
            ("score_idx", score_idx, i32, (N,)), ("ent_s", ent_s, f32, (B,)),
            ("ectx_s", ectx_s, i32, (B,)), ("eprev_s", eprev_s, i32, (B,)),
            ("frame_valid", frame_valid, torch.bool, (B,))):
        _check(name, t, dt, shape, dev)
        if name != "row" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row.stride(1) != 1:
        raise ValueError("row must be contiguous along its last axis")
    lib = build()
    o_score = torch.empty_like(score)
    o_ctx = torch.empty_like(ctx)
    o_prev = torch.empty_like(prev)
    rc = lib.pass1_step_launch(
        score.data_ptr(), ctx.data_ptr(), prev.data_ptr(), loc_lp.data_ptr(),
        k1, entry_total.data_ptr(), row.data_ptr(), row.stride(0),
        score_idx.data_ptr(), ent_s.data_ptr(), ectx_s.data_ptr(),
        eprev_s.data_ptr(), frame_valid.data_ptr(), o_score.data_ptr(),
        o_ctx.data_ptr(), o_prev.data_ptr(), B, N,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pass1_step kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o_score, o_ctx, o_prev
