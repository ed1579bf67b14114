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
tensors it launches the kernel on their card or raises; `LAUNCHES`
counts launches.  Called while its stream captures a CUDA graph (pass
1's frame step, search/pass1.py), it records the launch into the graph
instead, counted in `CAPTURED`; whoever replays the graph counts the
launches there.
The kernel is built with nvcc at first use, from the source in this
package (ops/cuda_build.py).  `launch_plan` sizes its launch: one block
a tile of nodes across all B rows, the tile's tables in shared memory
for all of them, its warps sharing the rows, each lane holding one
16-byte chunk of a row's state.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2
MAX_K1 = 9              # K + 1 with K <= search.pass1.MAX_LOCAL_K

SOURCE = cuda_build.CSRC / "pass1_step.cu"

# launch plan limits, as csrc/pass1_step.cu takes them
N_SM = 132              # SMs of an H100 SXM
MAX_WARPS = 8           # warps a block (the kernel's launch bound)
TAB_STRIDE = 128        # words a tile row takes in shared memory
L2_BYTES = 50 << 20     # L2 of an H100: a larger output is streamed out
MODEL_REGISTERS = 96    # registers a thread, for plans made off the card

#: kernel launches made through `fused_step` in this process, a launch
#: a CUDA graph holds counted at each replay of the graph
LAUNCHES = 0
#: launches `fused_step` recorded into CUDA graphs under capture
CAPTURED = 0
_lib = None


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[:, n-k] along the node axis, `fill` where n-k < 0."""
    return torch.cat([x.new_full((x.shape[0], k), fill), x[:, :-k]], dim=1)


def fused_step_plain(score, ctx, prev, loc_lp, entry_total, row, score_idx,
                     ent_s, ectx_s, eprev_s, frame_valid, out=None):
    """One beam-update frame in plain PyTorch (the kernel's oracle).

    score/ctx/prev: [B, N] f32/i32/i32 state; loc_lp: [K+1, N] shifted-
    arc ln p; entry_total: [N] (LOG_ZERO = no word entry); row: [B, R]
    this frame's outprob row; score_idx: [N] i32 node -> row column;
    ent_s/ectx_s/eprev_s: [B] best corrected word-end score / LM context
    / trellis pointer; frame_valid: [B] bool; out: None, or three
    tensors like score/ctx/prev, apart from them, that the new state is
    written into.
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
    return freeze(frame_valid, (ns, c, p), (score, ctx, prev), out)


def freeze(frame_valid, new, old, out=None):
    """The step's last write: each of the `new` [B, N] tensors where the
    [B] frame_valid holds, else the `old` one, into `out` where given
    (the state set the next frame reads), else into fresh tensors."""
    fv = frame_valid[:, None]
    if out is None:
        return tuple(torch.where(fv, n, o) for n, o in zip(new, old))
    for n, o, dst in zip(new, old, out):
        torch.where(fv, n, o, out=dst)
    return tuple(out)


def tile_nodes(K1: int) -> int:
    """Nodes a tile: a warp's 32 lanes hold one 16-byte chunk each, the
    first ceil(K / 4) the chunks in front of the tile (its halo), and the
    others less one the tile at any alignment."""
    return 4 * (31 - (K1 + 2) // 4)


def modelled_blocks_per_sm(warps: int) -> int:
    """Blocks of `warps` warps an H100 SM holds at once at
    MODEL_REGISTERS registers a thread (the card's own count comes from
    the built kernel, `fused_step`)."""
    return min(32, 64 // warps, 65536 // (32 * warps * MODEL_REGISTERS))


class LaunchPlan(NamedTuple):
    """How one frame launches: one block a tile of `tile` nodes
    (`n_tiles` blocks, the last tile ragged) with its K+1 arc rows, entry
    totals and senone ids in shared memory for all B rows (K+3 rows of
    `tab_stride` words, `smem_bytes` in all), and `warps` warps sharing
    the rows (warp w takes rows w, w + warps, ...); `stream_out` stores
    with the streaming hint."""

    tile: int
    n_tiles: int
    warps: int
    tab_stride: int
    smem_bytes: int
    stream_out: bool


def launch_plan(B: int, N: int, K1: int, n_sm: int = N_SM,
                blocks_per_sm=modelled_blocks_per_sm) -> LaunchPlan:
    """The launch of one frame at B rows of N nodes with K1 arc shifts on
    a card of n_sm SMs holding blocks_per_sm(warps) blocks each: the most
    warps a tile (a power of two, at most MAX_WARPS and B) with which
    every block is resident at once; the streaming hint where the three
    outputs outgrow L2, so the next frame could not find them there."""
    if not (B >= 1 and N >= 1 and 1 <= K1 <= MAX_K1):
        raise ValueError(f"no launch plan for B={B}, N={N}, K1={K1}")
    tile = tile_nodes(K1)
    n_tiles = -(-N // tile)
    warps = 1
    while (warps * 2 <= min(B, MAX_WARPS)
           and n_tiles <= n_sm * blocks_per_sm(warps * 2)):
        warps *= 2
    return LaunchPlan(tile, n_tiles, warps, TAB_STRIDE,
                      4 * (K1 + 2) * TAB_STRIDE, B * N * 12 > L2_BYTES)


_plans = {}


def _plan(dev: torch.device, B: int, N: int, K1: int) -> LaunchPlan:
    """launch_plan on the card `dev`, from its SM count and the built
    kernel's own occupancy (cached per shape)."""
    key = (dev, B, N, K1)
    if key not in _plans:
        lib = bind(cuda_build.load(SOURCE))
        with torch.cuda.device(dev):
            n_sm = torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count

            def blocks_per_sm(warps):
                n = ctypes.c_int(0)
                rc = lib.pass1_step_blocks_per_sm(
                    K1, warps, 4 * (K1 + 2) * TAB_STRIDE, ctypes.byref(n))
                if rc != 0:
                    raise RuntimeError("pass1_step occupancy query failed: "
                                       f"CUDA error {rc}")
                return n.value
            _plans[key] = launch_plan(B, N, K1, n_sm, blocks_per_sm)
    return _plans[key]


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    _lib = bind(cuda_build.load(SOURCE))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built library of the kernel."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pass1_step_launch.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, i64, vp, vp, vp, vp, vp,
        vp, vp, vp, i32, i32, vp, i32, i32, i32, i32]
    lib.pass1_step_launch.restype = i32
    if hasattr(lib, "pass1_step_blocks_per_sm"):
        lib.pass1_step_blocks_per_sm.argtypes = [i32, i32, i32, vp]
        lib.pass1_step_blocks_per_sm.restype = i32
    if hasattr(lib, "pass1_empty_launch"):
        lib.pass1_empty_launch.argtypes = [vp]
        lib.pass1_empty_launch.restype = i32
    return lib


def fused_step(score, ctx, prev, loc_lp, entry_total, row, score_idx,
               ent_s, ectx_s, eprev_s, frame_valid, out=None):
    """One beam-update frame (arguments as `fused_step_plain`).  CPU
    tensors take the plain version; CUDA tensors launch the kernel,
    which writes the new state into `out` where given and allocates
    nothing, else into fresh tensors.  Returns (new_score, new_ctx,
    new_prev).  score_idx must index inside row's width (the network
    build guarantees it); score, ctx, prev and out's tensors must start
    16-byte aligned, as fresh tensors do, and out's may share no memory
    with the state, whose neighbours the kernel reads."""
    global LAUNCHES, CAPTURED
    dev = score.device
    if dev.type == "cpu":
        return fused_step_plain(score, ctx, prev, loc_lp, entry_total, row,
                                score_idx, ent_s, ectx_s, eprev_s,
                                frame_valid, out)
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
        cuda_build.check_arg(name, t, dt, shape, dev)
        if name != "row" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row.stride(1) != 1:
        raise ValueError("row must be contiguous along its last axis")
    state = (score, ctx, prev)
    if out is None:
        out = tuple(torch.empty_like(t) for t in state)
    else:
        out = tuple(out)
        mem = {t.untyped_storage().data_ptr() for t in state}
        for name, o, t in zip(("out score", "out ctx", "out prev"), out,
                              state):
            cuda_build.check_arg(name, o, t.dtype, (B, N), dev)
            if not o.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if o.untyped_storage().data_ptr() in mem:
                raise ValueError(f"{name} shares memory with the state")
    o_score, o_ctx, o_prev = out
    for name, t in (("score", score), ("ctx", ctx), ("prev", prev),
                    ("out score", o_score), ("out ctx", o_ctx),
                    ("out prev", o_prev)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    plan = _plan(dev, B, N, k1)
    lib = build()
    with cuda_build.on_device(dev):
        rc = lib.pass1_step_launch(
            score.data_ptr(), ctx.data_ptr(), prev.data_ptr(),
            loc_lp.data_ptr(), k1, entry_total.data_ptr(), row.data_ptr(),
            row.stride(0), score_idx.data_ptr(), ent_s.data_ptr(),
            ectx_s.data_ptr(), eprev_s.data_ptr(), frame_valid.data_ptr(),
            o_score.data_ptr(), o_ctx.data_ptr(), o_prev.data_ptr(), B, N,
            torch.cuda.current_stream(dev).cuda_stream, plan.warps,
            plan.tab_stride, plan.smem_bytes, int(plan.stream_out))
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"pass1_step kernel launch failed: CUDA error {rc}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return o_score, o_ctx, o_prev


def empty_launch() -> None:
    """Launch the library's empty kernel on the current stream: the floor
    one launch costs, timed the same way as `fused_step`.  Not counted in
    LAUNCHES."""
    rc = build().pass1_empty_launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
