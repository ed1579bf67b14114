"""Pass 1's word-end stage: the hand-written CUDA kernel and its plain
PyTorch version.

Port of the XLA code in the reference's pass-1 step beside its Pallas
kernel: `julius_tpu/search/pass1.py:267` `_word_end_candidates` (the top
2M exits, the exact 2-gram swap for their entry unigram, the best M
kept as the frame's word-end records) and `:592` `_scalar_entry_batched`
(the single best record, the cross-word winner under unigram factoring
or without an LM).  One call takes the [B, N] node state of every
utterance and gives the [B, M] records ("atoms"), and with the frame
index also the [B] winner.

`word_end` runs the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel (csrc/word_end.cu, built with nvcc at
first use, ops/cuda_build.py) on their card or raises, a thread-block
cluster of C blocks a row as `cluster_plan` picks it; `LAUNCHES`
counts launches.  Called while its stream captures a CUDA graph (pass
1's frame step and a stream's chunk row, search/pass1.py), it records
the launch into the graph instead, counted in `CAPTURED`; whoever
replays the graph counts the launches there.

Tie order is part of the result (trellis slot order fixes `prev` ids):
both top-k's are stable descending sorts, so ties go to the lowest
index as `lax.top_k` gives them, and the winner is the first maximum.
The selection is exact: the reference takes `approx_max_k` on a TPU
when Ex > 4k, and its exact `lax.top_k` elsewhere.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.search.ngram_device import bigram_score_fast
from julius_tpu_torch.utils.logadd import LOG_ZERO

NEG_HALF = LOG_ZERO / 2

SOURCE = cuda_build.CSRC / "word_end.cu"

SMEM_MAX = 232448       # shared memory a block may take on an H100
#: most exits a block whose keys (and their compact list) the kernel
#: keeps in shared memory; a wider block keeps the keys in a [B, Ex]
#: scratch tensor
SMEM_KEYS_MAX = 24000
#: SMs of an H100 SXM: a launch of B rows takes at most this many blocks
SMS = 132
#: fewest exits a block of a cluster walks
MIN_BLOCK_EXITS = 1024

#: kernel launches made through `word_end` in this process, a launch a
#: CUDA graph holds counted at each replay of the graph
LAUNCHES = 0
#: launches `word_end` recorded into CUDA graphs under capture
CAPTURED = 0
_lib = None


class Trellis(NamedTuple):
    """Word-end records (reference TRELLIS_ATOM, trellis.h:28-41);
    [B, M] from the word-end stage, [B, T, M] from `pass1_batch`, [T, M]
    per utterance."""

    word: torch.Tensor    # int32 vocab word id (-1 invalid)
    score: torch.Tensor   # f32 accumulated Viterbi score at word end
    lm: torch.Tensor      # f32 LM score of this word (weighted, + penalty)
    prev: torch.Tensor    # int32 flattened atom id of predecessor word end
    begin: torch.Tensor   # int32 first frame of the word
    ectx: torch.Tensor    # int32 effective LM context for what follows


#: Trellis field dtypes, in field order
TRELLIS_DTYPES = (torch.int32, torch.float32, torch.float32, torch.int32,
                  torch.int32, torch.int32)


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (lax.top_k's
    order; torch.topk promises none on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def word_end_candidates(dev, ngram, cfg, score: torch.Tensor,
                        ctx: torch.Tensor, prev: torch.Tensor) -> Trellis:
    """Corrected word-end records [B, M] from the current [B, N] node
    state: the top 2M exits get the exact 2-gram swap for their entry
    unigram (reference beam.c beam_inter_word), then the best M stay.
    `dev` is search.pass1's DeviceNetwork, `cfg` its Pass1Config."""
    M = cfg.n_atoms
    sc_all = score[:, dev.exit_nodes] + dev.exit_nlp           # [B, Ex]
    Ex = sc_all.shape[-1]
    k = min(2 * M, Ex)
    sc, sel = topk_stable(sc_all, k)                          # [B, k]
    ctx_all = ctx[:, dev.exit_nodes]
    prev_k = prev[:, dev.exit_nodes].gather(1, sel)
    ctx_k = ctx_all.gather(1, sel)
    # transparent words pass their inherited LM context onward
    ectx_k = torch.where(dev.exit_transp, ctx_all, dev.exit_w).gather(1, sel)
    w_k = dev.exit_w[sel]
    wlm_k = dev.exit_wlm[sel]
    uni_k = dev.exit_uni[sel]
    if cfg.use_lm and ngram is not None:
        vrow = dev.ctx_info[ctx_k.clamp(min=0).long()]          # [B, k, 2]
        v_lm = torch.where(ctx_k >= 0, vrow[..., 0].to(torch.int32), -1)
        bi = bigram_score_fast(ngram, v_lm, vrow[..., 1], wlm_k, uni_k)
        if cfg.factoring >= 2:
            # the entry already applied the exact 2-gram: no swap
            delta = torch.zeros_like(sc)
        else:
            delta = torch.where(wlm_k >= 0, cfg.lm_weight * (bi - uni_k),
                                0.0)
        lm_sc = torch.where(wlm_k >= 0, cfg.lm_weight * bi + cfg.lm_penalty,
                            cfg.lm_penalty)
    else:
        delta = torch.zeros_like(sc)
        lm_sc = torch.full_like(sc, cfg.lm_penalty)
    corrected = torch.where(sc > NEG_HALF, sc + delta, LOG_ZERO)
    m_eff = min(M, k)
    csc, order = topk_stable(corrected, m_eff)                # [B, m]
    prev_sel = prev_k.gather(1, order)
    atoms = Trellis(
        word=torch.where(csc > NEG_HALF, w_k.gather(1, order), -1),
        score=csc,
        lm=lm_sc.gather(1, order),
        prev=prev_sel,
        begin=torch.where(prev_sel >= 0,
                          torch.div(prev_sel, M, rounding_mode="floor") + 1,
                          0).to(torch.int32),
        ectx=ectx_k.gather(1, order),
    )
    if m_eff < M:
        pad = M - m_eff
        fills = Trellis(word=-1, score=LOG_ZERO, lm=0.0, prev=-1, begin=0,
                        ectx=-1)
        atoms = Trellis(*[
            torch.nn.functional.pad(a, (0, pad), value=f)
            for a, f in zip(atoms, fills)])
    return atoms


def scalar_entry_batched(atoms: Trellis, t, M: int):
    """Batched single-best corrected word-end (the factoring-1
    cross-word winner): [B] score, LM context, trellis pointer.  Ties
    go to the lowest slot, as argmax gives them.  t, the step (an int or
    a [1] int32 tensor), places the pointer in frame t-1's atoms."""
    valid = atoms.word >= 0
    sc = torch.where(valid, atoms.score, LOG_ZERO)
    slots = torch.arange(sc.shape[-1], device=sc.device)
    best = torch.where(sc == sc.max(dim=-1, keepdim=True).values,
                       slots, sc.shape[-1]).min(dim=-1).values     # [B]
    bidx = best[:, None]
    bvalid = valid.gather(1, bidx)[:, 0]
    ent = torch.where(bvalid, sc.gather(1, bidx)[:, 0], LOG_ZERO)
    ectx = torch.where(bvalid, atoms.ectx.gather(1, bidx)[:, 0], -1)
    eprev = ((t - 1) * M + best).to(torch.int32)
    return ent, ectx.to(torch.int32), eprev


def word_end_plain(dev, ngram, cfg, score, ctx, prev, t=None):
    """The word-end stage in plain PyTorch (the kernel's oracle): the
    [B, M] atoms of the [B, N] state (score, ctx, prev), and with t (the
    step, an int or a [1] int32 tensor) the [B] winner (ent, ectx,
    eprev) of frame t-1's atoms, else None."""
    atoms = word_end_candidates(dev, ngram, cfg, score, ctx, prev)
    if t is None:
        return atoms, None
    return atoms, scalar_entry_batched(atoms, t, cfg.n_atoms)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    _lib = bind(cuda_build.load(SOURCE))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built library of the kernel."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.word_end_launch.argtypes = [
        vp, vp, vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32,
        i32, i32, i32, f32, f32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp,
        vp, vp, vp, vp, vp]
    lib.word_end_launch.restype = i32
    lib.word_end_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.word_end_smem_bytes.restype = ctypes.c_size_t
    lib.word_end_max_clusters.argtypes = [i32, i32, i64]
    lib.word_end_max_clusters.restype = i32
    return lib


def cluster_plan(B: int, Ex: int):
    """(C, threads) of a launch over B rows of Ex exits: the largest
    cluster size C of 8, 4 and 2 whose B * C blocks fit the card's SMs
    and whose blocks each walk at least MIN_BLOCK_EXITS exits, with 512
    threads a block (two can share an SM, so all B clusters run at once:
    of 1024-thread blocks an H100 runs 15 clusters of 8); else C = 1,
    one block of 1024 threads a row.  Below MIN_BLOCK_EXITS a block's
    shorter walk no longer pays for a cluster launch's extra cost
    (tools/time_word_end.py --plans, PERF.md)."""
    for C in (8, 4, 2):
        if B * C <= SMS and Ex >= C * MIN_BLOCK_EXITS:
            return C, 512
    return 1, 1024


def smem_bytes(Ex: int, M: int, C: int, threads: int,
               keys_in_shared: bool) -> int:
    """Shared memory of one block of `threads` threads in a cluster of
    C, as csrc/word_end.cu lays it out: for each of k = min(2M, Ex)
    candidates a 32-byte record and an int (rounded to 16 bytes), the
    local histogram, a receive buffer of C histograms for each of four
    passes, state and mbarriers, and, where the keys are kept there,
    the block's nb = ceil(Ex / C) keys and their compact list (nb
    rounded up to a multiple of the threads), 4 bytes each."""
    k = min(2 * M, Ex)
    fixed = 32 * k + (4 * k + 15) // 16 * 16 + 1024 + 4096 * C + 512 + 64
    nb = -(-Ex // C)
    return fixed + (4 * (nb + -(-nb // threads) * threads)
                    if keys_in_shared else 0)


#: (card, C, threads, shared bytes) -> clusters the card runs at once
_CLUSTERS: dict = {}


def max_clusters(lib, d: torch.device, C: int, threads: int,
                 smem: int) -> int:
    """How many clusters of C blocks (threads and shared bytes each) card
    `d` runs at once, asked of the runtime once per configuration."""
    key = (d.index, C, threads, smem)
    if key not in _CLUSTERS:
        with cuda_build.on_device(d):
            _CLUSTERS[key] = lib.word_end_max_clusters(C, threads, smem)
    return _CLUSTERS[key]


def word_end(dev, ngram, cfg, score, ctx, prev, t=None):
    """The word-end stage (arguments and result as `word_end_plain`).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which writes fresh [B, M] atoms and, with t (then a [1] int32 tensor
    on the card), the [B] winner.  score/ctx/prev may be a view whose
    rows are contiguous (pass 1 pads the node axis); exit_nodes must
    index inside a row (the network build guarantees it)."""
    global LAUNCHES, CAPTURED
    d = score.device
    if d.type == "cpu":
        return word_end_plain(dev, ngram, cfg, score, ctx, prev, t)
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d}")
    f32, i32 = torch.float32, torch.int32
    B, N = score.shape
    Ex = dev.exit_nodes.shape[0]
    M = cfg.n_atoms
    for name, x, dt in (("score", score, f32), ("ctx", ctx, i32),
                        ("prev", prev, i32)):
        cuda_build.check_arg(name, x, dt, (B, N), d)
        if x.stride(1) != 1 or x.stride(0) != score.stride(0):
            raise ValueError(f"{name} rows must be contiguous, with "
                             "score's row stride")
    for name, dt in (("exit_nodes", torch.int64), ("exit_nlp", f32),
                     ("exit_w", i32), ("exit_wlm", i32), ("exit_uni", f32),
                     ("exit_transp", torch.bool)):
        x = getattr(dev, name)
        cuda_build.check_arg(name, x, dt, (Ex,), d)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lm_on = bool(cfg.use_lm and ngram is not None)
    info = rows = None
    H = 0
    if lm_on:
        info, rows = dev.ctx_info, ngram.bi_rows
        if info is None:
            raise ValueError("an N-gram decode needs the network's ctx_info")
        H = rows.shape[0]
        cuda_build.check_arg("ctx_info", info, f32, (info.shape[0], 2), d)
        cuda_build.check_arg("bi_rows", rows, i32, (H, 3 if ngram.wide else 2),
                             d)
        if not (info.is_contiguous() and rows.is_contiguous()):
            raise ValueError("ctx_info and bi_rows must be contiguous")
    if t is not None:
        cuda_build.check_arg("t", t, i32, (1,), d)
    C, threads = cluster_plan(B, Ex)
    keys_in_shared = -(-Ex // C) <= SMEM_KEYS_MAX
    smem = smem_bytes(Ex, M, C, threads, keys_in_shared)
    if smem > SMEM_MAX:
        raise ValueError(f"word_end takes at most {SMEM_MAX} bytes of "
                         f"shared memory a block: M = {M} is too large")
    lib = build()
    n = max_clusters(lib, d, C, threads, smem)
    if n < 1:
        raise RuntimeError(
            f"word_end: a cluster of {C} blocks of {threads} threads and "
            f"{smem} bytes of shared memory cannot be scheduled on {d} "
            f"({'CUDA error ' + str(-n) if n < 0 else 'none fits'})")
    atoms = Trellis(*[torch.empty((B, M), dtype=dt, device=d)
                      for dt in TRELLIS_DTYPES])
    ent = torch.empty(B, dtype=f32, device=d)
    ectx_e = torch.empty(B, dtype=i32, device=d)
    eprev = torch.empty(B, dtype=i32, device=d)
    keys = None if keys_in_shared else torch.empty((B, Ex), dtype=i32,
                                                   device=d)

    def ptr(x):
        return None if x is None else x.data_ptr()
    with cuda_build.on_device(d):
        rc = lib.word_end_launch(
            score.data_ptr(), ctx.data_ptr(), prev.data_ptr(),
            score.stride(0), B, Ex, dev.exit_nodes.data_ptr(),
            dev.exit_nlp.data_ptr(), dev.exit_w.data_ptr(),
            dev.exit_wlm.data_ptr(), dev.exit_uni.data_ptr(),
            dev.exit_transp.data_ptr(), ptr(info), ptr(rows), H,
            int(lm_on and ngram.wide), ngram.n_words if lm_on else 0,
            int(lm_on), int(lm_on and cfg.factoring < 2), cfg.lm_weight,
            cfg.lm_penalty, M, C, threads, ptr(t), ptr(keys),
            *[a.data_ptr() for a in atoms], ent.data_ptr(),
            ectx_e.data_ptr(), eprev.data_ptr(),
            torch.cuda.current_stream(d).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"word_end kernel launch failed: CUDA error {rc}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return atoms, (None if t is None else (ent, ectx_e, eprev))
