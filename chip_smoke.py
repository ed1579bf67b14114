#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, in order (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from this checkout,
     one nvcc process per source, all at once; ptxas must report no stack
     and no spills for any kernel;
  3. kernel: each kernel against its plain PyTorch version on the card at
     the main path's shapes (scores within atol 1e-5, integers equal),
     then timed with CUDA events (median of 60 launches after warm-up)
     beside the plain version and the bound: pass1_step (the pass-1 beam
     update) and scan_win (the pass-2 windowed word scan, at the device
     A*'s shape, two of the host re-scan's window buckets, and its edges:
     one frame, a chunk less and more one frame, the whole utterance, and
     chains of 45 nodes);
  4. slice: the full-width flagship engine (5000-word 2-gram, 2004
     senones, 5 x 2048 sigmoid DNN) with the reference's search
     configuration decodes 16 generative utterances through
     Engine.decode_features on the card (DNN, pass 1, device A*, retry
     net, N-best); the kernel launch counts are read around that run,
     then the same decode is staged, the kernel-path trellis is held
     against the plain-path trellis, and the device A* is run again with
     the plain scan in place of the kernel and held against the first;
  5. rescan: the host-driven re-scan (pass2_device=False) on 4 of the
     utterances, held to the device A*'s word ids;
  6. frozen: the frozen-score pass 2 (pass2_rescan=False) on 4 of them;
  7. the kernels' JSON line, the card line, and the result line last.

Weights and utterances are made from fixed seeds; nothing is read from
outside the repository.  Exits non-zero without a result where CUDA is
not available.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
N_UTTS = 16
N_SIDE = 4                    # utterances for the rescan / frozen phases
DEVICE = "cuda"
LOG_ZERO = -1e10


def phase(label, **kv):
    print(json.dumps({"phase": label, **kv}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def step_inputs(dev, etot, B, R, seed, ties):
    """One frame's beam-update arguments at the network's shapes.
    ties=True: integer-valued scores and arc/entry tables, so shifted
    candidates and entries tie exactly; else the network's own tables."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEVICE)

    if ties:
        score = rint(-40, 0, B, N).float()
        loc = rint(-3, 1, K1, N).float()
        loc[rnd(K1, N) < 0.3] = LOG_ZERO
        et = rint(-6, 0, N).float()
        et[rnd(N) < 0.7] = LOG_ZERO
        ent = rint(-40, -20, B).float()
    else:
        score = -100.0 - 50.0 * rnd(B, N)
        loc, et = dev.loc_lp, etot
        ent = -100.0 - 20.0 * rnd(B)
    score[rnd(B, N) < 0.2] = LOG_ZERO
    score[:, 1000:5000] = LOG_ZERO
    ent[0] = LOG_ZERO
    fv = torch.ones(B, dtype=torch.bool, device=DEVICE)
    fv[1::7] = False
    return dict(
        score=score, ctx=rint(-1, 5000, B, N).int(),
        prev=rint(-1, 100000, B, N).int(), loc_lp=loc.contiguous(),
        entry_total=et.contiguous(), row=-10.0 * rnd(B, R),
        score_idx=dev.score_idx, ent_s=ent, ectx_s=rint(-1, 5000, B).int(),
        eprev_s=rint(-1, 100000, B).int(), frame_valid=fv)


def compare_step(pk, args):
    """Kernel vs plain on the same arguments -> (max |score err|, outs)."""
    got = pk.fused_step(**args)
    want = pk.fused_step_plain(**args)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    if err > 1e-5:
        raise RuntimeError(f"kernel scores differ from plain by {err}")
    for i, name in ((1, "ctx"), (2, "prev")):
        if not torch.equal(got[i], want[i]):
            n_bad = int((got[i] != want[i]).sum())
            raise RuntimeError(f"kernel {name} differs at {n_bad} nodes")
    return err, got


def step_bytes(B, N, K1, R):
    """Least bytes one frame must move: state read once and written once,
    the arc/entry/senone-map tables and the frame row read once."""
    state = B * N * (4 + 4 + 4)
    return 2 * state + K1 * N * 4 + N * 4 + N * 4 + B * R * 4 + B * 13


def step_ops(B, N, K1):
    """f32 operations one frame does: per node K+1 arc adds, K compares,
    an entry add and compare, an emission add and its compare."""
    return B * N * (2 * K1 + 3)


def scan_inputs(tabs, K, W, T, R, B, seed, ties):
    """One windowed scan's arguments on the card.  Chains are vocabulary
    words (every fifth the dead chain, word id V) with the engine's own
    tables, or, with ties=True, integer-valued tables so shifted arcs,
    entries and word ends tie exactly; seeds hold LOG_ZERO runs and every
    fourth window ends at the last frame."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    V = tabs.n_words

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEVICE)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    wids = rint(0, V, K)
    wids[::5] = V
    loc, ent, ext = tabs.loc[wids], tabs.ent[wids], tabs.ext[wids]
    sidx = tabs.sidx[wids]
    if ties:
        loc = rint(-2, 1, *loc.shape).float()
        loc[rnd(*loc.shape) < 0.2] = LOG_ZERO
        ent = rint(-3, 0, *ent.shape).float()
        ent[rnd(*ent.shape) < 0.7] = LOG_ZERO
        ext = rint(-1, 1, *ext.shape).float()
        ext[rnd(*ext.shape) < 0.3] = LOG_ZERO
        out = rint(-4, 3, B, T, R).float()
        seed_w = rint(-60, -20, K, W).float()
    else:
        out = -10.0 * rnd(B, T, R)
        seed_w = -200.0 - 100.0 * rnd(K, W)
    seed_w[rnd(K, W) < 0.6] = LOG_ZERO
    seed_w[:, 5:20] = LOG_ZERO
    t0 = rint(0, T - W + 1, K)
    t0[1::4] = T - W
    return dict(loc=loc.contiguous(), ent=ent.contiguous(),
                ext=ext.contiguous(), sidx=sidx.contiguous(),
                seed=seed_w.contiguous(), out_ext=out,
                bidx=rint(0, B, K).int(), t0=t0.int())


def synthetic_chains(V, N, kl, R, seed):
    """Chain tables of V words of N nodes with arc span kl and random
    log-probabilities (word id V the dead chain), for chain widths the
    flagship's words (at most 21 nodes) do not reach."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    loc = -3.0 * rnd(V + 1, kl + 1, N)
    loc[rnd(V + 1, kl + 1, N) < 0.2] = LOG_ZERO
    ent = -3.0 * rnd(V + 1, N)
    ent[rnd(V + 1, N) < 0.7] = LOG_ZERO
    ext = -3.0 * rnd(V + 1, N)
    for a in (loc, ent, ext):
        a[V] = LOG_ZERO
    sidx = torch.randint(0, R, (V + 1, N), generator=g, device=DEVICE,
                         dtype=torch.int32)
    return types.SimpleNamespace(n_words=V, nmax=N, kl=kl, loc=loc,
                                 ent=ent, ext=ext, sidx=sidx)


def check_no_spills(report: str, source: str) -> None:
    """Raise unless every kernel in an nvcc ptxas report keeps its stack
    frame and spills at 0 bytes."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", report)
    if not frames:
        raise RuntimeError(f"no ptxas report for {source}")
    if any(int(x) for f in frames for x in f):
        raise RuntimeError(f"{source} uses stack or spills: {frames}")


def compare_scan(sk, args):
    """scan_win kernel vs plain on the same arguments -> max |err|."""
    got = sk.scan_core_win(**args)
    want = sk.scan_core_win_plain(**args)
    torch.cuda.synchronize()
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 2))
    if err > 1e-5:
        raise RuntimeError(f"scan_win scores differ from plain by {err}")
    if not torch.equal(got[1], want[1]):
        n_bad = int((got[1] != want[1]).sum())
        raise RuntimeError(f"scan_win entry frames differ at {n_bad} places")
    return err


def scan_bytes(K, W, N, K1):
    """Least bytes one scan must move: the gathered outprob and the seeds
    read once, the chains' tables and window starts read once, g / beg /
    sv written once."""
    return (K * W * N * 4 + K * W * 4 + K * (K1 + 3) * N * 4 + K * 8
            + 3 * K * W * 4)


def scan_ops(K, W, N, K1):
    """f32 operations of one scan: per node a frame K1 arc adds and K1-1
    compares, the entry add and compare, the emission compare and add,
    the word-end compare and add, and one argmax compare."""
    return K * W * N * (2 * K1 + 7)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from julius_tpu_torch.ops import cuda_build
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2 as p2
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.ops.dnn import build_dnn_scorer, dnn_scores
    from julius_tpu_torch.tools.synth import (flagship_engine,
                                              make_flagship_utts)
    from julius_tpu_torch.utils.cuda_timing import time_ms

    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", name=name, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    cuda_build.compile_all([pk.SOURCE, sk.SOURCE])
    pk.build()
    sk.build()
    build_s = time.perf_counter() - t0
    ptxas = {m.SOURCE.name: cuda_build.ptxas_report(m.SOURCE)
             for m in (pk, sk)}
    phase("build", seconds=round(build_s, 3),
          kernels=["pass1_step", "scan_win"], ptxas=ptxas)
    for source, report in ptxas.items():
        check_no_spills(report, source)

    t0 = time.perf_counter()
    eng, protos = flagship_engine(trained=True, device=DEVICE)
    dev = eng.dev_net
    N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]
    R = int(eng._state_sid.shape[0])
    etot = p1.entry_total(dev)
    phase("engine", seconds=round(time.perf_counter() - t0, 3),
          nodes=N, arc_span_k=K1 - 1, senones=R,
          exits=int(dev.exit_nodes.shape[0]), words=eng.voca.n_words,
          trellis_m=eng.p1_cfg.n_atoms)

    # ---- kernel vs plain at the main path's shapes
    max_err = 0.0
    for B in (64, N_UTTS, 1):
        for ties in (True, False):
            args = step_inputs(dev, etot, B, R, seed=B + ties, ties=ties)
            err, _ = compare_step(pk, args)
            max_err = max(max_err, err)
    # a run of frames, each fed the previous frame's output
    args = step_inputs(dev, etot, 64, R, seed=7, ties=False)
    for f in range(6):
        err, out = compare_step(pk, args)
        max_err = max(max_err, err)
        args = dict(args, score=out[0], ctx=out[1], prev=out[2],
                    row=args["row"].roll(f + 1, dims=1),
                    frame_valid=args["frame_valid"].roll(1))
    phase("kernel_check", kernel="pass1_step", max_abs_err=max_err,
          shapes=[[B, N, K1 - 1] for B in (64, N_UTTS, 1)])

    timings = {}
    for B in (64, N_UTTS, 1):
        args = step_inputs(dev, etot, B, R, seed=11, ties=False)
        ms = time_ms(lambda: pk.fused_step(**args))
        plain_ms = time_ms(lambda: pk.fused_step_plain(**args))
        nbytes = step_bytes(B, N, K1, R)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = step_ops(B, N, K1) / F32_OPS_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        timings[B] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by)
        phase("kernel_time", kernel="pass1_step", batch=B, nodes=N,
              ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
              bound_by=bound_by,
              bytes=nbytes, gb_per_s=nbytes / ms / 1e6,
              share_of_hbm=nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
              library_ms=None, card=card)

    # ---- scan_win vs plain: the device A*'s shape, two window buckets of
    # the host re-scan, then the kernel's edges: one frame, a chunk less
    # and more one frame, the whole utterance, and chains of more than 32
    # nodes (the block template) on synthetic tables
    tabs = eng.device_chains
    wide = synthetic_chains(500, 45, 2, R, seed=5)
    T_A, B_A = 509, N_UTTS
    K_A, W_A = B_A * p2d.POPS, p2d.SCAN_WIN
    C = sk.CHUNK
    scan_shapes = [(tabs, K_A, W_A), (tabs, 256, 64), (tabs, 1024, 256),
                   (tabs, K_A, 1), (tabs, K_A, C - 1), (tabs, K_A, C + 1),
                   (tabs, K_A, T_A), (wide, 64, 100)]
    scan_err = 0.0
    for tb, K, W in scan_shapes:
        for ties in (True, False):
            args = scan_inputs(tb, K, W, T_A, R, B_A, K + W + ties, ties)
            scan_err = max(scan_err, compare_scan(sk, args))
    phase("kernel_check", kernel="scan_win", max_abs_err=scan_err,
          shapes=[[K, W, tb.nmax, tb.kl] for tb, K, W in scan_shapes],
          frames=T_A, senones=R)
    scan_t = {}
    for n_shape, (tb, K, W) in enumerate(scan_shapes):
        N_c, K1_c = tb.nmax, tb.kl + 1
        args = scan_inputs(tb, K, W, T_A, R, B_A, 3, False)
        ms = time_ms(lambda: sk.scan_core_win(**args))
        # the plain version at the edges: a few calls are enough
        plain_ms = time_ms(lambda: sk.scan_core_win_plain(**args),
                           n=50 if n_shape < 3 else 10, warm=2)
        nbytes = scan_bytes(K, W, N_c, K1_c)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = scan_ops(K, W, N_c, K1_c) / F32_OPS_PER_S * 1e3
        scan_t[N_c, K, W] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        phase("kernel_time", kernel="scan_win", chains=K, window=W,
              nodes=N_c, arc_span_k=K1_c - 1, **scan_t[N_c, K, W],
              bytes=nbytes, us_per_frame=ms * 1e3 / W, library_ms=None,
              card=card)

    # ---- the full-width slice through the engine's entry point
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, N_UTTS, 120, 11,
        min_words=6, max_words=12, seed=1)
    T = max(lens)
    feats_np = np.zeros((N_UTTS, T, 120 * 11), np.float32)
    for u, w in enumerate(wins):
        feats_np[u, :w.shape[0]] = w
    feats = torch.from_numpy(feats_np).to(DEVICE)
    lens_np = np.asarray(lens, np.int32)

    # DNN scores on the card against the CPU path on a small input
    x = feats[:2, :200]
    on_card = eng._outprob(x).cpu()
    cpu_scorer = build_dnn_scorer(eng.dnn_params, "cpu")
    on_cpu = dnn_scores(cpu_scorer, x.cpu())[..., eng._state_sid.cpu()]
    dnn_err = float((on_card - on_cpu).abs().max())
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean())
    if not (dnn_err <= 2e-2 and agree >= 0.99):
        raise RuntimeError(f"DNN on card vs CPU: max err {dnn_err}, "
                           f"argmax agreement {agree}")

    if not (eng.search_cfg.pass2_rescan and eng._device_astar_ok()):
        raise RuntimeError("flagship_engine does not take the device A*")
    eng.decode_features(feats[:2], lens_np[:2])     # warm-up
    torch.cuda.synchronize()
    pk.LAUNCHES = sk.LAUNCHES = p2r.CHUNKS = 0
    t0 = time.perf_counter()
    res = eng.decode_features(feats, lens_np)
    e2e_s = time.perf_counter() - t0
    launches = pk.LAUNCHES
    scan_launches, chunks = sk.LAUNCHES, p2r.CHUNKS
    stats = dict(p2d.LAST_STATS)
    net = dict(eng.last_pass2)
    if launches != T:
        raise RuntimeError(f"{launches} kernel launches for {T} frames")
    if scan_launches != stats["rounds"] + chunks or scan_launches == 0:
        raise RuntimeError(f"{scan_launches} scan_win launches for "
                           f"{stats['rounds']} A* rounds + {chunks} chunks")

    # the same decode again in its three stages, for where the time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out_ext = eng._outprob(feats)
    torch.cuda.synchronize()
    dnn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_kernel = eng._pass1(out_ext, lens_np)
    torch.cuda.synchronize()
    p1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        staged = eng._results(tr_kernel, lens_np, out_ext=out_ext)
    p2_s = time.perf_counter() - t0
    staged_net = dict(eng.last_pass2)
    if [r.word_ids for r in staged] != [r.word_ids for r in res]:
        raise RuntimeError("staged decode differs from decode_features")
    real = pk.fused_step
    pk.fused_step = pk.fused_step_plain
    try:
        t0 = time.perf_counter()
        tr_plain = eng._pass1(out_ext, lens_np)
        torch.cuda.synchronize()
        p1_plain_s = time.perf_counter() - t0
    finally:
        pk.fused_step = real
    valid = tr_plain.word >= 0
    for f in tr_kernel._fields:
        a, b = getattr(tr_kernel, f), getattr(tr_plain, f)
        if a.shape != (N_UTTS, T, eng.p1_cfg.n_atoms):
            raise RuntimeError(f"trellis {f} has shape {tuple(a.shape)}")
        if a.dtype.is_floating_point:
            if not torch.isfinite(a).all():
                raise RuntimeError(f"trellis {f} is not finite")
            d = float(torch.where(valid, (a - b).abs(), 0.0).max())
            if d > 1e-5:
                raise RuntimeError(f"kernel vs plain trellis {f}: {d}")
        elif not torch.equal(torch.where(valid, a, 0),
                             torch.where(valid, b, 0)):
            raise RuntimeError(f"kernel vs plain trellis {f} differ")
    if not torch.equal(tr_kernel.word, tr_plain.word):
        raise RuntimeError("kernel vs plain trellis words differ")

    # the device A* again on the same lattices and outprobs, kernel path
    # then plain path
    host = p1.Trellis(*[a.cpu().numpy() for a in tr_kernel])
    lats = [p2.TrellisLattice(p1.Trellis(*[a[b] for a in host]), int(n))
            for b, n in enumerate(lens_np)]
    astar_args = (lats, eng.device_chains, eng.ngram_dev, eng._wid2lm,
                  eng._cprob_arr(), out_ext, eng._rescan_strategy(),
                  eng.search_cfg)
    with torch.no_grad():
        t0 = time.perf_counter()
        nb_kernel = p2d.run_batch(*astar_args, best_in=eng._p2d_best_in)
        astar_s = time.perf_counter() - t0
        p2d.scan_core_win = sk.scan_core_win_plain
        try:
            t0 = time.perf_counter()
            nb_plain = p2d.run_batch(*astar_args, best_in=eng._p2d_best_in)
            astar_plain_s = time.perf_counter() - t0
        finally:
            p2d.scan_core_win = sk.scan_core_win
    for a, b in zip(nb_kernel, nb_plain):
        if [r.word_ids for r in a] != [r.word_ids for r in b] or any(
                abs(x.score - y.score) > 1e-4 for x, y in zip(a, b)):
            raise RuntimeError("device A* kernel vs plain scan differ")

    for r in res:
        if not (r.valid and np.isfinite(r.score) and r.words
                and r.words[0] == "<s>" and r.words[-1] == "</s>"):
            raise RuntimeError(f"bad result {r}")
    exact = sum(1 for r, truth in zip(res, truths)
                if [t for t in r.texts if t]
                == [w for w in truth if w not in ("<s>", "</s>")])
    audio_s = float(lens_np.sum()) / 100.0
    phase("slice", utterances=N_UTTS, frames=T, audio_s=audio_s,
          dnn_wall_s=dnn_s, pass1_wall_s=p1_s,
          pass2_and_results_wall_s=p2_s,
          astar_wall_s=staged_net["astar_s"],
          retry_net_wall_s=staged_net["retry_s"],
          assembly_wall_s=p2_s - staged_net["astar_s"]
          - staged_net["retry_s"],
          astar_rerun_wall_s=astar_s, astar_plain_scan_wall_s=astar_plain_s,
          pass1_plain_wall_s=p1_plain_s,
          pass1_kernel_s=launches * timings[N_UTTS]["ms"] * 1e-3,
          e2e_wall_s=e2e_s, xrt=audio_s / e2e_s,
          exact_transcripts=f"{exact}/{N_UTTS}",
          from_pass2=sum(r.from_pass == 2 for r in res),
          retried=net["retried"], astar_rounds=stats["rounds"],
          astar_n_pops=stats["n_pops"], astar_loop_wall_s=stats["wall_loop"],
          max_rounds=stats["max_rounds"], CAPP=stats["CAPP"],
          kernel_launches=launches, scan_win_launches=scan_launches,
          rescan_chunks=chunks, dnn_card_vs_cpu_max_err=dnn_err, card=card)
    if exact < N_UTTS - 1:
        raise RuntimeError(f"only {exact}/{N_UTTS} exact transcripts")

    # ---- the host re-scan (ScanDispatcher at its window buckets)
    side = slice(0, N_SIDE)
    base_cfg = eng.search_cfg
    eng.search_cfg = dataclasses.replace(base_cfg, pass2_device=False)
    sk.LAUNCHES = p2r.CHUNKS = 0
    try:
        t0 = time.perf_counter()
        res_rescan = eng.decode_features(feats[side], lens_np[side])
        rescan_s = time.perf_counter() - t0
    finally:
        eng.search_cfg = base_cfg
    if [r.word_ids for r in res_rescan] != [r.word_ids for r in res[side]]:
        raise RuntimeError("host re-scan and device A* word ids differ")
    if sk.LAUNCHES != p2r.CHUNKS or p2r.CHUNKS == 0:
        raise RuntimeError(f"{sk.LAUNCHES} scan_win launches for "
                           f"{p2r.CHUNKS} re-scan chunks")
    phase("rescan", utterances=N_SIDE, wall_s=rescan_s,
          scan_win_launches=sk.LAUNCHES, chunks=p2r.CHUNKS,
          from_pass2=sum(r.from_pass == 2 for r in res_rescan), card=card)

    # ---- the frozen-score pass 2 of the first slice
    eng.search_cfg = dataclasses.replace(base_cfg, pass2_rescan=False)
    try:
        t0 = time.perf_counter()
        res_frozen = eng.decode_features(feats[side], lens_np[side])
        frozen_s = time.perf_counter() - t0
    finally:
        eng.search_cfg = base_cfg
    for r in res_frozen:
        if not (r.valid and np.isfinite(r.score) and r.words):
            raise RuntimeError(f"bad frozen-search result {r}")
    frozen_exact = sum(1 for r, truth in zip(res_frozen, truths[side])
                       if [t for t in r.texts if t]
                       == [w for w in truth if w not in ("<s>", "</s>")])
    phase("frozen", utterances=N_SIDE, wall_s=frozen_s,
          exact_transcripts=f"{frozen_exact}/{N_SIDE}",
          from_pass2=sum(r.from_pass == 2 for r in res_frozen), card=card)

    t = timings[N_UTTS]
    s = scan_t[tabs.nmax, K_A, W_A]
    print(json.dumps({"kernels": [{
        "name": "pass1_step", "route": "cuda",
        "source": "julius_tpu_torch/csrc/pass1_step.cu",
        "replaces": "julius_tpu/ops/pass1_kernel.py:49",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}, {
        "name": "scan_win", "route": "cuda",
        "source": "julius_tpu_torch/csrc/scan_win.cu",
        "replaces": "julius_tpu/search/scan.py:317",
        "launches": scan_launches, "max_abs_err": scan_err,
        "ms": s["ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
