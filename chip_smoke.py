#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, in order (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from this checkout;
  3. kernel: each kernel against its plain PyTorch version on the card at
     the flagship shapes (scores within atol 1e-5, integers equal), then
     timed with CUDA events (median of 60 launches after warm-up) beside
     the plain version and the memory-traffic bound;
  4. slice: the full-width flagship engine (5000-word 2-gram, 2004
     senones, 5 x 2048 sigmoid DNN) decodes 16 generative utterances
     through Engine.decode_features on the card; the kernel launch
     counts are read around that run, and the kernel-path trellis is
     held against the plain-path trellis for the same outprobs;
  5. the kernels' JSON line, the card line, and the result line last.

Weights and utterances are made from fixed seeds; nothing is read from
outside the repository.  Exits non-zero without a result where CUDA is
not available.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
N_UTTS = 16
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


def time_ms(fn, n=60, warm=5):
    """Median device time of one fn() call.  A sleep kernel is queued
    first so the host enqueues every call before the card reaches them:
    the events then bracket device work only, not host gaps."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    evs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.ops.dnn import build_dnn_scorer, dnn_scores
    from julius_tpu_torch.tools.synth import (flagship_engine,
                                              make_flagship_utts)

    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", name=name, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    pk.build()
    build_s = time.perf_counter() - t0
    logs = sorted(pk.BUILD_DIR.glob("*.log"))
    phase("build", seconds=round(build_s, 3), kernels=["pass1_step"],
          ptxas=logs[-1].read_text().strip() if logs else "")

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

    eng.decode_features(feats[:2], lens_np[:2])     # warm-up
    torch.cuda.synchronize()
    pk.LAUNCHES = 0
    t0 = time.perf_counter()
    res = eng.decode_features(feats, lens_np)
    e2e_s = time.perf_counter() - t0
    launches = pk.LAUNCHES
    if launches != T:
        raise RuntimeError(f"{launches} kernel launches for {T} frames")

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
    staged = eng._results(tr_kernel, lens_np)
    p2_s = time.perf_counter() - t0
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
          pass2_and_results_wall_s=p2_s, pass1_plain_wall_s=p1_plain_s,
          pass1_kernel_s=launches * timings[N_UTTS]["ms"] * 1e-3,
          e2e_wall_s=e2e_s, xrt=audio_s / e2e_s,
          exact_transcripts=f"{exact}/{N_UTTS}",
          from_pass2=sum(r.from_pass == 2 for r in res),
          kernel_launches=launches, dnn_card_vs_cpu_max_err=dnn_err,
          card=card)

    t = timings[N_UTTS]
    print(json.dumps({"kernels": [{
        "name": "pass1_step", "route": "cuda",
        "source": "julius_tpu_torch/csrc/pass1_step.cu",
        "replaces": "julius_tpu/ops/pass1_kernel.py:49",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
