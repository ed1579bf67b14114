"""Time pass 1's word-end kernel (csrc/word_end.cu) on one NVIDIA card,
optionally against other sources of it.

    python3 -m julius_tpu_torch.tools.time_word_end \\
        [--against OTHER.cu ...] [--shapes B,N,EX,M ...] [--json OUT.json]
        [--phases]

Inputs are made from seeds at the flagship's widths (74,968 nodes, 5000
exits, M = 32) for B = 64, 16 and 1, and at the 20k-word
configuration's (299,720 nodes, 20,000 exits, M = 128) for B = 32 and
1, or at the --shapes given: integer-valued scores with runs of
LOG_ZERO, 2000 vocabulary words of which 400 are in a hashed 2-gram
with a third of their pairs, and the winner asked for.  Every source is built with nvcc (all at once) and
held bit-equal to the plain version on every shape.  Each shape is then
timed in turns (this source, the others, the others backwards, this
source): (a) the median of 60 launches on the same arguments, (c) the
median of 30 launches each after an L2 flush outside the events; beside
the plain version, `torch.topk` of the same [B, Ex] exit scores (the
first selection alone) and the byte bound as chip_smoke.py counts it.
Another source whose C entry takes no cluster arguments (an earlier,
one-block design) runs one block a row.  --plans C,THREADS times this
source at those cluster plans too, in the same turns.  Prints one JSON
line per shape (with the cluster plan the wrapper picks), then the
card's name and power limit.

--phases first builds the source a second time with -DWORD_END_PHASES
(thread 0 of each block stamps the SM clock and the global timer after
each phase's barrier) and, at each shape, launches it 40 times, each
alone, at the wrapper's cluster plan and at C = 1: a `phases` line a
shape and plan with each phase's median µs (clock cycles at the clock
rate the global timer gives over the whole block), the block's
in-kernel µs, and ptxas's report of both builds.  The
library pass 1 loads never has the define.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import types
from pathlib import Path

import numpy as np
import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.ops import word_end_kernel as we
from julius_tpu_torch.search.ngram_device import (_build_hash,
                                                  device_ngram_from_numpy)
from julius_tpu_torch.utils.cuda_timing import l2_flush, time_ms
from julius_tpu_torch.utils.logadd import LOG_ZERO

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
#: (B, N, Ex, M)
SHAPES = [(64, 74_968, 5000, 32), (16, 74_968, 5000, 32),
          (1, 74_968, 5000, 32), (32, 299_720, 20_000, 128),
          (1, 299_720, 20_000, 128)]
V, N_LM = 2000, 400


def stage_args(B, N, Ex, M, seed):
    """One frame's word-end arguments on the card (as `we.word_end`
    takes them): the exit tables on a SimpleNamespace, the N-gram, the
    config, the [B, N] state and t."""
    rng = np.random.default_rng(seed)
    score = rng.integers(-40, 0, (B, N)).astype(np.float32)
    score[rng.random((B, N)) < 0.5] = LOG_ZERO
    nodes = np.sort(rng.choice(N, Ex, replace=False)).astype(np.int64)
    w = rng.integers(0, V, Ex).astype(np.int32)
    wid2lm = rng.permutation(np.where(np.arange(V) < N_LM, np.arange(V),
                                      -1)).astype(np.int32)
    uni = -3.0 * rng.random(N_LM).astype(np.float32)
    bo = -rng.random(N_LM).astype(np.float32)
    wlm = wid2lm[w]
    pairs = rng.choice(N_LM * N_LM, N_LM * N_LM // 3, replace=False)
    keys, vals = _build_hash(pairs.astype(np.uint32),
                             -4.0 * rng.random(len(pairs)).astype(np.float32))
    rows = np.stack([keys.view(np.int32), vals.view(np.int32)], axis=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    dev = types.SimpleNamespace(
        exit_nodes=t(nodes), exit_nlp=t(-rng.integers(0, 3, Ex).astype(
            np.float32)), exit_w=t(w), exit_wlm=t(wlm),
        exit_uni=t(np.where(wlm >= 0, uni[np.maximum(wlm, 0)], 0.0)
                   .astype(np.float32)),
        exit_transp=t(rng.random(Ex) < 0.05),
        ctx_info=t(np.stack([wid2lm.astype(np.float32), np.where(
            wid2lm >= 0, bo[np.maximum(wid2lm, 0)], 0.0)], 1)
            .astype(np.float32)))
    ngram = device_ngram_from_numpy(uni, bo, rows, N_LM, 0, 1, 2, False,
                                    "cuda")
    return dict(dev=dev, ngram=ngram, cfg=types.SimpleNamespace(
        n_atoms=M, use_lm=True, factoring=1, lm_weight=8.0, lm_penalty=0.0),
        score=t(score), ctx=t(rng.integers(-1, V, (B, N)).astype(np.int32)),
        prev=t(rng.integers(-1, 100_000, (B, N)).astype(np.int32)),
        t=torch.tensor([9], dtype=torch.int32, device="cuda"))


def stage_bytes(B, Ex, M):
    """Least bytes one call moves, as chip_smoke.py `word_end_bytes`
    counts them with narrow 2-gram keys and the winner."""
    k = min(2 * M, Ex)
    return (B * Ex * 4 + Ex * 12 + B * k * (8 + 13 + 8 + 64) + B * M * 24
            + B * 12 + 4)


def launcher(lib, plan=None):
    """word_end through library `lib`, with cluster plan `plan` (C,
    threads) for every shape if given."""
    def run(args):
        real, real_plan, we._lib = we._lib, we.cluster_plan, lib
        if plan is not None:
            we.cluster_plan = lambda B, Ex: plan
        try:
            return we.word_end(**args)
        finally:
            we._lib, we.cluster_plan = real, real_plan
    return run


class OneBlockLib:
    """A library of an earlier source of the kernel, whose C entry takes
    no cluster arguments (one block a row), behind the present
    interface: launches with C = 1 only."""

    def __init__(self, lib):
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        lib.word_end_launch.argtypes = [
            vp, vp, vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32,
            i32, i32, i32, i32, f32, f32, i32, vp, vp, vp, vp, vp, vp, vp,
            vp, vp, vp, vp, vp]
        lib.word_end_launch.restype = i32
        self.lib = lib

    def word_end_launch(self, *args):
        C, threads = args[22:24]
        if (C, threads) != (1, 1024):
            raise ValueError("a one-block source takes C = 1 only")
        return self.lib.word_end_launch(*args[:22], *args[24:])

    def word_end_max_clusters(self, C, threads, smem):
        return we.SMS            # one block a row always fits


def other_launcher(src: Path):
    """word_end through another source's library: its own cluster plan
    where its C entry takes one, else one block a row."""
    lib = cuda_build.load(src.resolve())
    if hasattr(lib, "word_end_max_clusters"):
        return launcher(we.bind(lib))
    return launcher(OneBlockLib(lib), (1, 1024))


def flat(out):
    return [*out[0], *(out[1] or ())]


def bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def measure(runs, shapes=SHAPES):
    """Check and time each of `runs` ({name: fn(args) -> outputs}) at
    each shape, in turns -> one dict a shape (also printed)."""
    names = list(runs)
    flush = l2_flush("cuda")
    card = card_line()
    lines = []
    for B, N, Ex, M in shapes:
        args = stage_args(B, N, Ex, M, seed=B + Ex)
        want = flat(we.word_end_plain(**args))
        for name, run in runs.items():
            if not all(bits_equal(x, y) for x, y in zip(flat(run(args)),
                                                       want)):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at B={B}, Ex={Ex}, M={M}")
        times = {name: {"a": [], "c": []} for name in runs}
        for name in names + names[::-1]:
            run = runs[name]
            times[name]["a"].append(time_ms(lambda: run(args)))
            times[name]["c"].append(time_ms(lambda: run(args), n=30,
                                            before=flush))
        sc_all = args["score"][:, args["dev"].exit_nodes] \
            + args["dev"].exit_nlp
        line = dict(
            batch=B, nodes=N, exits=Ex, atoms=M,
            plan=list(we.cluster_plan(B, Ex)),
            plain_ms=time_ms(lambda: we.word_end_plain(**args), n=20,
                             warm=2),
            topk_ms=time_ms(lambda: torch.topk(sc_all, min(2 * M, Ex))),
            bound_ms=stage_bytes(B, Ex, M) / HBM_BYTES_PER_S * 1e3,
            card=card)
        for name, t in times.items():
            line[name] = {f"{w}_ms": v for w, v in t.items()}
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(card)
    return lines


PHASES_FLAG = "-DWORD_END_PHASES"


def phase_lib():
    """The phase-stamp build of the kernel, bound."""
    lib = we.bind(cuda_build.load(we.SOURCE, [PHASES_FLAG]))
    lib.word_end_phase_names.restype = ctypes.c_char_p
    lib.word_end_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.word_end_phase_stamps.restype = ctypes.c_int
    return lib


def phase_split(lib, args, n=40, plan=None) -> dict:
    """Each phase's median µs of word_end(**args) through the
    phase-stamp library `lib`, at `plan` (C, threads) or the wrapper's:
    per launch (each alone, after a few to warm up), each row's rank-0
    block's phases (it waits for its whole cluster) in clock cycles,
    converted at that block's cycles per global-timer ns over its whole
    run; the median over the rows, then over the launches.  A phase a
    block did not stamp (zero) is left out for it.  -> {"plan", "us"
    (name -> µs), "in_kernel_us", "launches"}."""
    names = lib.word_end_phase_names().decode().split(",")
    P = len(names) + 1
    run = launcher(lib, plan)
    B, Ex = args["score"].shape[0], args["dev"].exit_nodes.shape[0]
    C, threads = plan or we.cluster_plan(B, Ex)
    buf = np.zeros((B * C, P, 2), np.uint64)
    for _ in range(3):
        run(args)
    torch.cuda.synchronize()
    per = {name: [] for name in names}
    total = []
    for _ in range(n):
        lib.word_end_phase_stamps(None, 0)
        run(args)
        torch.cuda.synchronize()
        rc = lib.word_end_phase_stamps(buf.ctypes.data, B * C)
        if rc != 0:
            raise RuntimeError(f"word_end_phase_stamps: CUDA error {rc}")
        clk = buf[::C, :, 0].astype(np.int64)
        ns = buf[::C, :, 1].astype(np.int64)
        live = (clk[:, 0] > 0) & (clk[:, -1] > 0)
        rate = (ns[live, -1] - ns[live, 0]) / np.maximum(
            clk[live, -1] - clk[live, 0], 1)
        total.append(float(np.median(ns[live, -1] - ns[live, 0])) / 1e3)
        for p, name in enumerate(names):
            ok = (clk[live, p] > 0) & (clk[live, p + 1] > 0)
            d = (clk[live, p + 1] - clk[live, p]) * rate
            if ok.any():
                per[name].append(float(np.median(d[ok])) / 1e3)
    return dict(plan=[C, threads],
                us={k: statistics.median(v) if v else None
                    for k, v in per.items()},
                in_kernel_us=statistics.median(total), launches=n)


def phase_times(lib, shapes, n=40, plan=None):
    """`phase_split` at each shape (one `phases` line a shape)."""
    card = card_line()
    lines = []
    for B, N, Ex, M in shapes:
        split = phase_split(lib, stage_args(B, N, Ex, M, seed=B + Ex), n,
                            plan)
        line = dict(phases=dict(batch=B, nodes=N, exits=Ex, atoms=M,
                                **split, card=card))
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,N,EX,M each (default: SHAPES)")
    ap.add_argument("--json", type=Path)
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase from a stamped build")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="C,THREADS each: also time these cluster plans")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_word_end: needs a CUDA card")
    jobs = [we.SOURCE, *opts.against]
    if opts.phases:
        jobs.append((we.SOURCE, (PHASES_FLAG,)))
    cuda_build.compile_all(jobs)
    shapes = SHAPES if opts.shapes is None else [
        tuple(int(x) for x in sh.split(",")) for sh in opts.shapes]
    lines = []
    if opts.phases:
        for extra in ((), (PHASES_FLAG,)):
            print(json.dumps(dict(ptxas=" ".join(extra) or "plain",
                                  report=cuda_build.ptxas_report(
                                      we.SOURCE, extra))), flush=True)
        lib = phase_lib()
        lines += phase_times(lib, shapes)
        lines += phase_times(lib, shapes, plan=(1, 1024))
    runs = {"this": launcher(we.build())}
    for plan in opts.plans:
        C, threads = (int(x) for x in plan.split(","))
        runs[f"C{C}x{threads}"] = launcher(we.build(), (C, threads))
    for src in opts.against:
        runs[str(src)] = other_launcher(src)
    lines += measure(runs, shapes)
    if opts.json:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
