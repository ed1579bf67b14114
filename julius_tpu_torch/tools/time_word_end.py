"""Time pass 1's word-end kernel (csrc/word_end.cu) on one NVIDIA card,
optionally against other sources of it.

    python3 -m julius_tpu_torch.tools.time_word_end \\
        [--against OTHER.cu ...] [--shapes B,N,EX,M ...] [--json OUT.json]

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
Other sources take the same C interface.  Prints one JSON line per
shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
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


def launcher(lib):
    """word_end through library `lib`."""
    def run(args):
        real, we._lib = we._lib, lib
        try:
            return we.word_end(**args)
        finally:
            we._lib = real
    return run


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,N,EX,M each (default: SHAPES)")
    ap.add_argument("--json", type=Path)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_word_end: needs a CUDA card")
    cuda_build.compile_all([we.SOURCE, *opts.against])
    runs = {"this": launcher(we.build())}
    for src in opts.against:
        runs[str(src)] = launcher(we.bind(cuda_build.load(src.resolve())))
    shapes = SHAPES if opts.shapes is None else [
        tuple(int(x) for x in sh.split(",")) for sh in opts.shapes]
    lines = measure(runs, shapes)
    if opts.json:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
