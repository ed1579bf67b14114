"""Time the pass-2 word-scan kernel (csrc/scan_win.cu) on one NVIDIA
card, optionally against other sources of it, and dump its SASS.

    python3 -m julius_tpu_torch.tools.time_scan_win \\
        [--against OTHER.cu ...] [--sass OUT.txt] [--json OUT.json]

Inputs are made on the card from seeds at the flagship's widths: B = 16
utterances of T = 509 frames, R = 2004 senones, chains of 21 nodes with
arc span 1 (and one shape of 45 nodes with span 2).  Every source is
built with nvcc (all at once) and held to the plain version on every
shape (scores within 1e-5, entry frames equal).  Each shape is then
timed with CUDA events, median of 60 launches, in turns: this source
twice, or with --against (sources with the same C interface, each named
by its file's stem) the others, this, this, the others backwards.  The
slope of this source's time between W = 32 and W = 509 is printed for
one chain, whose gather traffic is negligible (the time of one frame of
the recurrence), and for the A*'s 128 chains.  --sass writes
`cuobjdump -sass` of this source's library; its instruction counts per
kernel are printed as well.  Prints one JSON line per shape, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.ops import scan_kernel as sk
from julius_tpu_torch.utils.cuda_timing import time_ms
from julius_tpu_torch.utils.logadd import LOG_ZERO

B, T, R = 16, 509, 2004
C = sk.CHUNK
#: (K chains, W frames, N nodes, arc span + 1)
SHAPES = [(128, 160, 21, 2), (256, 64, 21, 2), (1024, 256, 21, 2),
          (128, 1, 21, 2), (128, C - 1, 21, 2), (128, C + 1, 21, 2),
          (128, C, 21, 2), (128, T, 21, 2), (64, 100, 45, 3),
          (1, C, 21, 2), (1, T, 21, 2)]


def scan_args(K, W, N, K1, out_ext, seed):
    """One scan's arguments on the card: random tables (every fifth
    chain dead), seeds with LOG_ZERO runs, windows inside the utterance."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    loc = -3.0 * rnd(K, K1, N)
    loc[rnd(K, K1, N) < 0.2] = LOG_ZERO
    ent = -3.0 * rnd(K, N)
    ent[rnd(K, N) < 0.7] = LOG_ZERO
    ext = -3.0 * rnd(K, N)
    for a in (loc, ent, ext):
        a[::5] = LOG_ZERO
    seed_w = -200.0 - 100.0 * rnd(K, W)
    seed_w[rnd(K, W) < 0.6] = LOG_ZERO
    return dict(
        loc=loc, ent=ent, ext=ext,
        sidx=torch.randint(0, R, (K, N), generator=g, device="cuda",
                           dtype=torch.int32),
        seed=seed_w, out_ext=out_ext,
        bidx=torch.randint(0, B, (K,), generator=g, device="cuda",
                           dtype=torch.int32),
        t0=torch.randint(0, T - W + 1, (K,), generator=g, device="cuda",
                         dtype=torch.int32))


def same(got, want) -> float:
    """Max |score difference| of two scans; raises on entry frames."""
    if not torch.equal(got[1], want[1]):
        raise RuntimeError("entry frames differ")
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 2))
    if err > 1e-5:
        raise RuntimeError(f"scores differ by {err}")
    return err


def sass_counts(sass: str) -> dict:
    """Per kernel function of a cuobjdump listing: its instruction count
    and the counts of the opcodes that mark a frame of the recurrence
    (shuffles, shared loads and stores, float adds, selects)."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(
            r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
        if name and m:
            out[name][m.group(1).split(".")[0]] += 1
    keep = ("SHFL", "LDS", "STS", "FADD", "FSETP", "FSEL", "FMNMX", "SEL",
            "BAR", "SYNCS")
    return {f: dict(total=sum(c.values()), **{o: c[o] for o in keep})
            for f, c in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[])
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--json", type=Path)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_scan_win: CUDA is not available", file=sys.stderr)
        return 1
    others = [p.resolve() for p in opt.against]
    cuda_build.compile_all([sk.SOURCE, *others])
    libs = {"this": sk.build()}
    for p in others:
        libs[p.stem] = sk.bind(cuda_build.load(p))
    names = [p.stem for p in others]
    order = names + ["this", "this"] + names[::-1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    g = torch.Generator(device="cuda").manual_seed(0)
    out_ext = -10.0 * torch.rand((B, T, R), generator=g, device="cuda")
    rows, this_ms = [], {}
    try:
        for n_shape, (K, W, N, K1) in enumerate(SHAPES):
            args = scan_args(K, W, N, K1, out_ext, seed=n_shape)
            want = sk.scan_core_win_plain(**args)
            errs, times = {}, collections.defaultdict(list)
            for name, lib in libs.items():
                sk._lib = lib
                errs[name] = same(sk.scan_core_win(**args), want)
            for name in order:
                sk._lib = libs[name]
                times[name].append(time_ms(lambda: sk.scan_core_win(**args)))
            this_ms[K, W, N] = sum(times["this"]) / len(times["this"])
            row = dict(chains=K, window=W, nodes=N, arc_span_k=K1 - 1,
                       max_abs_err=errs, ms=dict(times), card=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        sk._lib = libs["this"]
    tail = {f"us_per_frame_{K}_chains":
            (this_ms[K, T, 21] - this_ms[K, C, 21]) / (T - C) * 1e3
            for K in (1, 128)}
    tail["card"] = card
    if opt.sass:
        lib_path = cuda_build.library_path(sk.SOURCE)
        cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        opt.sass.parent.mkdir(parents=True, exist_ok=True)
        opt.sass.write_text(sass)
        tail["sass"] = sass_counts(sass)
    print(json.dumps(tail), flush=True)
    if opt.json:
        opt.json.parent.mkdir(parents=True, exist_ok=True)
        opt.json.write_text(json.dumps(dict(rows=rows, **tail), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
