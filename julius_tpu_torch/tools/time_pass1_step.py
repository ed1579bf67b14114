"""Time the pass-1 beam-update kernel (csrc/pass1_step.cu) on one NVIDIA
card, optionally against other sources of it.

    python3 -m julius_tpu_torch.tools.time_pass1_step \\
        [--against OTHER.cu ...] [--json OUT.json]

Inputs are made on the card from seeds at the flagship's widths (arc
span 1, R = 2004 senones) for B = 64, 32, 16, 4, 2 and 1 at N = 74,968
nodes (the network's 74,967 padded to a multiple of 4, as pass1_batch
gives them to the kernel) and for B = 64 at 74,967 too, and at the
20k-word configuration's (B = 32, N = 299,720 and 299,718, R = 11,166,
the frame row a view of a [B, 3, R] outprob cache, stride 3R).
Every source is built with nvcc (all at once) and held to the plain
version on every shape (scores bit-equal, ctx and prev equal).  Each
shape is then timed three ways, in turns (this source, the others, the
others backwards, this source): (a) the median of 60 launches on the
same arguments, (b) a chain of 60 launches each fed the previous
outputs, one event pair around it, (c) the median of 30 launches each
after an L2 flush outside the events; beside the bytes bound and the
share of it that (c) reaches.  The library's empty kernel is timed as
(a), the floor of one launch.  Other sources take the same leading
arguments of `pass1_step_launch`; the trailing launch-plan arguments
are passed to every source, and a source that does not read them (the
first design, one thread a (b, n)) ignores them.  Prints one JSON line
per shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.ops import pass1_kernel as pk
from julius_tpu_torch.utils.cuda_timing import chain_ms, l2_flush, time_ms
from julius_tpu_torch.utils.logadd import LOG_ZERO

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
#: (B, N, R, frame row a strided view of a [B, 3, R] cache)
SHAPES = [(B, 74_968, 2004, False) for B in (64, 32, 16, 4, 2, 1)] + [
    (64, 74_967, 2004, False), (32, 299_720, 11_166, True),
    (32, 299_718, 11_166, True)]
K1 = 2


def step_args(B, N, R, strided, seed):
    """One frame's arguments on the card: random state with LOG_ZERO
    nodes, random arc and entry tables, every seventh row frozen."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    score = -100.0 - 50.0 * rnd(B, N)
    score[rnd(B, N) < 0.2] = LOG_ZERO
    loc = -3.0 * rnd(K1, N)
    loc[rnd(K1, N) < 0.3] = LOG_ZERO
    et = -3.0 * rnd(N)
    et[rnd(N) < 0.7] = LOG_ZERO
    cache = -10.0 * rnd(B, 3 if strided else 1, R)
    fv = torch.ones(B, dtype=torch.bool, device="cuda")
    fv[1::7] = False
    return dict(score=score, ctx=rint(-1, 5000, B, N),
                prev=rint(-1, 100000, B, N), loc_lp=loc, entry_total=et,
                row=cache[:, 1] if strided else cache[:, 0],
                score_idx=rint(0, R, N), ent_s=-100.0 - 20.0 * rnd(B),
                ectx_s=rint(-1, 5000, B), eprev_s=rint(-1, 100000, B),
                frame_valid=fv)


def step_bytes(B, N, R):
    """Least bytes one frame moves: state read and written once, the
    tables and the frame row read once (as chip_smoke.py counts them)."""
    return 2 * B * N * 12 + K1 * N * 4 + N * 8 + B * R * 4 + B * 13


def launcher(lib):
    """fused_step through library `lib`."""
    def run(args):
        real, pk._lib = pk._lib, lib
        try:
            return pk.fused_step(**args)
        finally:
            pk._lib = real
    return run


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
    floor_ms = time_ms(pk.empty_launch)
    card = card_line()
    lines = []
    for B, N, R, strided in shapes:
        args = step_args(B, N, R, strided, seed=B + N)
        want = pk.fused_step_plain(**args)
        for name, run in runs.items():
            got = run(args)
            err = float((got[0] - want[0]).abs().max())
            if not (err == 0.0 and torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at B={B}, N={N}: score error {err}")
        del want, got
        times = {name: {"a": [], "b": [], "c": []} for name in runs}
        for name in names + names[::-1]:
            run = runs[name]
            times[name]["a"].append(time_ms(lambda: run(args)))
            times[name]["b"].append(chain_ms(
                lambda s: run(dict(args, score=s[0], ctx=s[1], prev=s[2])),
                (args["score"], args["ctx"], args["prev"])))
            times[name]["c"].append(time_ms(lambda: run(args), n=30,
                                            before=flush))
        bound_ms = step_bytes(B, N, R) / HBM_BYTES_PER_S * 1e3
        line = dict(batch=B, nodes=N, columns=R,
                    row_stride=args["row"].stride(0), bound_ms=bound_ms,
                    launch_floor_ms=floor_ms,
                    plan=pk._plan(torch.device("cuda", 0), B, N, K1)._asdict(),
                    card=card)
        for name, t in times.items():
            line[name] = {f"{w}_ms": v for w, v in t.items()}
            line[name]["cold_share_of_bound"] = [bound_ms / v
                                                 for v in t["c"]]
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(card)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--json", type=Path)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pass1_step: needs a CUDA card")
    cuda_build.compile_all([pk.SOURCE, *opts.against])
    runs = {"this": launcher(pk.build())}
    for src in opts.against:
        runs[str(src)] = launcher(pk.bind(cuda_build.load(src.resolve())))
    lines = measure(runs)
    if opts.json:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
