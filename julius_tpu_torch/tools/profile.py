"""Stage-level profiler for the decode pipeline.

Port of `julius_tpu/tools/profile.py`.  Reference observability is jlog
timing prints (SURVEY.md §5.1); here each pipeline stage is timed on the
engine's device (one warm-up call first, the card synchronised around
each timed run) and an optional profiler trace of CPU and CUDA activity
is written in the Chrome trace format (`torch.profiler`).

    python -m julius_tpu_torch.tools.profile [--trace DIR] [--batch N]

The flagship engine runs on the card (`main(argv, device="cpu")` on the
CPU).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stages(engine, wave: np.ndarray, lengths: np.ndarray,
                   n_iter: int = 3) -> dict:
    """Per-stage steady-state timings (seconds per batch)."""
    dev = engine.device
    wave_t = torch.as_tensor(np.asarray(wave), dtype=torch.float32,
                             device=dev)
    len_t = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                            device=dev)
    out = {}

    def timeit(name, fn, *args):
        r = fn(*args)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            r = fn(*args)
        _sync(dev)
        out[name] = (time.perf_counter() - t0) / n_iter
        return r

    with torch.no_grad():
        feats, mask = timeit("features", engine._features, wave_t, len_t)
        out_ext = timeit("outprob", engine._outprob, feats)
        nfr = mask.to(torch.int32).sum(dim=-1)
        trellis = timeit("pass1", engine._pass1, out_ext, nfr)
        t0 = time.perf_counter()
        engine._results(trellis, nfr.cpu().numpy())
        out["pass2+host"] = time.perf_counter() - t0
    out["total"] = sum(out.values())
    audio_s = float(np.sum(lengths)) / engine.fe_cfg.sample_rate
    out["xRT"] = audio_s / out["total"]
    return out


def trace_stages(engine, wave, lengths, trace_dir: str) -> dict:
    """profile_stages (one iteration) under torch.profiler with CPU and,
    on the card, CUDA activities; the trace goes to
    trace_dir/TRACE_FILE."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        stats = profile_stages(engine, wave, lengths, n_iter=1)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return stats


def main(argv=None, device="cuda"):
    from julius_tpu_torch.tools.synth import flagship_engine

    argv = argv if argv is not None else sys.argv[1:]
    trace_dir = None
    batch = 32
    i = 0
    while i < len(argv):
        if argv[i] == "--trace":
            trace_dir = argv[i + 1]
            i += 2
        elif argv[i] == "--batch":
            batch = int(argv[i + 1])
            i += 2
        else:
            i += 1

    eng = flagship_engine(n_words=5000, n_phones=668,
                          hidden=2048, n_layers=5, device=device)
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((batch, 160000)) * 2000).astype(np.float32)
    lengths = np.full(batch, 160000, dtype=np.int32)

    if trace_dir:
        stats = trace_stages(eng, wave, lengths, trace_dir)
        print(f"chrome trace written to "
              f"{os.path.join(trace_dir, TRACE_FILE)} "
              "(view with Perfetto or chrome://tracing)")
    else:
        stats = profile_stages(eng, wave, lengths)
    for k, v in stats.items():
        if k == "xRT":
            print(f"{k:12s} {v:10.1f}x")
        else:
            print(f"{k:12s} {v * 1000:10.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
