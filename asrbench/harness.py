"""One run of one cell: build, warm up, measure, judge, report.

Everything that belongs to one configuration, traffic mix, metric or
cell is a file found by name:

* `asrbench/configs/<config>.json` (the sizes, as `BENCHMARK.json`
  names it) and `asrbench/configs/<config>.py` (`build(cfg, seed)`, the
  model inputs);
* `asrbench/traffic/<traffic>.json`: batch size, the multiset of
  utterance word counts, how closely sentences follow the 2-gram, pass
  2 on or off, how many batches to make and how many of them to judge;
* `asrbench/metrics/<metric>.py` (`read(run)`, a number or None); a
  metric named `<base>.<suffix>` is read by `<base>.py`;
* `asrbench/limits/<workload>.json`: the limit of each number that
  decides `correct`.

The loop is closed: the next batch goes in when the last one's results
are back, as a user decoding a file list waits.  Every batch is fresh,
made from the seed before the window, padded to its longest utterance.
Making that pool is the benchmark's work, not the program's: `setup_s`
leaves it out, and the log line gives its seconds, its size and the
share of it each window decoded.
A traced run measures two windows over the same pool: first the
untraced window a `--trace 0` run measures (judged, and the whole
decode's share of the peak read from it), then the profiled window
with synchronised spans that the per-layer metrics read, as long as the
traffic's `trace_seconds` where it gives one (reading a profile takes
several times its window).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from asrbench import counts, synth
from asrbench.trace import Spans, device_activity

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FRAME_S = 0.01          # 10 ms frames
FORBIDDEN = ("jax", "jaxlib", "flax", "julius_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "asrbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The module that reads metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Batch:
    feats: np.ndarray            # [B, T, D] padded to the longest
    nfr: np.ndarray              # [B] frame counts
    truths: List[List[int]]


@dataclass
class Run:
    """What a metric's reader sees of one run."""

    setup_s: float = 0.0
    window_s: float = 0.0
    audio_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    host_s: Dict[str, float] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    busy_s: float = 0.0
    trace_window_s: float = 0.0
    capture_s: float = 0.0
    least_s: Dict[str, float] = field(default_factory=dict)
    # the untraced window's wall and least times (in a traced run, those
    # of the window before the profiled one)
    plain_window_s: float = 0.0
    plain_least_s: Dict[str, float] = field(default_factory=dict)

    def ms_per_audio_s(self, seconds: float) -> Optional[float]:
        return 1e3 * seconds / self.audio_s if self.audio_s > 0 else None


def block_layout(counts: np.ndarray, B: int) -> np.ndarray:
    """[batches, B] word counts of one block of the pool, the same in
    every run: the traffic's multiset repeated at least twice and to a
    whole number of batches, grouped into batches by a fixed draw."""
    n = len(counts)
    U = n * B // math.gcd(n, B)
    U *= -(-2 * n // U)
    layout = np.resize(counts, U)
    np.random.default_rng(0).shuffle(layout)
    return layout.reshape(U // B, B)


def make_batches(model, traffic: dict, seed: int):
    """(warm-up batches, the window's pool of batches, sampled batch
    indices).  The pool is blocks of `block_layout`'s batches, the seed
    ordering the batches of each block and the utterances of each batch
    and drawing the sentences, so that every seed sends the same sizes;
    the longest utterance of the pool is put into the first sampled
    batch.  Blocks and sentences are drawn in order, so a larger pool
    starts with a smaller one's batches (but for that swap), and the
    sampled indices, drawn from a generator of their own, depend on the
    seed alone."""
    B = int(traffic["batch"])
    nb = int(traffic["pool_batches"])
    rng = np.random.default_rng(seed)
    counts_ = np.asarray(traffic["word_counts"], np.int64)
    layout = block_layout(counts_, B)
    rows: List[np.ndarray] = []
    while len(rows) < nb:
        rows.extend(rng.permutation(layout[j])
                    for j in rng.permutation(len(layout)))
    wc = np.concatenate(rows[:nb])
    n = len(wc)
    truths, wins = synth.make_utterances(model, wc.tolist(), seed,
                                         float(traffic["follow_p"]))
    ctx = model.context
    sampled = sorted(np.random.default_rng([seed, 1]).choice(
        int(traffic["check_within"]), int(traffic["check_batches"]),
        replace=False).tolist())
    longest = int(np.argmax([w.shape[0] for w in wins]))
    first = sampled[0] * B
    truths[first], truths[longest] = truths[longest], truths[first]
    wins[first], wins[longest] = wins[longest], wins[first]
    pool = [_pad(wins[i:i + B], truths[i:i + B], ctx)
            for i in range(0, n, B)]
    # warm-up: for each frame capacity (power of two) the pool's batches
    # use, a batch of fresh whole utterances (the longest that fit) padded
    # to the pool's longest batch of that capacity
    wt, ww = synth.make_utterances(
        model, np.resize(counts_, max(len(counts_), 2 * B)).tolist(),
        seed + 1, float(traffic["follow_p"]))
    by_len = np.argsort([w.shape[0] for w in ww], kind="stable")[::-1]
    caps = {}
    for b in pool:
        T = b.feats.shape[1]
        cap = max(16, 1 << (T - 1).bit_length())
        caps[cap] = max(caps.get(cap, 0), T)
    warm = []
    for T in sorted(caps.values()):
        fit = [int(i) for i in by_len if ww[i].shape[0] <= T] or \
            [int(by_len[-1])]
        pick = (fit * B)[:B]
        warm.append(_pad([ww[i] for i in pick], [wt[i] for i in pick], ctx,
                         T))
    return warm, pool, sampled


def _pad(frames, truths, context, T=None) -> Batch:
    """A batch of utterances' spliced frames, zero-padded to the longest,
    or cut or padded to T frames where T is given."""
    T = T or max(w.shape[0] for w in frames)
    feats = np.zeros((len(frames), T, frames[0].shape[1] * context),
                     np.float32)
    for i, w in enumerate(frames):
        n = min(T, w.shape[0])
        synth.splice_into(feats[i, :n], w[:n], context)
    nfr = np.asarray([min(T, w.shape[0]) for w in frames], np.int64)
    return Batch(feats, nfr, [list(t) for t in truths])


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None, patch=None, out=sys.stdout,
             err=sys.stderr) -> dict:
    """Run one cell once and print its result line; returns the line.
    `config` and `traffic` replace the cell's files, and
    `patch(engine)` runs on the engine before the warm-up: the control
    and the fault tests put something else in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = config or load_json(ROOT / entry["file"])
    traffic = traffic or load_json(HERE / "traffic"
                                   / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    builder = load_module(HERE / "configs" / f"{cell['config']}.py")
    two_pass = bool(traffic["pass2"])
    cuda = torch.device(device).type == "cuda"

    # -- set-up: model, program, traffic (not in setup_s), warm-up -----
    phases = {"imports": time.perf_counter() - t_start}
    model = builder.build(config, seed)
    phases["model"] = time.perf_counter() - t_start
    from asrbench.program import build_engine
    eng = build_engine(model, device, enable_pass2=two_pass)
    phases["engine"] = time.perf_counter() - t_start
    warm, pool, sampled = make_batches(model, traffic, seed)
    phases["traffic"] = time.perf_counter() - t_start
    traffic_s = phases["traffic"] - phases["engine"]
    if patch is not None:
        patch(eng)
    spans = Spans(eng, traced=False)
    with torch.no_grad():
        for b in warm:
            eng.decode_features(b.feats, b.nfr)
    if cuda:
        torch.cuda.synchronize()
    phases["warm-up"] = time.perf_counter() - t_start

    def capture_s():
        # pass 1's graphs, and the A*'s once its chain tables exist
        caches = (eng.dev_net.graphs,
                  getattr(eng._device_chains, "graphs", None))
        return sum(c.capture_s for c in caches if c is not None)

    # -- the windows -------------------------------------------------
    from julius_tpu_torch.search import pass2_device as p2d

    def window(traced: bool, keep_sample: bool, length: float) -> dict:
        """Decode fresh batches from the pool's start for `length`
        seconds."""
        w = dict(kept={}, astar=[], shapes=[], latencies=[], attempted=0,
                 failed=0, retried=0, retry_s=0.0, audio_s=0.0)
        spans.traced = traced
        spans.keep["astar"] = lambda _: w["astar"].append(
            dict(p2d.LAST_STATS))
        cap0 = capture_s()
        t0 = time.perf_counter()
        deadline = t0 + length
        i = 0
        with torch.no_grad():
            while time.perf_counter() < deadline:
                if i == len(pool):
                    raise RuntimeError(
                        f"{workload}: the pool of {len(pool)} batches ran "
                        "out inside the window; raise pool_batches")
                b = pool[i]
                keep = keep_sample and i in sampled
                if keep:
                    k = w["kept"][i] = {}
                    spans.keep["dnn"] = lambda o, k=k: k.__setitem__(
                        "prog", o[..., :model.n_states])
                    spans.keep["pass1"] = lambda o, k=k: k.__setitem__(
                        "trellis", o)
                ts = time.perf_counter()
                res = eng.decode_features(b.feats, b.nfr)
                w["latencies"].append(time.perf_counter() - ts)
                if two_pass:
                    w["retried"] += eng.last_pass2["retried"]
                    w["retry_s"] += eng.last_pass2["retry_s"]
                spans.keep["dnn"] = spans.keep["pass1"] = None
                if keep:
                    w["kept"][i]["results"] = [dict(
                        word_ids=list(r.word_ids), score=float(r.score),
                        am_score=float(r.am_score),
                        lm_score=float(r.lm_score),
                        from_pass=int(r.from_pass), valid=bool(r.valid))
                        for r in res]
                w["attempted"] += len(res)
                w["failed"] += sum(1 for r in res
                                   if not (r.valid and r.word_ids))
                w["audio_s"] += float(b.nfr.sum()) * FRAME_S
                w["shapes"].append((b.feats.shape[1], b.nfr.tolist()))
                i += 1
        w["window_s"] = time.perf_counter() - t0
        w["capture_s"] = capture_s() - cap0
        w["done"] = i
        if cuda:
            torch.cuda.synchronize()
        spans.keep["astar"] = None
        return w

    run = Run()
    run.setup_s = time.perf_counter() - t_start - traffic_s
    plain = window(False, True, seconds)
    phases["window"] = time.perf_counter() - t_start
    measured = plain
    activity = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        spans.host_s.clear()
        prof.start()
        measured = window(True, False, float(traffic.get("trace_seconds",
                                                         seconds)))
        t_read = time.perf_counter()
        prof.stop()
        phases["trace stop"] = time.perf_counter() - t_read
        activity = device_activity(prof)
        phases["trace read"] = time.perf_counter() - t_read
        run.busy_s, run.trace_window_s = (activity["busy_s"],
                                          activity["window_s"])
        run.device_s = activity["span_device_s"]
        del prof
    run.window_s, run.audio_s = measured["window_s"], measured["audio_s"]
    run.latencies_s = measured["latencies"]
    run.capture_s = measured["capture_s"]
    attempted, failed = measured["attempted"], measured["failed"]
    retried, retry_s, done = (measured["retried"], measured["retry_s"],
                              measured["done"])
    # printed only: the pool's size and the share of it each window used
    pool_gb = sum(b.feats.nbytes + b.nfr.nbytes for b in pool) / 1e9
    shares = ", ".join(f"{w['done']} ({w['done'] / len(pool):.1%})"
                       for w in ((plain, measured) if trace else (plain,)))
    kept = plain.pop("kept")
    run.host_s = dict(spans.host_s)
    spans.close()
    peak = torch.cuda.max_memory_allocated(eng.device) if cuda else 0
    kind = torch.cuda.get_device_name(eng.device) if cuda else "cpu"

    # -- free the program, then judge with the plain reference ---------
    samples = []
    # a sampled batch the window never reached, or a result short of its
    # batch, counts as missing
    absent = len(sampled) * int(traffic["batch"]) - sum(
        len(k.get("results", ())) for k in kept.values())
    for bi in sorted(kept):
        k = kept[bi]
        if "results" not in k:
            continue
        b = pool[bi]
        for u, r in enumerate(k["results"]):
            if u >= len(b.nfr) or "prog" not in k or u >= k["prog"].shape[0] \
                    or u >= k["trellis"].word.shape[0]:
                absent += 1         # no outprobs or trellis of its own
                continue
            n = int(b.nfr[u])
            samples.append(dict(
                feats=b.feats[u, :n],
                prog=k["prog"][u, :n].float().cpu().numpy(),
                trellis={f: getattr(k["trellis"], f)[u, :n].cpu().numpy()
                         for f in k["trellis"]._fields},
                result=r, truth=b.truths[u]))
    chains = None
    if plain["astar"] or measured["astar"]:
        chains = (eng.device_chains.nmax, eng.device_chains.kl + 1)
    del eng, spans, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from asrbench.reference.judge import judge
    from asrbench.reference.lexicon import Lexicon
    t_ref = time.perf_counter()
    lex = Lexicon(model)
    phases["lexicon"] = time.perf_counter() - t_ref
    nums, info = judge(model, samples, two_pass, device, lex=lex)
    phases["reference"] = time.perf_counter() - t_ref
    nums["missing"] += max(0, absent)
    exact = sum(1 for s in samples
                if s["result"]["word_ids"] == s["truth"])
    run.least_s = least_times(model, config, lex, measured["shapes"],
                              measured["astar"], chains)
    run.plain_window_s = plain["window_s"]
    run.plain_least_s = least_times(model, config, lex, plain["shapes"],
                                    plain["astar"], chains)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=err)
        raise SystemExit(3)

    # -- the result line -------------------------------------------------
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in nums.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device_info}
    if activity is not None:
        device_info["busy_s"] = run.busy_s
        device_info["window_s"] = run.trace_window_s
        line["breakdown"] = {"device_ops": activity["device_ops"],
                             "idle_gaps": activity["idle_gaps"]}
    line["checks"] = checks
    print(f"# {workload} seed {seed}: {done} batches, {attempted} "
          f"utterances, {run.audio_s:.2f} s of audio in {run.window_s:.3f} "
          f"s; exact transcripts {exact} of {len(samples)} judged; "
          f"set-up {run.setup_s:.3f} s, ends of its phases {phases} "
          f"(the trace's reading, the lexicon and the whole reference after the "
          f"window in seconds); traffic {traffic_s:.3f} s, not in set-up: a "
          f"pool of {len(pool)} batches, {pool_gb:.2f} GB on the host, "
          f"warmed up at {[b.feats.shape[1] for b in warm]} frames, of "
          f"which the {'untraced and traced windows' if trace else 'window'} "
          f"decoded {shares}; "
          f"call seconds (quartiles, max) "
          f"{np.percentile(run.latencies_s, [25, 50, 75, 100]).tolist()}; "
          f"host spans {run.host_s}; retry net re-ran {retried} "
          f"utterances in {retry_s:.3f} s; not compared: {info}", file=out)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return line


def least_times(model, config, lex, shapes, astar_stats, chains):
    """The least seconds of the window's work by piece, from shapes and
    counts (asrbench/counts.py): the DNN over the valid frames, pass 1
    over each utterance's own frames (a frame's shared tables once, its
    state once a row still in its utterance: padding is no work), every
    A* round the card ran.  `shapes` holds each batch's (padded length,
    frame counts)."""
    layers = [w.shape for w in model.weights] + [model.out_w.shape]
    d_in = model.weights[0].shape[0]
    R = lex.S + len(lex.members)
    N = int(lex.length.sum())
    Ex = len(model.names)
    K1 = 1 + max(int(j - i) for i, j in zip(*np.nonzero(
        lex.arcs[int(np.argmax(lex.length))] > -1e9)))
    M = int(config["search"]["trellis_topm"])
    lm = 2 if Ex > 65535 else 1
    out = dict(dnn=0.0, pass1=0.0, astar=0.0)
    for T, nfr in shapes:
        frames = int(sum(nfr))
        out["dnn"] += counts.least_s(
            flops_bf16=counts.dnn_flops(frames, layers),
            nbytes=counts.dnn_bytes(frames, layers, d_in, R))
        # frames at which exactly b rows are still inside their utterance
        live = np.bincount(np.asarray(nfr, np.int64), minlength=T + 1)
        rows_at = len(nfr) - np.cumsum(live)[:-1]      # [T]: rows with n > t
        for b, n_t in zip(*np.unique(rows_at[rows_at > 0],
                                     return_counts=True)):
            out["pass1"] += int(n_t) * counts.least_s(
                flops_f32=counts.step_ops(b, N, K1)
                + counts.word_end_ops(b, Ex, 2 * M),
                nbytes=counts.step_bytes(b, N, K1, R)
                + counts.word_end_bytes(b, Ex, 2 * M, M, lm, True))
    if chains is not None:
        from julius_tpu_torch.search.pass2_device import SCAN_WIN
        nmax, k1 = chains
        for st in astar_stats:
            K = int(st["B"]) * int(st["P"])
            out["astar"] += int(st["replayed"]) * counts.least_s(
                flops_f32=counts.scan_ops(K, SCAN_WIN, nmax, k1),
                nbytes=counts.scan_bytes(K, SCAN_WIN, nmax, k1))
    return out
