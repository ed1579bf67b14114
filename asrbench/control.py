"""Readings that set the limits of `correct`: sound runs of the program,
runs of the control and runs with a fault planted, several seeds in one
process.

    python3 asrbench/control.py --workload flagship.batch16 \
        --sound 1,2,3 --control 4,5,6 --low_ranks 7,8,9 --seconds 8

A sound run is the cell as the benchmark runs it.  The others put
something in the program's place (`FAULTS`):

* `control`: the plain reference's DNN with its operands rounded to
  float8 e4m3 with a per-tensor scale (the precision below the
  configuration's bfloat16), so everything after it decodes the
  control's scores;
* `low_ranks`: pass 1's word-end stage keeps the frame's word ends of
  ranks M+1 to 2M in place of the best M (a wrong top-M), every score
  it keeps computed right;
* `astar_one_pop`: pass 2 pops one round of hypotheses on the card and
  one hypothesis in the host's re-scan (a cut pop budget);
* `state_unchanged`: a pass-1 step that returns its state unchanged;
* `half_batch`: half of a batch left out, its results copied from the
  other half;
* `altered`: a result's second word changed where the result is made.

Each run prints its result line as `run.py` does; the last line is a
JSON summary: each compared number's largest sound reading and its
smallest reading under each other kind.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_patch(model):
    """Put the reference's float8 DNN in the engine's place."""
    from asrbench.reference.dnn import PlainDNN

    def patch(eng):
        dnn = PlainDNN(model, eng.device, "fp8")

        def outprob(feats):
            B, T, D = feats.shape
            sen = dnn(feats.reshape(B * T, D)).reshape(B, T, -1)
            return eng._extend(sen)
        eng._outprob = outprob
    return patch


@contextlib.contextmanager
def _swapped(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _low_ranks():
    import torch
    from julius_tpu_torch.ops import word_end_kernel as we

    def word_end(dev, ngram, cfg, score, ctx, prev, t=None):
        M = cfg.n_atoms
        wide = we.word_end_candidates(
            dev, ngram, dataclasses.replace(cfg, n_atoms=2 * M), score, ctx,
            prev)
        low = we.Trellis(*[a[:, M:2 * M] for a in wide])
        low = low._replace(begin=torch.where(
            low.prev >= 0, torch.div(low.prev, M, rounding_mode="floor") + 1,
            0).to(torch.int32))
        if t is None:
            return low, None
        return low, we.scalar_entry_batched(low, t, M)
    return _swapped(we, "word_end", word_end)


@contextlib.contextmanager
def _astar_one_pop():
    from julius_tpu_torch.search import pass2_device as p2d
    setup = p2d._setup

    def one_round(*args, **kwargs):
        out = setup(*args, **kwargs)
        return None if out is None else (out[0]._replace(max_rounds=1),
                                         out[1])
    with _swapped(p2d, "_setup", one_round):
        yield


def _state_unchanged():
    from julius_tpu_torch.search import pass1 as p1
    frame = p1._frame

    def stuck(dev, ngram, cfg, tabs, score, ctx, prev, *rest):
        frame(dev, ngram, cfg, tabs, score, ctx, prev, *rest)
        return score.clone(), ctx.clone(), prev.clone()
    return _swapped(p1, "_frame", stuck)


def _altered():
    from julius_tpu_torch.engine import Engine
    stack = contextlib.ExitStack()
    for name in ("_assemble_pass2", "_pass1_result"):
        orig = getattr(Engine, name)

        def changed(self, *a, _orig=orig, **k):
            r = _orig(self, *a, **k)
            if r is not None and len(r.word_ids) > 2:
                r.word_ids = list(r.word_ids)
                r.word_ids[1] = (r.word_ids[1] + 1) % self.voca.n_words \
                    or 2
            return r
        stack.enter_context(_swapped(Engine, name, changed))
    return stack


def _half_batch(eng):
    decode = eng.decode_features

    def half(feats, n_frames):
        h = max(1, len(n_frames) // 2)
        res = decode(feats[:h], n_frames[:h])
        return [res[i % h] for i in range(len(n_frames))]
    eng.decode_features = half


def _one_pop_budget(eng):
    eng.search_cfg.max_hypo_pop = 1


#: the faults of pass 2, which a cell whose traffic has `"pass2": false`
#: does not run
PASS2_FAULTS = ("astar_one_pop",)

#: each fault: (a context that plants it in the program's modules or
#: None, a patch of the engine or None)
FAULTS = {
    "low_ranks": (_low_ranks, None),
    "astar_one_pop": (_astar_one_pop, _one_pop_budget),
    "state_unchanged": (_state_unchanged, None),
    "half_batch": (None, _half_batch),
    "altered": (_altered, None),
}


def cell_model(workload: str, config=None):
    """The cell's model, as its configuration builds it."""
    from asrbench import harness
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    cfg = config or harness.load_json(
        harness.HERE / "configs" / f"{cell['config']}.json")
    builder = harness.load_module(harness.HERE / "configs"
                                  / f"{cell['config']}.py")
    return builder.build(cfg, 0)


@contextlib.contextmanager
def planted(kind: str, workload: str, config=None):
    """Plant `kind` ("sound", "control" or a key of FAULTS); yields the
    engine patch to hand `run_cell`."""
    if kind == "sound":
        yield None
        return
    if kind == "control":
        yield control_patch(cell_model(workload, config))
        return
    context, patch = FAULTS[kind]
    with (context() if context else contextlib.nullcontext()):
        yield patch


def readings(workload: str, seeds: dict, seconds: float,
             device: str = "cuda") -> dict:
    """Run each seed once under its kind ({kind: [seeds]}); returns
    {kind: [checks...]} and prints every line."""
    from asrbench import harness

    out = {}
    for kind, kind_seeds in seeds.items():
        out[kind] = []
        for seed in kind_seeds:
            buf = io.StringIO()
            with planted(kind, workload) as patch:
                line = harness.run_cell(workload, seed, seconds, False,
                                        device=device, patch=patch, out=buf,
                                        err=io.StringIO())
            print(kind, seed, buf.getvalue().splitlines()[0][:700])
            print(kind, seed, json.dumps(line["checks"]), flush=True)
            out[kind].append(line["checks"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    for kind in ("sound", "control", *FAULTS):
        ap.add_argument(f"--{kind}", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = {k: [int(s) for s in getattr(args, k).split(",") if s]
             for k in ("sound", "control", *FAULTS)}
    r = readings(args.workload, {k: v for k, v in seeds.items() if v},
                 args.seconds)
    summary = {}
    for kind, runs in r.items():
        pick = max if kind == "sound" else min
        for k in runs[0]:
            summary.setdefault(k, {})[kind] = pick(c[k]["value"]
                                                   for c in runs)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
