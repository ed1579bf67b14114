"""Run one cell of the benchmark once on one NVIDIA card.

    python3 asrbench/run.py --workload flagship.batch16 --seed 7 \
        --seconds 30 --trace 0

Loads the cell named in BENCHMARK.json, builds its model and the port's
engine from the seed, warms up, decodes fresh batches for `--seconds`,
judges a sample of the results with the plain reference and prints one
JSON line last: end-to-end metrics with `--trace 0`, per-layer metrics
(from a profiled window) with `--trace 1`.  Exits non-zero, printing no
result, where no CUDA card is found.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from asrbench.harness import ROOT, load_json, run_cell
    cell = next(c for c in load_json(ROOT / "BENCHMARK.json")["workloads"]
                if c["name"] == args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s): this "
              "benchmark measures the card and does not fall back to the "
              "CPU", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), device="cuda", t_start=T_START)
    return 0 if line is not None else 1


if __name__ == "__main__":
    sys.exit(main())
