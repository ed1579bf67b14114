"""Whole runs of every cell on the CPU at a tiny size: the plain
reference holds the port to it, the result line has the keys a run
prints, a new configuration, traffic mix, metric and limits file are
found by name, and nothing of JAX or the JAX package is loaded."""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from asrbench import harness
from asrbench.conftest import tiny_cell

CELLS = [c["name"] for c in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


def run(workload, trace=False, **kw):
    cfg, traffic = tiny_cell(workload)
    out = io.StringIO()
    line = harness.run_cell(workload, 2**31 + 11, 0.3, trace, device="cpu",
                            config=cfg, traffic=traffic, out=out,
                            err=io.StringIO(), **kw)
    assert json.loads(out.getvalue().splitlines()[-1]) == line
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_reference_holds_the_port_at_a_tiny_size(workload):
    line = run(workload)
    c = {k: v["value"] for k, v in line["checks"].items()}
    # on the CPU the port's products are float32 of the same bf16
    # operands, so only the order of the sums differs
    assert c["dnn_gap"] < 1e-4
    assert c["atom_gap"] < 1e-2
    assert c.get("nbest_gap", 0.0) < 1e-2
    assert c.get("search_gap", 0.0) < 1e-2
    assert c["bad_links"] == c["missing"] == c.get("p1_wrong", 0) \
        == c["truth_lost"] == 0
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0


def test_the_result_lines_keys():
    line = run("flagship.batch16")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"xrt", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    traced = run("flagship.utt1", trace=True)
    assert list(traced)[-1] == "checks"
    assert all(k.endswith(".utt") for k in traced["metrics"])
    assert all(v["value"] >= 0 for v in traced["metrics"].values())


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, traffic mix, metric and limits file added under
    new names run without an edit to any file that is there."""
    tag = f"t{os.getpid()}"
    here = harness.HERE
    cfg, traffic = tiny_cell("flagship.batch16")
    # a tied-triphone model (pseudo sets in pass 1, strict inter-word
    # context in pass 2) through the same builder and reference
    cfg.update(name=f"cfg_{tag}", kind="tied_triphone", num_base_phones=5,
               variants=3, tied_pool=30)
    cfg["search"].update(strict_iwcd2=True, iwcd_scheme="max")
    files = {here / "configs" / f"cfg_{tag}.json": json.dumps(cfg),
             here / "configs" / f"cfg_{tag}.py":
                 (here / "configs" / "flagship.py").read_text(),
             here / "traffic" / f"mix_{tag}.json": json.dumps(traffic),
             here / "metrics" / f"frames_{tag}.py":
                 "def read(run):\n    return run.audio_s * 100\n",
             here / "limits" / f"cell.{tag}.json": json.dumps(dict(
                 dnn_gap=1, atom_gap=1, bad_links=0, missing=0,
                 nbest_gap=1, search_gap=1, truth_lost=0))}
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"].append(dict(name=f"cfg_{tag}", source="x",
                                 file=f"asrbench/configs/cfg_{tag}.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name=f"cell.{tag}", config=f"cfg_{tag}",
                                   traffic=f"mix_{tag}", chips=1,
                                   why="test"))
    bench["end_to_end"].append(dict(name=f"frames_{tag}", unit="frames",
                                    better="higher", bound=0.1,
                                    source="host_clock"))
    try:
        for p, text in files.items():
            assert not p.exists()
            p.write_text(text)
        line = harness.run_cell(f"cell.{tag}", 5, 0.3, False, device="cpu",
                                bench=bench, out=io.StringIO(),
                                err=io.StringIO())
    finally:
        for p in files:
            p.unlink(missing_ok=True)
    assert line["correct"] is True
    assert line["metrics"][f"frames_{tag}"]["value"] > 0
    # xrt lists its cells; setup_s, listing none, is in every cell
    assert set(line["metrics"]) == {f"frames_{tag}", "setup_s"}


FORBIDDEN = {"jax", "jaxlib", "flax", "julius_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & (FORBIDDEN | {"julius_tpu_torch"}), path


def test_a_run_loads_no_jax_nor_the_jax_package():
    """Top-level module names compared whole: julius_tpu_torch, whose
    name begins with julius_tpu's, is the program and is loaded."""
    code = (
        "import io, sys\n"
        "from asrbench.conftest import tiny_cell\n"
        "from asrbench import harness\n"
        "cfg, tr = tiny_cell('flagship.batch16')\n"
        "harness.run_cell('flagship.batch16', 3, 0.2, False, device='cpu',"
        " config=cfg, traffic=tr, out=io.StringIO(), err=io.StringIO())\n"
        "import asrbench.run, asrbench.control\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=harness.ROOT)
    tops = set(out.stdout.split())
    assert "julius_tpu_torch" in tops
    assert not tops & FORBIDDEN
