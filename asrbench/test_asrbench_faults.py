"""`correct` comes out false for the control and for every fault a cell
can have, at a tiny size on the CPU.  Each run skips the look for a card
and drives the rest of a run with the timed path broken underneath,
under the cell's own limits.

The faults (asrbench/control.py `FAULTS`): the control (the reference's
DNN in float8 in the program's place); pass 1's word-end stage keeping
ranks M+1 to 2M; pass 2 cut to one round of pops; a pass-1 step that
returns its state unchanged; half of a batch left out, its results taken
from the other half; an answer altered where it is produced.  The
exchange between chips is not a fault these cells can have: each runs
on one card and exchanges nothing.  Nor is a cut of pass 2 a fault of a
cell whose traffic runs pass 1 alone (`"pass2": false`).
"""

import io

import pytest

from asrbench import harness
from asrbench.conftest import tiny_cell
from asrbench.control import FAULTS, PASS2_FAULTS, planted


def pairs():
    """(cell, fault) for each fault a cell can have."""
    for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]:
        traffic = harness.load_json(harness.HERE / "traffic"
                                    / f"{c['traffic']}.json")
        for fault in ("control", *FAULTS):
            if traffic["pass2"] or fault not in PASS2_FAULTS:
                yield c["name"], fault


@pytest.mark.parametrize("workload,fault", list(pairs()))
def test_a_fault_makes_correct_false(workload, fault):
    cfg, traffic = tiny_cell(workload)
    if fault == "half_batch" and traffic["batch"] < 2:
        pytest.skip("a batch of one has no half to leave out")
    with planted(fault, workload, config=cfg) as patch:
        line = harness.run_cell(workload, 2**31 + 3, 0.3, False,
                                device="cpu", config=cfg, traffic=traffic,
                                patch=patch, out=io.StringIO(),
                                err=io.StringIO())
    assert line["correct"] is False, line["checks"]
