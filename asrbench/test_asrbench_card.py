"""The control and the search faults at a cell's own size on the card: a
sound run is correct, and the control's and each fault's are not
(python -m pytest asrbench/ -m cuda, on an NVIDIA card; a few
minutes).  Each window is long enough to reach every call the judge
samples (the first 60 of flagship.utt1's), so that none counts as
missing."""

import pytest

from asrbench.control import readings

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["flagship.batch16", "flagship.utt1"])
def test_control_and_faults_fail_and_sound_run_passes(cuda, workload):
    from asrbench import harness
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")
    r = readings(workload, dict(sound=[4242], control=[4343],
                                low_ranks=[4444], astar_one_pop=[4545]),
                 12.0)

    def ok(checks):
        return all(checks[k]["value"] <= limits[k] for k in checks)
    assert ok(r["sound"][0])
    for kind in ("control", "low_ranks", "astar_one_pop"):
        assert not ok(r[kind][0]), kind
