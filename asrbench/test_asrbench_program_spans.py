"""The reading of the program's own spans (`asrbench/program_spans.py`)
on a hand-made profile: the card's idle time inside the `astar.rounds`
ranges, the window's idle time by innermost program range, host ms per
audio second by span, and `asrbench/trace.py` `device_activity`'s
outputs the same with the program's ranges in the profile as without."""

import types

import pytest
import torch

from asrbench import program_spans as ps
from asrbench.trace import device_activity

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CPU, corr=0,
                 annotation=False):
        self._v = (name, start, end - start, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))


#: one decode: the benchmark's own spans, four launches and their
#: kernels (busy 100-200, 620-640, 710-790, 860-880 ns)
BENCH = [Event("asrbench.decode", 0, 1000),
         Event("asrbench.astar", 490, 985)]
for i, (t, s, e) in enumerate([(50, 100, 200), (610, 620, 640),
                               (705, 710, 790), (855, 860, 880)]):
    BENCH += [Event("cudaLaunchKernel", t, t + 3, corr=i + 1),
              Event(f"kernel{i}", s, e, device=CUDA, corr=i + 1)]
#: the program's ranges and their device-side user annotations
PROGRAM = [Event("julius.decode", 10, 990),
           Event("julius.astar", 500, 980),
           Event("julius.astar.setup", 500, 560),
           Event("julius.astar.rounds", 600, 900),
           Event("julius.astar.wait", 650, 700),
           Event("julius.astar.wait", 800, 850),
           Event("julius.astar.rounds", 600, 900, device=CUDA,
                 annotation=True),
           Event("julius.astar.wait", 650, 700, device=CUDA,
                 annotation=True)]


def test_idle_inside_the_rounds_and_by_span():
    got = ps.program_activity(profile(BENCH + PROGRAM))
    # 300 ns of rounds, 120 of them busy
    assert got["rounds_s"] == pytest.approx(300e-9)
    assert got["rounds_idle_s"] == pytest.approx(180e-9)
    assert ps.rounds_idle_pct(got) == pytest.approx(60.0)
    # the gaps 200-620, 640-710, 790-860 by innermost range; a parent and
    # a child that begin together charge the child
    assert {k: round(v * 1e9) for k, v in got["idle_by_span"]} == {
        "decode": 300, "astar": 40, "astar.setup": 60, "astar.rounds": 60,
        "astar.wait": 100}
    assert [k for k, _ in got["idle_by_span"]][:2] == ["decode",
                                                       "astar.wait"]


def test_device_activity_is_the_same_with_the_programs_ranges():
    assert device_activity(profile(BENCH + PROGRAM)) == \
        device_activity(profile(BENCH))


def test_no_device_activity_or_no_rounds():
    got = ps.program_activity(profile(PROGRAM))
    assert got["idle_by_span"] == [] and ps.rounds_idle_pct(got) is None
    got = ps.program_activity(profile(BENCH))
    assert got["rounds_s"] == 0 and ps.rounds_idle_pct(got) is None
    assert got["idle_by_span"] == [["outside", pytest.approx(560e-9)]]


def test_ms_per_audio_second():
    self_s = {"features.h2d": 0.002, "astar.wait": 0.5, "decode": 9.0,
              "prepare.seed": 0.0}
    assert ps.per_audio_second(self_s, 20.0) == pytest.approx(
        {"features_h2d_ms_per_s": 0.1, "astar_wait_ms_per_s": 25.0,
         "prepare_seed_ms_per_s": 0.0})
    assert ps.per_audio_second(self_s, 0.0) == {}


def test_reads_the_ranges_of_a_real_profile():
    """The port's spans under a CPU profile: two `julius.` ranges, no
    device activity."""
    from julius_tpu_torch.utils import trace
    trace.drain()
    trace.enable(True)
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            with trace.span("astar.rounds"):
                with trace.span("astar.wait"):
                    torch.ones(3).sum()
    finally:
        trace.enable(False)
        trace.drain()
    dev, ranges = ps._events(prof)
    assert dev == []
    assert [n for _, _, n in sorted(ranges)] == ["astar.rounds",
                                                 "astar.wait"]
    got = ps.program_activity(prof)
    assert got["rounds_s"] > 0 and ps.rounds_idle_pct(got) is None
