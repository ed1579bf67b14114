"""Both kernel wrappers launch on their tensors' own card.

A kernel library bound with ctypes launches on the CUDA runtime's
current device, which is per thread; the wrappers (`fused_step`,
`scan_core_win`) must make the tensors' card current around the launch,
and leave the current device alone when it is that card already.  There
is no card here, so the tensors only say they lie on `cuda:1` (a tensor
subclass whose `device` reads so), and `torch.cuda`'s device calls and
the kernel libraries are stand-ins that record which card is current
when the launch is made.
"""

import contextlib

import numpy as np
import pytest
import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.ops import pass1_kernel as tpk
from julius_tpu_torch.ops import scan_kernel as tsk

from torch_fixtures import make_step_inputs

CARD = torch.device("cuda", 1)


class OnCard1(torch.Tensor):
    """A CPU tensor that reports lying on cuda:1."""

    @property
    def device(self):
        return CARD


class Launches:
    """The stand-in CUDA runtime: the current device, the cards entered
    through torch.cuda.device, and the current device at each launch."""

    def __init__(self, current):
        self.current = current
        self.entered = []
        self.at_launch = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev).index
        self.entered.append(self.current)
        try:
            yield
        finally:
            self.current = prev

    def launch(self, *args):
        self.at_launch.append(self.current)
        return 0


@pytest.fixture(params=[0, 1], ids=["other-card-current", "card-current"])
def runtime(request, monkeypatch):
    rt = Launches(request.param)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: rt.current)
    monkeypatch.setattr(torch.cuda, "device", rt.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(cuda_build, "check_arg", lambda *a: None)
    return rt


def on_card(a):
    return torch.as_tensor(a).as_subclass(OnCard1)


def test_fused_step_launches_on_its_tensors_card(runtime, monkeypatch):
    lib = type("Lib", (), {"pass1_step_launch": staticmethod(runtime.launch)})
    monkeypatch.setattr(tpk, "build", lambda: lib)
    monkeypatch.setattr(tpk, "_plan", lambda dev, B, N, K1: tpk.launch_plan(
        B, N, K1))
    d = make_step_inputs(3, 2, 300, 1)
    args = [on_card(d[k]) for k in ("score", "ctx", "prev", "loc", "et",
                                     "row", "sidx", "ent", "ectx", "eprev",
                                     "fv")]
    before = tpk.LAUNCHES
    tpk.fused_step(*args)
    assert runtime.at_launch == [1]
    assert runtime.entered == ([] if runtime.current == 1 else [1])
    assert tpk.LAUNCHES == before + 1


def test_fused_step_writes_the_given_state_set(runtime, monkeypatch):
    """Given out=, the kernel's output pointers are out's, nothing is
    allocated, and out is returned; an out that shares memory with the
    state it steps is refused."""
    args_at_launch = []

    def launch(*a):
        args_at_launch.append(a)
        return runtime.launch()

    lib = type("Lib", (), {"pass1_step_launch": staticmethod(launch)})
    monkeypatch.setattr(tpk, "build", lambda: lib)
    monkeypatch.setattr(tpk, "_plan", lambda dev, B, N, K1: tpk.launch_plan(
        B, N, K1))
    d = make_step_inputs(3, 2, 300, 1)
    args = [on_card(d[k]) for k in ("score", "ctx", "prev", "loc", "et",
                                     "row", "sidx", "ent", "ectx", "eprev",
                                     "fv")]
    out = tuple(on_card(torch.empty_like(t)) for t in args[:3])

    def refuse(*a, **kw):
        raise AssertionError("fused_step allocated an output")

    monkeypatch.setattr(torch, "empty_like", refuse)
    got = tpk.fused_step(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert args_at_launch[0][13:16] == tuple(o.data_ptr() for o in out)
    with pytest.raises(ValueError, match="shares memory"):
        tpk.fused_step(*args, out=(out[0], args[1], out[2]))
    assert len(args_at_launch) == 1


def test_scan_core_win_launches_on_its_tensors_card(runtime, monkeypatch):
    lib = type("Lib", (), {"scan_win_launch": staticmethod(runtime.launch)})
    monkeypatch.setattr(tsk, "build", lambda: lib)
    K, W, N, K1, B, T, R = 3, 8, 5, 2, 2, 20, 7
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((K, K1, N)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.integers(0, R, (K, N)).astype(np.int32),
            rng.standard_normal((K, W)).astype(np.float32),
            rng.standard_normal((B, T, R)).astype(np.float32),
            np.zeros(K, np.int32), np.zeros(K, np.int32)]
    before = tsk.LAUNCHES
    g, beg, sv = tsk.scan_core_win(*[on_card(a) for a in args])
    assert runtime.at_launch == [1]
    assert runtime.entered == ([] if runtime.current == 1 else [1])
    assert tsk.LAUNCHES == before + 1
    assert g.shape == beg.shape == sv.shape == (K, W)
    assert beg.dtype == torch.int32 and g.dtype == sv.dtype == torch.float32
