"""The traffic's pool at a tiny size on the CPU: a larger pool keeps a
smaller one's batches, and its making stays out of `setup_s`."""

import io
import re
import time

import numpy as np

from asrbench import harness
from asrbench.conftest import tiny_cell

SEED = 2**31 + 17


def tiny_model(workload):
    cfg, traffic = tiny_cell(workload)
    cell = next(c for c in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["workloads"]
        if c["name"] == workload)
    builder = harness.load_module(harness.HERE / "configs"
                                  / f"{cell['config']}.py")
    return builder.build(cfg, SEED), traffic


def same(a, b):
    return (np.array_equal(a.feats, b.feats)
            and np.array_equal(a.nfr, b.nfr) and a.truths == b.truths)


def same_utt(a, u, b, v):
    n = int(a.nfr[u])
    return (n == int(b.nfr[v]) and a.truths[u] == b.truths[v]
            and np.array_equal(a.feats[u, :n], b.feats[v, :n]))


def test_a_larger_pool_keeps_the_smaller_pools_batches():
    model, traffic = tiny_model("envr20k.1pass16")
    traffic.update(check_within=3, check_batches=2)
    m = 40
    _, large, sampled = harness.make_batches(
        model, dict(traffic, pool_batches=m), SEED)
    first = sampled[0]
    assert len(large) == m
    moved = 0
    for n in (3, 4, 5, 6, 8):
        _, small, sampled_n = harness.make_batches(
            model, dict(traffic, pool_batches=n), SEED)
        assert len(small) == n and sampled_n == sampled
        # each pool's longest utterance sits in its first sampled batch
        for pool in (small, large):
            assert max(b.nfr.max() for b in pool) == pool[first].nfr.max()
        # the two swaps touch the first sampled batch and the batch
        # that held the small pool's longest, which the large pool keeps
        # where it was
        longest = int(small[first].nfr.max())
        assert large[first].nfr.max() > longest
        held = [i for i in range(n) if i != first
                and any(same_utt(large[i], u, small[first], v)
                        for u in range(len(large[i].nfr))
                        for v in range(len(small[first].nfr))
                        if small[first].nfr[v] == longest)]
        assert len(held) <= 1
        moved += len(held)
        differ = [i for i in range(n) if not same(small[i], large[i])]
        assert differ == sorted({first, *held})
    assert moved > 0        # some small pool's longest was not in place


def test_the_sampled_batches_depend_on_the_seed_alone():
    model, traffic = tiny_model("flagship.utt1")
    traffic.update(check_within=30, check_batches=6)
    picks = [harness.make_batches(model, dict(traffic, pool_batches=nb),
                                  SEED)[2] for nb in (30, 64, 200)]
    assert picks[0] == picks[1] == picks[2]
    assert picks[0] != harness.make_batches(
        model, dict(traffic, pool_batches=30), SEED + 1)[2]


def test_setup_s_leaves_out_the_making_of_the_traffic(monkeypatch):
    """A pool whose making takes 2 s longer leaves `setup_s` as it was:
    set-up ends where the window starts, less the traffic's interval;
    the log line gives that interval, the pool's size and GB, and the
    share of the pool the window decoded."""
    workload = "flagship.batch16"
    cfg, traffic = tiny_cell(workload)
    make = harness.make_batches
    seen = {}

    def slow(*args):
        seen["traffic"] = time.perf_counter()
        time.sleep(2.0)
        out = make(*args)
        seen["traffic"] = time.perf_counter() - seen["traffic"]
        seen["warm"] = len(out[0])
        return out

    calls = []

    def patch(eng):
        decode = eng.decode_features

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = decode(*args, **kwargs)
            calls.append((t0, time.perf_counter()))
            return out
        eng.decode_features = timed

    monkeypatch.setattr(harness, "make_batches", slow)
    out = io.StringIO()
    t_start = time.perf_counter()
    line = harness.run_cell(workload, SEED, 0.3, False, device="cpu",
                            t_start=t_start, config=cfg, traffic=traffic,
                            patch=patch, out=out, err=io.StringIO())
    setup_s = line["metrics"]["setup_s"]["value"]
    warmed, first = calls[seen["warm"] - 1][1], calls[seen["warm"]][0]
    assert seen["traffic"] >= 2.0
    # between the warm-up's end and the window's first call, less the
    # traffic (which the harness times from just outside `slow`)
    assert warmed - t_start - seen["traffic"] - 0.05 <= setup_s
    assert setup_s <= first - t_start - seen["traffic"]
    log = out.getvalue().splitlines()[0]
    got = re.search(r"traffic ([0-9.]+) s, not in set-up: a pool of (\d+) "
                    r"batches, ([0-9.]+) GB on the host, warmed up at \[[0-9, ]+\] "
                    r"frames, of which the window "
                    r"decoded (\d+) \(([0-9.]+)%\)", log)
    assert got, log
    assert float(got[1]) >= 2.0
    done = len(calls) - seen["warm"]
    assert int(got[2]) == traffic["pool_batches"]
    assert float(got[3]) > 0
    assert int(got[4]) == done
    assert abs(float(got[5]) - 100 * done / traffic["pool_batches"]) < 0.06
