"""Shared inputs and settings for the port's tests (imports neither JAX
nor the reference package, so the card-only tests can use it where JAX
is not installed)."""

import numpy as np
import torch

from julius_tpu_torch.ops import pass1_kernel as tpk

LOG_ZERO = -1e10

# The test suite runs in several pytest workers on one machine.  torch's
# OpenMP threads spin between parallel regions, and with one pool per
# core in every worker a host re-scan test ran 29 times slower (290 s
# against 10 s, six workers on eight cores) than with one thread each.
# Every test module of the port imports this one, so each worker keeps
# a single intra-op thread.
torch.set_num_threads(1)


def make_step_inputs(seed, B, N, K, R=50):
    """One beam-update frame's arrays ([B, N] state, K+1 arc shifts, an
    R-wide outprob row) built to hit every rule of the update."""
    rng = np.random.default_rng(seed)
    # small integer-valued scores make exact ties common
    score = rng.integers(-40, 0, (B, N)).astype(np.float32)
    score[rng.random((B, N)) < 0.2] = LOG_ZERO
    score[:, 100:400] = LOG_ZERO                     # a LOG_ZERO run
    ctx = rng.integers(-1, 500, (B, N)).astype(np.int32)
    prev = rng.integers(-1, 5000, (B, N)).astype(np.int32)
    loc = rng.integers(-3, 1, (K + 1, N)).astype(np.float32)
    loc[rng.random((K + 1, N)) < 0.3] = LOG_ZERO     # missing arcs
    et = rng.integers(-6, 0, N).astype(np.float32)
    et[rng.random(N) < 0.7] = LOG_ZERO               # no word entry
    row = rng.integers(-5, 0, (B, R)).astype(np.float32)
    sidx = rng.integers(0, R, N).astype(np.int32)
    ent = rng.integers(-40, -20, B).astype(np.float32)
    ent[0] = LOG_ZERO                                # no word end yet
    ectx = rng.integers(-1, 500, B).astype(np.int32)
    eprev = rng.integers(-1, 5000, B).astype(np.int32)
    fv = np.ones(B, bool)
    fv[1:2] = False                                  # a frozen row
    return dict(score=score, ctx=ctx, prev=prev, loc=loc, et=et, row=row,
                sidx=sidx, ent=ent, ectx=ectx, eprev=eprev, fv=fv)


def run_step(d, device="cpu", fn=tpk.fused_step_plain):
    """One beam-update frame of `fn` on the make_step_inputs arrays."""
    t = {k: torch.tensor(v, device=device) for k, v in d.items()}
    res = fn(t["score"], t["ctx"], t["prev"], t["loc"], t["et"], t["row"],
             t["sidx"], t["ent"], t["ectx"], t["eprev"], t["fv"])
    return [a.cpu().numpy() for a in res]


def assert_same_step(a, b):
    """Scores within atol 1e-5, ctx and prev equal."""
    assert np.allclose(a[0], b[0], atol=1e-5, rtol=0)
    assert np.array_equal(a[1], b[1])
    assert np.array_equal(a[2], b[2])
