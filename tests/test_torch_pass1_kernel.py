"""Port vs reference: one frame of the fused pass-1 beam update.

The port's plain PyTorch version (`fused_step_plain`, the CUDA kernel's
oracle and CPU path) against the reference Pallas kernel run through
the Pallas interpreter, on inputs built to hit every rule: a node axis
of several reference tiles (the inter-tile halo), exact ties between
shifted candidates (smallest k wins) and with the entry candidate
(strictly greater only), LOG_ZERO runs, missing arcs and entries, and
frozen rows.  Integer outputs must be equal; scores within atol 1e-5
(the same f32 adds in the same order, so in practice bit-equal)."""

import numpy as np
import jax.numpy as jnp
import pytest

from julius_tpu.ops import pass1_kernel as jpk
from julius_tpu_torch.ops import pass1_kernel as tpk

from torch_fixtures import assert_same_step, make_step_inputs, run_step


def run_reference(d):
    out = d["row"][:, d["sidx"]]
    res = jpk.fused_step(
        jnp.asarray(d["score"]), jnp.asarray(d["ctx"]), jnp.asarray(d["prev"]),
        jnp.asarray(d["loc"]), jnp.asarray(d["et"]), jnp.asarray(out),
        jnp.asarray(d["ent"]), jnp.asarray(d["ectx"]), jnp.asarray(d["eprev"]),
        jnp.asarray(d["fv"]), interpret=True)
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("B,K", [(1, 1), (3, 1), (2, 3)])
def test_plain_matches_reference_kernel(B, K):
    N = 3 * jpk.tile_n(B)                            # several tiles
    d = make_step_inputs(B * 10 + K, B, N, K)
    ref = run_reference(d)
    got = run_step(d)
    assert_same_step(got, ref)
    # a frozen row keeps its state; ties really occurred
    if B > 1:
        assert np.array_equal(got[0][1], d["score"][1])
    assert (d["loc"][0] + d["score"] == d["loc"][1] + np.roll(
        d["score"], 1, axis=1)).sum() > 10


def test_several_frames_match_reference():
    """A run of frames, each fed the previous frame's output."""
    B, K = 2, 2
    N = 2 * jpk.tile_n(B)
    d = make_step_inputs(7, B, N, K)
    for f in range(4):
        ref = run_reference(d)
        got = run_step(d)
        assert_same_step(got, ref)
        d = dict(d, score=ref[0], ctx=ref[1], prev=ref[2],
                 row=np.roll(d["row"], f + 1, axis=1),
                 fv=np.asarray([True, f < 2]))


def test_cpu_tensors_take_the_plain_version():
    d = make_step_inputs(3, 2, 700, 1)
    before = tpk.LAUNCHES
    assert_same_step(run_step(d, fn=tpk.fused_step), run_step(d))
    assert tpk.LAUNCHES == before
