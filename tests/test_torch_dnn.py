"""Port vs reference: DNN senone scores.

Both packages run bf16 operands with f32 accumulation and round each
hidden activation back to bf16.  Their f32 sums may be taken in another
order, and one ulp at a bf16 rounding boundary flips that activation by
one bf16 step (2^-8 relative), which moves log10 scores by up to ~1e-2.
So scores are held to atol 2e-2, and the per-frame best senone must
agree on at least 99% of frames."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.io.dnn import DNNParams
from julius_tpu.ops import dnn as jdnn
from julius_tpu.tools.synth import make_dnn, trained_dnn_weights
from julius_tpu_torch import convert
from julius_tpu_torch.ops import dnn as tdnn

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


def params(kind):
    if kind == "random":
        return make_dnn(dim_in=1320, hidden=256, n_layers=3, n_out=300)
    w, b, ow, ob, _ = trained_dnn_weights(300, 1320, 120, 11, 128, 2, 3)
    return DNNParams(w, b, ow, ob, np.full(300, np.log10(1 / 300), np.float32),
                     context_len=11, feature_len=120)


@pytest.mark.parametrize("kind", ["random", "trained"])
def test_dnn_scores_match_reference(kind):
    p = params(kind)
    jsc = jdnn.build_dnn_scorer(p)
    from_ref = convert.dnn_scorer(convert.numpy_fields(jsc), "cpu")
    own = tdnn.build_dnn_scorer(p, "cpu")
    # the same bf16 weights either way
    for a, b in zip(from_ref.weights, own.weights):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(from_ref.output_w, own.output_w)

    x = np.random.default_rng(0).standard_normal((3, 40, 1320)).astype(
        np.float32)
    ref = np.asarray(jdnn.dnn_scores(jsc, jnp.asarray(x)))
    got = own(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 40, 300)
    assert got.dtype == np.float32
    err = np.abs(got - ref)
    assert err.max() <= 2e-2
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.99
