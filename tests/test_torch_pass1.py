"""Port vs reference: batched pass 1 over a whole utterance batch.

The port's `pass1_batch` (Python frame loop, beam-update kernel's plain
version on the CPU) against the reference's `pass1_batch` (its vmap
fallback on the CPU) on the same extended outprob rows, ragged lengths
and the same network and N-gram tables (carried across by convert.py).
The trellis is compared by the reference's own fused-vs-fallback rule
(tests/test_pass1_fused.py): word ids equal everywhere, other integer
fields equal and scores allclose(atol=1e-5) where a word survived; and
the backtraced words must be equal.  Factoring 2, the score envelope and
isolated words take the port's unfused step on the same network and
rows."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search import pass1 as jp1
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch import convert
from julius_tpu_torch.search import pass1 as tp1

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


def trellis_equal(a, b):
    valid = np.asarray(a.word) >= 0
    assert np.array_equal(np.asarray(a.word), np.asarray(b.word))
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.dtype.kind == "f":
            assert np.allclose(np.where(valid, x, 0), np.where(valid, y, 0),
                               atol=1e-5), name
        else:
            assert np.array_equal(np.where(valid, x, 0),
                                  np.where(valid, y, 0)), name


@pytest.fixture(scope="module")
def reference():
    eng = flagship_engine(n_words=120, n_phones=48, hidden=32, n_layers=1)
    rng = np.random.default_rng(5)
    B, T = 3, 90
    feats = rng.standard_normal((B, T, 1320)).astype(np.float32)
    out = np.array(jax.jit(eng._outprob)(jnp.asarray(feats)))
    # a second utterance with the frames shuffled, a third reversed
    out[1] = out[1][rng.permutation(T)]
    out[2] = out[2][::-1]
    nfr = np.asarray([T, T - 17, T - 41], np.int32)
    old = jp1.FUSE_PASS1
    jp1.FUSE_PASS1 = False
    try:
        ref = jp1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                              jnp.asarray(out), jnp.asarray(nfr))
    finally:
        jp1.FUSE_PASS1 = old
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return eng, out, nfr, ref


def test_pass1_batch_matches_reference(reference):
    eng, out, nfr, ref = reference
    dev = convert.device_network(convert.numpy_fields(eng.dev_net), "cpu")
    ng = convert.device_ngram(convert.numpy_fields(eng.ngram_dev), "cpu")
    assert dev.local_k == eng.dev_net.local_k
    cfg = tp1.Pass1Config(**{f.name: getattr(eng.p1_cfg, f.name)
                             for f in dataclasses.fields(tp1.Pass1Config)})
    got = tp1.pass1_batch(dev, ng, cfg, torch.from_numpy(out),
                          torch.from_numpy(nfr))
    assert got.word.shape == ref.word.shape == (3, out.shape[1],
                                                cfg.n_atoms)
    got = tp1.Trellis(*[a.numpy() for a in got])
    trellis_equal(ref, got)
    assert (got.word >= 0).sum() > 1000
    n_words = 0
    for b in range(3):
        rb = jp1.backtrace(jax.tree_util.tree_map(lambda a: a[b], ref),
                           int(nfr[b]), eng.net.tail_word)
        gb = tp1.backtrace(tp1.Trellis(*[a[b] for a in got]), int(nfr[b]),
                           eng.net.tail_word)
        assert (rb is None) == (gb is None)
        if rb is not None:
            assert gb["words"] == rb["words"]
            assert [s["begin"] for s in gb["segments"]] == \
                [s["begin"] for s in rb["segments"]]
            n_words += len(rb["words"])
    assert n_words > 3


@pytest.mark.parametrize("kw", [dict(factoring=2, expand_k=16),
                                dict(beam_width=150.0),
                                dict(crossword=False)],
                         ids=["factoring2", "envelope", "isolated"])
def test_unfused_configs_match_reference(reference, kw):
    """The configurations the kernel does not serve, on the same network:
    the port's unfused step against the reference's XLA step."""
    eng, out, nfr, _ = reference
    jcfg = dataclasses.replace(eng.p1_cfg, **kw)
    ref = jax.tree_util.tree_map(np.asarray, jp1.pass1_batch(
        eng.dev_net, eng.ngram_dev, jcfg, jnp.asarray(out),
        jnp.asarray(nfr)))
    dev = convert.device_network(convert.numpy_fields(eng.dev_net), "cpu")
    ng = convert.device_ngram(convert.numpy_fields(eng.ngram_dev), "cpu")
    cfg = tp1.Pass1Config(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(tp1.Pass1Config)})
    assert not tp1.fused_ok(dev, cfg)
    got = tp1.pass1_batch(dev, ng, cfg, torch.from_numpy(out),
                          torch.from_numpy(nfr))
    trellis_equal(ref, tp1.Trellis(*[a.numpy() for a in got]))
    assert (ref.word >= 0).sum() > 1000
