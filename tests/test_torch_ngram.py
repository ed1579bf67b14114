"""Port vs reference: the device N-gram hash and 2-gram lookups.

Both packages build their tables from the same NGramLM; the port's hash
runs in int64 masked to 32 bits and must be bit-equal to the reference's
uint32 hash, and every lookup must return exactly the same log10 value
(the same table entries are selected, no arithmetic differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from julius_tpu.search import ngram_device as jng
from julius_tpu.tools.synth import make_hmmset, make_ngram, make_vocabulary
from julius_tpu_torch import convert
from julius_tpu_torch.search import ngram_device as tng

import torch_fixtures  # noqa: F401  (one intra-op thread a worker)


def test_hash_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, size=20000, dtype=np.uint64)
    keys = np.concatenate([keys, [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]]
                          ).astype(np.uint32)
    assert (keys >= 2 ** 31).sum() > 1000
    ref = jng._hash_u32_np(keys)
    got = tng._hash_u32(torch.from_numpy(keys.astype(np.int64)))
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    # the device hash too (uint32 wrap-around in JAX)
    dev = np.asarray(jng._hash_u32(jnp.asarray(keys)))
    assert np.array_equal(got.numpy(), dev.astype(np.int64))


@pytest.fixture(scope="module")
def lm():
    hmm = make_hmmset(n_phones=24, dim=8)
    voca = make_vocabulary(hmm, n_words=300)
    return make_ngram(voca)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_bigram_scores_match_reference(lm, wide):
    jdev = jng.build_device_ngram(lm, force_wide=wide)
    own = tng.build_device_ngram(lm, "cpu", force_wide=wide)
    conv = convert.device_ngram(convert.numpy_fields(jdev), "cpu")
    assert own.wide == conv.wide == wide
    # the copied host build gives the reference's tables bit for bit
    assert torch.equal(own.bi_rows, conv.bi_rows)
    assert torch.equal(own.uni, conv.uni)
    assert torch.equal(own.bo_uni, conv.bo_uni)

    rng = np.random.default_rng(1)
    V = lm.n_words
    # contexts include -1 (no context); pairs include real bigrams
    pairs = np.asarray(list(lm.ngrams[1].keys())[:400], np.int32)
    v = np.concatenate([pairs[:, 0], rng.integers(-1, V, 600)]
                       ).astype(np.int32)
    w = np.concatenate([pairs[:, 1], rng.integers(0, V, 600)]
                       ).astype(np.int32)
    ref = np.asarray(jng.bigram_score(jdev, jnp.asarray(v), jnp.asarray(w)))
    got = tng.bigram_score(own, torch.from_numpy(v), torch.from_numpy(w))
    assert np.array_equal(got.numpy(), ref)
    # broadcast [K, 1] x [1, V] like the factoring-2 entry probe
    ref2 = np.asarray(jng.bigram_score(jdev, jnp.asarray(v[:8, None]),
                                       jnp.asarray(w[None, :50])))
    got2 = tng.bigram_score(own, torch.from_numpy(v[:8, None]),
                            torch.from_numpy(w[None, :50]))
    assert np.array_equal(got2.numpy(), ref2)

    uni = np.asarray(jdev.uni)
    bo = np.asarray(jdev.bo_uni)
    vq = np.maximum(v, 0)
    ref_f = np.asarray(jng.bigram_score_fast(
        jdev, jnp.asarray(v), jnp.asarray(bo[vq]), jnp.asarray(w),
        jnp.asarray(uni[w])))
    got_f = tng.bigram_score_fast(
        conv, torch.from_numpy(v), torch.from_numpy(bo[vq]),
        torch.from_numpy(w), torch.from_numpy(uni[w]))
    assert np.array_equal(got_f.numpy(), ref_f)
    assert np.array_equal(ref_f, ref)
