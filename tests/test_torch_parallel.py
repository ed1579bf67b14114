"""Port vs reference: `parallel/` (mesh.py, sharded_pass1.py).

The reference runs these on JAX's 8-device virtual CPU mesh
(tests/conftest.py); the port runs them in one process over a mesh of
torch devices that repeats the CPU.

* `partition_network` cuts the network into the same word-aligned
  shards, with the same tables, for S = 2, 4, 8;
* `sharded_pass1` gives the reference's sharded trellis (integers
  equal, scores within 1e-5) and the port's single-device unfused pass
  1's, and its backtrace decodes the utterance;
* `parallel_decode_fn` with dp = 2 gives the trellis of the engine's own
  unfused pass 1 on each half of the batch, and the reference's words;
* `shard_engine` with tp = 2 splits the DNN so its scores stay within
  the bf16 DNN rule's atol 2e-2 of the unsplit ones (here within 1e-5:
  the CPU multiplies in f32), with at most one collective per layer
  pair plus one."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import mesh_utils
from jax.sharding import Mesh as JMesh

from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict_line
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmmdefs
from julius_tpu.ops.dnn import dnn_scores as jdnn_scores
from julius_tpu.parallel import mesh as jmesh
from julius_tpu.parallel import sharded_pass1 as jsp
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.io.arpa import parse_arpa
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.ops.dnn import DNNScorer, dnn_scores
from julius_tpu_torch.parallel import mesh as tmesh
from julius_tpu_torch.parallel import sharded_pass1 as tsp
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.tools.synth import flagship_engine as tflagship

from fixtures import (make_arpa_text, make_dict_text, make_hmmdefs_text,
                      sample_states_and_frames)
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

TRUTH = ["<s>", "AB", "BA", "</s>"]
SMALL = dict(n_words=50, n_phones=32, hidden=128, n_layers=2)


def engines(parse_hmm, Voca, parse_line, parse_lm, Eng, Cfg, **kw):
    hmm = parse_hmm(make_hmmdefs_text(phones=("a", "b", "c", "sil"), dim=4,
                                      n_states=3, n_mix=2))
    voca = Voca()
    for line in make_dict_text().splitlines():
        parse_line(line, voca)
    lm = parse_lm(io.StringIO(make_arpa_text()))
    return Eng(hmm, voca, lm, search=Cfg(lm_weight=2.0, trellis_topm=8),
               **kw)


@pytest.fixture(scope="module")
def setup():
    jeng = engines(jparse_hmmdefs, JVocabulary, jparse_dict_line,
                   jparse_arpa, JEngine, JSearchConfig)
    teng = engines(parse_hmmdefs_text, Vocabulary, parse_dict_line,
                   parse_arpa, Engine, SearchConfig, device="cpu")
    name2id = {n: i for i, n in enumerate(jeng.voca.names)}
    pids = [jeng.hmm.phone_index[p] for w in TRUTH
            for p in jeng.voca.phones[name2id[w]]]
    frames, _ = sample_states_and_frames(jeng.hmm, pids,
                                         np.random.default_rng(0))
    out_ext = np.array(jax.jit(jeng._outprob)(jnp.asarray(frames[None]))[0])
    return jeng, teng, out_ext


def jax_mesh(n):
    return JMesh(mesh_utils.create_device_mesh(
        (n,), devices=jax.devices()[:n]), ("tp",))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_network_matches_reference(setup, n_shards):
    jeng, teng, _ = setup
    want = jsp.partition_network(jeng.net, jeng.dev_net, n_shards)
    got = tsp.partition_network(teng.net, teng.dev_net, n_shards)
    for f in dataclasses.fields(tsp.ShardedNetwork):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f.name)
        else:
            assert g == w, f.name
    assert got.score_idx.shape[0] == n_shards


def assert_same_trellis(got, want, valid_only=False):
    """Integer fields equal, scores and LM scores within 1e-5; with
    valid_only, only the atoms that hold a word are compared beyond
    `word` (the single-device step also masks their scores)."""
    gw, ww = got.word.numpy(), np.asarray(want.word)
    np.testing.assert_array_equal(gw, ww)
    keep = ww >= 0 if valid_only else np.ones(ww.shape, bool)
    for name in ("prev", "begin", "ectx"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[keep],
                                      np.asarray(getattr(want, name))[keep])
    for name in ("score", "lm"):
        np.testing.assert_allclose(getattr(got, name).numpy()[keep],
                                   np.asarray(getattr(want, name))[keep],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_pass1_matches_reference_and_single_device(setup, n_shards):
    jeng, teng, out_ext = setup
    T = out_ext.shape[0]
    want = jsp.sharded_pass1(
        jax_mesh(n_shards), jsp.partition_network(jeng.net, jeng.dev_net,
                                                  n_shards),
        jeng.ngram_dev, jeng.p1_cfg, jnp.asarray(out_ext), T)
    mesh = tmesh.make_mesh(devices=["cpu"] * n_shards, tp=n_shards)
    snet = tsp.partition_network(teng.net, teng.dev_net, n_shards)
    got = tsp.sharded_pass1(mesh, snet, teng.ngram_dev, teng.p1_cfg,
                            torch.from_numpy(out_ext), T)
    assert_same_trellis(got, want)
    single = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                             torch.from_numpy(out_ext[None]),
                             torch.tensor([T]), use_kernel=False)
    assert_same_trellis(got, tp1.Trellis(*[a[0] for a in single]),
                        valid_only=True)
    assert (got.word.numpy() >= 0).sum() > T


def test_sharded_backtrace_decodes(setup):
    _, teng, out_ext = setup
    T = out_ext.shape[0]
    mesh = tmesh.make_mesh(devices=["cpu"] * 4, tp=4)
    tr = tsp.sharded_pass1(mesh, tsp.partition_network(
        teng.net, teng.dev_net, 4), teng.ngram_dev, teng.p1_cfg,
        torch.from_numpy(out_ext), T)
    r = tp1.backtrace(tp1.Trellis(*[a.numpy() for a in tr]), T,
                      teng.net.tail_word)
    assert [teng.voca.names[w] for w in r["words"]] == TRUTH


def test_sharding_needs_the_local_fast_path_and_a_matching_row(setup):
    _, teng, out_ext = setup
    with pytest.raises(ValueError, match="local fast path"):
        tsp.partition_network(teng.net, dataclasses.replace(
            teng.dev_net, local_k=-1), 2)
    snet = tsp.partition_network(teng.net, teng.dev_net, 4)
    with pytest.raises(ValueError, match="4 shards on a mesh row of 2"):
        tsp.sharded_pass1(tmesh.make_mesh(devices=["cpu"] * 2, tp=2), snet,
                          teng.ngram_dev, teng.p1_cfg,
                          torch.from_numpy(out_ext), 5)


def test_make_mesh(monkeypatch):
    m = tmesh.make_mesh(devices=["cpu"] * 8, tp=2)
    assert (m.dp, m.tp) == (4, 2)
    assert m.devices[3][1] == torch.device("cpu")
    assert tmesh.make_mesh(6, tp=3, devices=["cpu"] * 8).dp == 2
    with pytest.raises(ValueError, match="not divisible by tp 4"):
        tmesh.make_mesh(6, tp=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="but 2 devices given"):
        tmesh.make_mesh(4, devices=["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh()


@pytest.fixture(scope="module")
def flagships():
    jeng = flagship_engine(**SMALL)
    teng = tflagship(device="cpu", **SMALL)
    rng = np.random.default_rng(1)
    wave = (rng.standard_normal((4, 8000)) * 1000).astype(np.float32)
    lengths = np.asarray([8000, 6400, 8000, 7200], np.int32)
    return jeng, teng, wave, lengths


def test_parallel_decode_fn_dp2_matches_the_engine(flagships):
    """dp = 2 (tp = 1): each half of the batch decoded on its row gives
    the engine's own front end, scorer and unfused pass 1 exactly, and
    the reference's parallel decode the same words (scores within 1e-3:
    each package runs its own DNN)."""
    jeng, teng, wave, lengths = flagships
    mesh = tmesh.make_mesh(devices=["cpu"] * 2, tp=1)
    trellis, nfr = tmesh.parallel_decode_fn(teng, mesh)(wave, lengths)
    assert len(teng.mesh_replicas) == 2
    with torch.no_grad():
        feats, mask = teng._features(torch.from_numpy(wave),
                                     torch.from_numpy(lengths))
        n = mask.to(torch.int32).sum(dim=-1)
        own = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                              teng._outprob(feats), n, use_kernel=False)
    np.testing.assert_array_equal(nfr.numpy(), n.numpy())
    for g, w in zip(trellis, own):
        assert torch.equal(g, w)
    fn = jmesh.parallel_decode_fn(jeng, jmesh.make_mesh(2, tp=1))
    jtr, jnfr = fn(wave, lengths)
    np.testing.assert_array_equal(nfr.numpy(), np.asarray(jnfr))
    np.testing.assert_array_equal(trellis.word.numpy(), np.asarray(jtr.word))
    ok = trellis.word.numpy() >= 0
    np.testing.assert_allclose(trellis.score.numpy()[ok],
                               np.asarray(jtr.score)[ok], atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="not divisible by dp 2"):
        tmesh.parallel_decode_fn(teng, mesh)(wave[:3], lengths[:3])


@pytest.mark.parametrize("n_layers", [2, 3])
def test_shard_engine_tp2_splits_the_dnn(flagships, n_layers):
    jeng, teng, _, _ = flagships
    rng = np.random.default_rng(n_layers)
    din, hid, n_out = 120 * 11, 128, 40
    dims = [din] + [hid] * n_layers
    scorer = DNNScorer(
        [rng.standard_normal((a, b)).astype(np.float32) * 0.05
         for a, b in zip(dims[:-1], dims[1:])],
        [rng.standard_normal(hid).astype(np.float32) * 0.1
         for _ in range(n_layers)],
        rng.standard_normal((hid, n_out)).astype(np.float32) * 0.2,
        rng.standard_normal(n_out).astype(np.float32),
        np.full(n_out, -1.6, np.float32), "cpu")
    x = torch.from_numpy(rng.standard_normal((3, 7, din)).astype(np.float32))
    tpd = tmesh.TensorParallelDNN(scorer, [torch.device("cpu")] * 2)
    got = tpd(x)
    assert tpd.collectives <= (n_layers + 1 + 1) // 2 + 1
    np.testing.assert_allclose(got.numpy(), dnn_scores(scorer, x).numpy(),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.numpy(), dnn_scores(scorer, x).numpy(),
                               atol=1e-5, rtol=0)
    if n_layers == 2:
        # the engine path: shard_engine on a 1 x 2 mesh, against the
        # reference's tp = 2 sharding of the same flagship DNN
        mesh = tmesh.make_mesh(devices=["cpu"] * 2, tp=2)
        tmesh.shard_engine(teng, mesh)
        rep = teng.mesh_replicas[0]
        assert isinstance(rep.dnn_scorer, tmesh.TensorParallelDNN)
        assert rep.dev_net is not teng.dev_net and rep.lm is teng.lm
        xe = rng.standard_normal((2, 5, 120 * 11)).astype(np.float32)
        split = rep._outprob(torch.from_numpy(xe)).numpy()
        whole = teng._outprob(torch.from_numpy(xe)).numpy()
        np.testing.assert_allclose(split, whole, atol=2e-2, rtol=0)
        jm = jmesh.make_mesh(2, tp=2)
        jmesh.shard_engine(jeng, jm)
        with jm:
            ref = np.asarray(jdnn_scores(jeng.dnn_scorer, jnp.asarray(xe)))
        np.testing.assert_allclose(
            split, ref[..., np.asarray(jeng.hmm.state_sid)], atol=2e-2,
            rtol=0)


@pytest.fixture(scope="module")
def past_2m():
    """The flagship at 120 words (M = 32, so more than 2M words can end
    in a frame), one generative utterance's outprob rows from the
    reference engine."""
    from julius_tpu.tools.synth import make_flagship_utts
    size = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)
    jeng, protos = flagship_engine(trained=True, **size)
    teng, _ = tflagship(trained=True, device="cpu", **size)
    truths, wins, _ = make_flagship_utts(jeng.hmm, jeng.voca, jeng.lm,
                                         protos, 1, 120, 11, min_words=6,
                                         max_words=10, seed=1)
    out = np.array(jeng._outprob(jnp.asarray(wins[0][None]))[0])
    return jeng, teng, out, truths[0]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_pass1_past_2m_exits(past_2m, n_shards):
    """Where more than 2M words end in a frame, the sharded step
    (every exit corrected before the cut) and the single-device step
    (only the best 2M by raw score) keep different atoms in some frames,
    in both packages.  The port's sharded trellis equals the
    reference's, every shard count gives the one-shard trellis, and the
    sharded and single-device trellises both decode the utterance."""
    jeng, teng, out, truth = past_2m
    T = out.shape[0]
    assert teng.dev_net.exit_nodes.shape[0] > 2 * teng.p1_cfg.n_atoms
    want = jsp.sharded_pass1(
        jax_mesh(n_shards), jsp.partition_network(jeng.net, jeng.dev_net,
                                                  n_shards),
        jeng.ngram_dev, jeng.p1_cfg, jnp.asarray(out), T)
    got = {}
    for s in (1, n_shards):
        got[s] = tsp.sharded_pass1(
            tmesh.make_mesh(devices=["cpu"] * s, tp=s),
            tsp.partition_network(teng.net, teng.dev_net, s),
            teng.ngram_dev, teng.p1_cfg, torch.from_numpy(out), T)
    assert_same_trellis(got[n_shards], want)
    for a, b in zip(got[n_shards], got[1]):
        assert torch.equal(a, b)
    single = tp1.pass1_batch(teng.dev_net, teng.ngram_dev, teng.p1_cfg,
                             torch.from_numpy(out[None]), torch.tensor([T]),
                             use_kernel=False)
    single = tp1.Trellis(*[a[0].numpy() for a in single])
    for tr in (tp1.Trellis(*[a.numpy() for a in got[1]]), single):
        r = tp1.backtrace(tr, T, teng.net.tail_word)
        assert [teng.voca.names[w] for w in r["words"]] == truth
